from spcies_tpu_torch.formulations.base import (BUILDERS, register_builder,
                                                get_builder)

# Import formulation modules for their registration side effects.
from spcies_tpu_torch.formulations import laxmpc  # noqa: F401
from spcies_tpu_torch.formulations import equmpc  # noqa: F401
from spcies_tpu_torch.formulations import mpct  # noqa: F401
from spcies_tpu_torch.formulations import ellipmpc  # noqa: F401
from spcies_tpu_torch.formulations import hmpc  # noqa: F401

__all__ = ["BUILDERS", "register_builder", "get_builder"]
