from spcies_tpu_torch.utils import linalg
from spcies_tpu_torch.utils import projections

__all__ = ["linalg", "projections"]
