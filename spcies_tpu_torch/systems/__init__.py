from spcies_tpu_torch.systems.oscillating_masses import (
    gen_oscillating_masses,
    example_oscmass,
    tester_fixture,
)
from spcies_tpu_torch.systems.duffing import duffing_ode, duffing_to_ss
from spcies_tpu_torch.systems.scale_ss import scale_ss

__all__ = [
    "gen_oscillating_masses",
    "example_oscmass",
    "tester_fixture",
    "duffing_ode",
    "duffing_to_ss",
    "scale_ss",
]
