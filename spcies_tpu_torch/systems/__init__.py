from spcies_tpu_torch.systems.oscillating_masses import (
    gen_oscillating_masses,
    example_oscmass,
    tester_fixture,
)

__all__ = [
    "gen_oscillating_masses",
    "example_oscmass",
    "tester_fixture",
]
