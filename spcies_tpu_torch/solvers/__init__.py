from spcies_tpu_torch.solvers.common import SolveResult, inf_norm
from spcies_tpu_torch.solvers.loop import run_masked_loop
from spcies_tpu_torch.solvers.admm import admm_solve

__all__ = ["SolveResult", "inf_norm", "run_masked_loop", "admm_solve"]
