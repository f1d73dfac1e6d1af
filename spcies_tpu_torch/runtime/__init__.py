"""Runtime services over the solvers: the batched closed-loop rollout."""

from spcies_tpu_torch.runtime.rollout import (closed_loop_rollout,
                                              shift_dual_stages,
                                              shift_stagewise)

__all__ = ["closed_loop_rollout", "shift_stagewise", "shift_dual_stages"]
