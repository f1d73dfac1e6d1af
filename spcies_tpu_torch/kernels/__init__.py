from spcies_tpu_torch.kernels.fused_admm import (fused_admm_solve,
                                                 fused_admm_reference)

__all__ = ["fused_admm_solve", "fused_admm_reference"]
