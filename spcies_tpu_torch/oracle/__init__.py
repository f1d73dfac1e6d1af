from spcies_tpu_torch.oracle.dense import (
    solve_eq_qp,
    solve_box_qp,
    laxmpc_admm_oracle,
    equmpc_admm_oracle,
    laxmpc_fista_oracle,
    equmpc_fista_oracle,
    ellipmpc_admm_oracle,
    ellipmpc_admm_soc_oracle,
    mpct_eadmm_oracle,
    mpct_admm_cs_oracle,
    mpct_admm_semiband_oracle,
    hmpc_admm_oracle,
    hmpc_split_oracle,
    elliphmpc_admm_oracle,
)

__all__ = [
    "solve_eq_qp", "solve_box_qp",
    "laxmpc_admm_oracle", "equmpc_admm_oracle",
    "laxmpc_fista_oracle", "equmpc_fista_oracle",
    "ellipmpc_admm_oracle", "ellipmpc_admm_soc_oracle",
    "mpct_eadmm_oracle", "mpct_admm_cs_oracle",
    "mpct_admm_semiband_oracle",
    "hmpc_admm_oracle", "hmpc_split_oracle",
    "elliphmpc_admm_oracle",
]
