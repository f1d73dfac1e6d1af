"""torch_t04 — development workflow on the PyTorch/CUDA port (analogue of
examples/t04_dev_solver_versions.m, and of t04_dev_solver_versions.py for
the JAX package): compare a batched solver against its dense numpy oracle
mirror (spcies_tpu_torch.oracle), the differential pattern every in-repo
formulation follows.

    python examples/torch_t04_dev_solver_versions.py [--device cuda|cpu]"""

import argparse

import numpy as np
import spcies_tpu_torch as sp
from spcies_tpu_torch.oracle import laxmpc_admm_oracle


def main(device="cuda"):
    sys, param, st = sp.systems.tester_fixture()
    param = dict(param)
    param["T"] = np.diag(np.sum(param["T"], axis=1))
    opts = dict(rho=15.0, tol=1e-7, k_max=5000)

    solver = sp.make_solver(sys, param, formulation="laxMPC",
                            method="ADMM", device=device, **opts)
    res = solver(st["x"], st["xr"], st["ur"])
    u_o, k_o, e_o, sol_o = laxmpc_admm_oracle(
        sys, param, st["x"], st["xr"], st["ur"], **opts)

    print("iterations: solver", int(res.k[0]), " oracle", k_o)
    for key in ("z", "v", "lam"):
        gap = float(np.max(np.abs(res.sol[key][0].cpu().numpy()
                                  - sol_o[key])))
        print(f"gap[{key}] = {gap:.2e}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
