"""torch_t01 — time-varying MPC on the PyTorch/CUDA port (analogue of
examples/t01_time_varying_MPC.m, and of t01_time_varying.py for the JAX
package): per-call model data with online band-Cholesky refactorization,
warm starts across a receding horizon with a drifting model.

    python examples/torch_t01_time_varying.py [--device cuda|cpu]"""

import argparse

import numpy as np
import spcies_tpu_torch as sp


def main(device="cuda"):
    sys, param, st = sp.systems.tester_fixture()
    param = dict(param)
    param["T"] = np.diag(np.sum(param["T"], axis=1))

    opt = sp.default_options("laxMPC", "ADMM", rho=15.0, tol=1e-5,
                             k_max=2000)
    opt.time_varying = True
    solver = sp.make_solver(sys, param, formulation="laxMPC",
                            method="ADMM", options=opt, device=device)

    A0, B0 = np.asarray(sys["A"]), np.asarray(sys["B"])
    Qd, Rd = np.diag(param["Q"]), np.diag(param["R"])
    LB = np.concatenate([sys["LBx"], sys["LBu"]])
    UB = np.concatenate([sys["UBx"], sys["UBu"]])

    x = np.asarray(st["x"], float)
    init = None
    for t in range(10):
        A_t = A0 * (1.0 - 0.005 * t)      # slowly drifting model
        res = solver(x, st["xr"], st["ur"], A_t, B0, Qd, Rd, LB, UB,
                     init=init)
        u = res.u[0].cpu().numpy()
        x = A_t @ x + B0 @ u
        init = (res.sol["z"], res.sol["v"], res.sol["lam"])
        print(f"t={t}: k={int(res.k[0])} e={int(res.e_flag[0])} "
              f"|x|={np.linalg.norm(x):.4f}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
