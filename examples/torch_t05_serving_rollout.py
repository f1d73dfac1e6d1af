"""torch_t05 — the serving pattern on the PyTorch/CUDA port (the JAX
package's t05_serving_rollout.py): on-device closed-loop rollout with the
shifted warm start.

The reference's closed-loop demos step host <-> solver once per control
period (examples/cl_in_C/main_cl_in_C.c:60-115). Here the receding-horizon
loop — solve, apply u0, propagate, warm-start the next solve — runs on the
solver's device with its state there, one solve (one kernel launch on a
fused solver) a step, batched over independent loops
(spcies_tpu_torch.runtime.closed_loop_rollout).

warm_start="shift" advances the previous (z, v, lam) one stage and
duplicates the tail before seeding the next solve (the apparatus the
reference computed but never used, compute_MPCT_EADMM_ingredients.m:
157-193); carrying the unshifted solution can be worse than a cold start
(docs_torch/solve.md).

    python examples/torch_t05_serving_rollout.py [--device cuda|cpu]
"""

import argparse

import numpy as np
import spcies_tpu_torch as sp
from spcies_tpu_torch.runtime import closed_loop_rollout


def main(device="cuda"):
    sys, param, st = sp.systems.tester_fixture()
    p30 = dict(param)
    p30["N"] = 30

    opts = sp.default_options("laxMPC", "ADMM", rho=10.0, tol=1e-4,
                              k_max=1000, relax_alpha=1.9)
    opts.precision = "float"          # the fp32 production path
    solver = sp.make_solver(sys, p30, formulation="laxMPC", method="ADMM",
                            options=opts, device=device)

    A, B = np.asarray(sys["A"]), np.asarray(sys["B"])
    Bz = 256                          # 256 independent closed loops
    rng = np.random.default_rng(0)
    x0 = np.asarray(st["x"])[None, :] * rng.uniform(-2.0, 2.0, (Bz, 1))

    for mode, ws in (("cold", False), ("shifted", "shift")):
        out = closed_loop_rollout(solver, A, B, x0, st["xr"], st["ur"],
                                  n_steps=40, warm_start=ws)
        ks = out["ks"].cpu().numpy()
        conv = float(np.mean(out["e_flags"].cpu().numpy() == 1))
        errT = float(np.max(np.abs(out["xs"][-1].cpu().numpy()
                                   - np.asarray(st["xr"]))))
        print(f"{mode:8s} k/step after step 0: {ks[1:].mean():6.1f}   "
              f"converged: {conv:.4f}   |x_T - xr|_inf: {errT:.2e}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
