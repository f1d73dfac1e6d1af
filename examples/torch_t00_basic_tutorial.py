"""torch_t00 — basic workflow on the PyTorch/CUDA port (analogue of
examples/t00_basic_tutorial.m, and of t00_basic_tutorial.py for the JAX
package): build the oscillating-masses plant, make a laxMPC-ADMM solver,
run a closed-loop simulation, then a batched fleet solve.

    python examples/torch_t00_basic_tutorial.py [--device cuda|cpu]

The solver runs on the card unless --device cpu is given; without a card
make_solver raises."""

import argparse

import numpy as np
import spcies_tpu_torch as sp


def main(device="cuda"):
    # the canonical 3-mass chain (tests/spcies_tester.m fixture)
    sys, param, st = sp.systems.tester_fixture()

    solver = sp.make_solver(sys, param, formulation="laxMPC",
                            method="ADMM", rho=15.0, tol=1e-5, k_max=2000,
                            device=device)

    # --- closed loop from a perturbed state ---
    A, B = np.asarray(sys["A"]), np.asarray(sys["B"])
    x = np.asarray(st["x"]) * 3.0
    traj = [x]
    for t in range(25):
        res = solver(x, st["xr"], st["ur"])
        u = res.u[0].cpu().numpy()
        x = A @ x + B @ u
        traj.append(x)
    print("closed loop: |x_25 - xr| =",
          round(float(np.linalg.norm(x - st["xr"])), 6))

    # --- batched fleet solve (the card's batch axis) ---
    Bsz = 512
    rng = np.random.default_rng(0)
    X0 = st["x"][None, :] * rng.uniform(-2, 2, (Bsz, 1))
    res = solver(X0, np.tile(st["xr"], (Bsz, 1)),
                 np.tile(st["ur"], (Bsz, 1)))
    print("fleet:", sp.parallel.fleet_metrics(res))


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
