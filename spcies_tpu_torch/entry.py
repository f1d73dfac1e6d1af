"""Entry points of the port beside make_solver.

entry() returns (fn, args): the flagship's batched solve step
(laxMPC-ADMM on the oscillating masses, N=10, B=256, 10 fixed iterations)
and its inputs on the card, the port of the JAX package's
`__graft_entry__.entry`.

dryrun_multichip(n) runs the scale-out paths of the JAX package's
`__graft_entry__.dryrun_multichip` over an n-entry mesh: a fixed-iteration
sharded solve with its metrics reduced, a per-shard solve of the dense
flagship with the metrics reduced over processes, and the fused flagship
(K1 on a card, its plain version on the CPU) through the same per-shard
path.
"""

from __future__ import annotations

import numpy as np
import torch

from spcies_tpu_torch import parallel
from spcies_tpu_torch.api import make_solver
from spcies_tpu_torch.config import default_options
from spcies_tpu_torch.systems import tester_fixture


def _flagship_batch(st, batch: int, seed: int):
    """The flagship's inputs, fp64 numpy: the fixture's state scaled per
    lane by a uniform factor in [-2, 2] drawn from `seed`."""
    rng = np.random.default_rng(seed)
    x0 = np.asarray(st["x"])[None, :] * rng.uniform(-2, 2, (batch, 1))
    return (x0, np.tile(st["xr"], (batch, 1)),
            np.tile(st["ur"], (batch, 1)))


def _flagship(batch: int, dtype_str: str = "float32", N: int = 10,
              device="cuda"):
    """The flagship solver (laxMPC-ADMM, rho 15, tol 1e-4, k_max 1000, the
    dense backend, `dtype_str` precision, on `device`) and its inputs from
    seed 0, placed on the solver's device in its dtype."""
    sys_, param, st = tester_fixture()
    opts = default_options("laxMPC", "ADMM", rho=15.0, tol=1e-4,
                           k_max=1000)
    opts.precision = "double" if dtype_str == "float64" else "float"
    solver = make_solver(sys_, dict(param, N=N), formulation="laxMPC",
                         method="ADMM", options=opts, device=device)
    args = tuple(torch.as_tensor(a, dtype=solver.dtype, device=solver.device)
                 for a in _flagship_batch(st, batch, 0))
    return solver, args


def entry(device="cuda"):
    """The flagship's batched solve step, one device: (fn, args) with
    fn(x0, xr, ur) the solver's raw solve at 10 fixed iterations and args
    256 lanes on `device` (the card by default; RuntimeError without
    one)."""
    solver, args = _flagship(batch=256, device=device)

    def fn(x0, xr, ur):
        return solver.raw_fn(x0, xr, ur, None, 10)

    return fn, args


def dryrun_multichip(n_devices: int, devices=None) -> dict:
    """Run the flagship (laxMPC-ADMM on the oscillating masses, fp32) over
    an n-entry mesh and return each path's metrics.

    devices: the mesh's entries, by default the first n cards (raises
    ValueError where fewer are visible; no fallback to the CPU); a device
    may repeat, e.g. ["cpu"] * 4 or ["cuda:0"] * 2.

    1. sharded_solver of the dense flagship (N=10, B=2n) with
       fixed_iters=3, its fleet metrics reduced;
    2. shard_map_solver of the same solver over the (host, chip) mesh,
       with global_fleet_metrics: every lane converges;
    3. the fused flagship (N=30, tile_b 8, B=8n) through shard_map_solver:
       every lane converges.
    """
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count < n_devices:
            raise ValueError(
                f"dryrun_multichip({n_devices}) takes the first "
                f"{n_devices} cards and {count} are visible; pass "
                f"devices=[...] (e.g. [\"cuda:0\"] * {n_devices} or "
                f"[\"cpu\"] * {n_devices})")
        devices = [f"cuda:{i}" for i in range(n_devices)]
    devices = list(devices)
    if len(devices) != n_devices:
        raise ValueError(f"dryrun_multichip({n_devices}) got "
                         f"{len(devices)} devices")
    mesh = parallel.batch_mesh(devices)
    sys_, param, st = tester_fixture()

    def flagship(N, backend, **kw):
        o = default_options("laxMPC", "ADMM", rho=15.0, tol=1e-4,
                            k_max=1000, **kw)
        o.precision = "float"
        return make_solver(sys_, dict(param, N=N), formulation="laxMPC",
                           method="ADMM", options=o, backend=backend,
                           device=devices[0])

    # path 1: fixed iterations over the 1-D batch mesh
    dense = flagship(10, "dense")
    B = 2 * n_devices
    res = parallel.sharded_solver(dense, mesh)(*_flagship_batch(st, B, 0),
                                               fixed_iters=3)
    fixed = parallel.fleet_metrics(res)
    if tuple(res.u.shape) != (B, dense.m) or fixed["k_mean"] != 3:
        raise RuntimeError(f"fixed-iteration sharded solve: u "
                           f"{tuple(res.u.shape)}, {fixed}")

    # path 2: per-shard solves over the (host, chip) mesh
    hc_mesh = parallel.host_chip_mesh(devices=devices)
    solve = parallel.shard_map_solver(dense, hc_mesh)
    fleet = parallel.global_fleet_metrics(
        solve(*_flagship_batch(st, B, 0)), hc_mesh)
    if fleet["n_converged"] != fleet["n_lanes"] or fleet["n_lanes"] != B:
        raise RuntimeError(f"dense shard_map solve: {fleet}")

    # path 3: the fused flagship on the same per-shard path
    fused = flagship(param["N"], "fused", tile_b=8)
    Bf = 8 * n_devices
    fleet_fused = parallel.global_fleet_metrics(
        parallel.shard_map_solver(fused, hc_mesh)(
            *_flagship_batch(st, Bf, 1)), hc_mesh)
    if (fleet_fused["n_converged"] != fleet_fused["n_lanes"]
            or fleet_fused["n_lanes"] != Bf):
        raise RuntimeError(f"fused shard_map solve: {fleet_fused}")

    print(f"dryrun_multichip({n_devices}): ok - u {tuple(res.u.shape)}, "
          f"k_sum={fixed['k_mean'] * B:.0f}; shard_map solve converged "
          f"{fleet['n_converged']}/{fleet['n_lanes']} "
          f"(k_mean={fleet['k_mean']:.1f}) on mesh "
          f"{tuple(hc_mesh.devices.shape)}; fused shard_map converged "
          f"{fleet_fused['n_converged']}/{Bf}", flush=True)
    return dict(fixed=fixed, dense=fleet, fused=fleet_fused)
