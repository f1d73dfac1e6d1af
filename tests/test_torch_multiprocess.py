"""The port's multi-process runtime: N OS processes, each driving D
logical CPU shards, brought up by spcies_tpu_torch.parallel.initialize
over gloo, solving one global batch through shard_map_solver on an (N, D)
(host, chip) mesh. The port of tests/test_multiprocess.py, parametrised
over (2 processes x 2 shards) and (4 x 1), so that the host axis is not
always the shorter one.

Each worker feeds its own lanes (from_process_local), checks that every
process sees the same global metrics, that its lanes equal a local solve
of them, that a warm start across processes exits at once and that no
collective is called inside a solve, and writes its k and u; the test
holds those against the JAX package's single-process fp64 solve of the
global batch. Also dryrun_multichip over four CPU entries."""

import json
import os
import socket
import subprocess
import sys as _sys

import numpy as np
import pytest
import torch

import spcies_tpu as jsp

import spcies_tpu_torch as tsp
from spcies_tpu_torch.entry import dryrun_multichip

torch.set_num_threads(2)

B_LOCAL = 4

_WORKER = r"""
import json, os, sys
pid, nproc, port, ndev, out = (int(sys.argv[1]), int(sys.argv[2]),
                               sys.argv[3], int(sys.argv[4]), sys.argv[5])
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
import spcies_tpu_torch as sp

assert "jax" not in sys.modules
assert sp.parallel.initialize(coordinator_address=f"localhost:{port}",
                              num_processes=nproc, process_id=pid,
                              local_device_ids=["cpu"] * ndev)
assert sp.parallel.is_distributed() and dist.get_backend() == "gloo"
assert dist.get_world_size() == nproc and dist.get_rank() == pid

mesh = sp.parallel.host_chip_mesh()
assert mesh.devices.shape == (nproc, ndev), mesh.devices.shape
assert [i for i, _ in mesh.local_entries] == list(range(pid * ndev,
                                                        (pid + 1) * ndev))

sys_, param, st = sp.systems.tester_fixture()
solver = sp.make_solver(sys_, param, formulation="laxMPC", method="ADMM",
                        rho=15.0, tol=1e-6, k_max=3000, device="cpu")

# each process feeds its own scenarios, with amplitudes that differ by
# process, so that k differs across processes
B_local = %(B_LOCAL)d
rng = np.random.default_rng(100 + pid)
x0_l = np.asarray(st["x"])[None, :] * rng.uniform(
    -2 - 0.4 * pid, 2 + 0.4 * pid, (B_local, 1))
xr_l = np.tile(st["xr"], (B_local, 1))
ur_l = np.tile(st["ur"], (B_local, 1))
x0, xr, ur = (sp.parallel.from_process_local(mesh, a)
              for a in (x0_l, xr_l, ur_l))
assert (x0.offset, x0.global_batch) == (pid * B_local, B_local * nproc)

# every collective of torch.distributed, counted
calls = {}
c10d = dist.distributed_c10d
for name in ("all_reduce", "all_gather", "all_gather_object",
             "all_gather_into_tensor", "broadcast", "broadcast_object_list",
             "reduce", "reduce_scatter", "reduce_scatter_tensor",
             "all_to_all", "all_to_all_single", "barrier", "gather",
             "scatter", "send", "recv", "isend", "irecv"):
    orig = getattr(c10d, name)
    def counted(*a, _name=name, _orig=orig, **kw):
        calls[_name] = calls.get(_name, 0) + 1
        return _orig(*a, **kw)
    setattr(dist, name, counted)
    setattr(c10d, name, counted)

solve = sp.parallel.shard_map_solver(solver, mesh)
res = solve(x0, xr, ur)
assert calls == {}, calls
m = sp.parallel.global_fleet_metrics(res, mesh)
assert calls == {"all_reduce": 2}, calls
assert m["n_hosts"] == nproc and m["n_devices"] == ndev * nproc, m
assert m["n_converged"] == m["n_lanes"] == B_local * nproc, m
assert m["k_min"] < m["k_max"], m
print("METRICS " + json.dumps(m, sort_keys=True), flush=True)

# this process's lanes against local solves of them: each shard's lanes
# bit for bit, the whole local batch with the same k (its products round
# by the batch's shape)
per = B_local // ndev
for j in range(ndev):
    sl = slice(j * per, (j + 1) * per)
    part = solver(x0_l[sl], xr_l[sl], ur_l[sl])
    assert torch.equal(res.k[sl], part.k) and torch.equal(res.u[sl], part.u)
    assert torch.equal(res.sol["z"][sl], part.sol["z"])
res_local = solver(x0_l, xr_l, ur_l)
assert torch.equal(res.k, res_local.k)
assert float((res.u - res_local.u).abs().max()) <= 1e-12

# a warm start across processes from this process's converged iterates:
# every lane exits at once
calls.clear()
res_ws = solve(x0, xr, ur, init=(res.sol["z"], res.sol["v"],
                                 res.sol["lam"]))
assert calls == {}, calls
m_ws = sp.parallel.global_fleet_metrics(res_ws, mesh)
assert m_ws["n_converged"] == m_ws["n_lanes"], m_ws
assert m_ws["k_max"] <= 2, m_ws

np.save(os.path.join(out, f"k{pid}.npy"), res.k.numpy())
np.save(os.path.join(out, f"u{pid}.npy"), res.u.numpy())
dist.destroy_process_group()
print(f"OK {pid}", flush=True)
""" % dict(B_LOCAL=B_LOCAL)


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _global_inputs(nproc):
    """The workers' lanes, process by process: the global batch."""
    _, _, st = tsp.systems.tester_fixture()
    x0 = []
    for pid in range(nproc):
        rng = np.random.default_rng(100 + pid)
        x0.append(np.asarray(st["x"])[None, :] * rng.uniform(
            -2 - 0.4 * pid, 2 + 0.4 * pid, (B_LOCAL, 1)))
    B = B_LOCAL * nproc
    return (np.concatenate(x0), np.tile(st["xr"], (B, 1)),
            np.tile(st["ur"], (B, 1)))


@pytest.mark.parametrize("nproc,ndev", [(2, 2), (4, 1)])
def test_multi_process_distributed_solve(tmp_path, nproc, ndev):
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    port = _free_port()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                        "LOCAL_RANK")}
    env.update(PYTHONPATH=root, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [_sys.executable, str(worker), str(pid), str(nproc), str(port),
         str(ndev), str(tmp_path)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for pid in range(nproc)]
    outs = []
    try:
        for p in procs:
            try:
                out, err = p.communicate(timeout=240)
            except subprocess.TimeoutExpired:
                p.kill()
                out, err = p.communicate()
                pytest.fail(f"worker timed out; out={out}\nerr={err}")
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rc, out, err in outs:
        assert rc == 0, f"worker failed: {out}\n{err}"
        assert "OK" in out
    # every process reports the same global metrics
    metrics = [json.loads(line.split(" ", 1)[1]) for _, out, _ in outs
               for line in out.splitlines() if line.startswith("METRICS")]
    assert len(metrics) == nproc
    assert all(m == metrics[0] for m in metrics[1:]), metrics

    # the JAX package's single-process fp64 solve of the global batch
    sys_, param, _ = tsp.systems.tester_fixture()
    ref = jsp.make_solver(sys_, param, formulation="laxMPC", method="ADMM",
                          rho=15.0, tol=1e-6, k_max=3000)(
                              *_global_inputs(nproc))
    k = np.concatenate([np.load(tmp_path / f"k{pid}.npy")
                        for pid in range(nproc)])
    u = np.concatenate([np.load(tmp_path / f"u{pid}.npy")
                        for pid in range(nproc)])
    np.testing.assert_array_equal(k, np.asarray(ref.k))
    np.testing.assert_allclose(u, np.asarray(ref.u), rtol=0, atol=1e-9)
    assert metrics[0]["k_max"] == int(np.max(ref.k))
    assert metrics[0]["k_mean"] == pytest.approx(float(np.mean(ref.k)))


def test_dryrun_multichip_cpu():
    """dryrun_multichip's three paths over four CPU entries: fixed
    iterations, the dense flagship and the fused one (K1's plain
    version), every lane converged; with the cards left to the default
    and none visible it raises, naming devices=."""
    out = dryrun_multichip(4, devices=["cpu"] * 4)
    assert out["fixed"]["n_lanes"] == 8 and out["fixed"]["k_max"] == 3
    assert out["dense"]["n_converged"] == out["dense"]["n_lanes"] == 8
    assert out["dense"]["n_devices"] == 4 and out["dense"]["n_hosts"] == 1
    assert out["fused"]["n_converged"] == out["fused"]["n_lanes"] == 32
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="devices="):
            dryrun_multichip(2)
    with pytest.raises(ValueError, match="got 3 devices"):
        dryrun_multichip(2, devices=["cpu"] * 3)
