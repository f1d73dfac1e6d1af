"""The port's scale-out (spcies_tpu_torch.parallel) on meshes of repeated
CPU devices, held against the JAX package's parallel/ on its 8 virtual
CPU devices: ports of tests/test_shard_map_solver.py and
tests/test_baseline_configs.py::test_hmpc_sadmm_sharded_batch, every
triple's signature and warm start sharded bit for bit against per-shard
solves, the replica hook, and the collective counter that stands in for
the JAX tests' "no collective in the compiled loop" assertions."""

import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist
from threadpoolctl import threadpool_limits

import jax
import spcies_tpu as jsp

import spcies_tpu_torch as tsp
from spcies_tpu_torch.api import _rebuild, _replica
from spcies_tpu_torch.config import SOLVER_REGISTRY
from tests.test_codegen_c_ext import _float_setup
from tests.test_option_registry import _inputs_for

torch.set_num_threads(2)

CPU8 = ["cpu"] * 8
# every collective of torch.distributed a solve could call
COLLECTIVES = ("all_reduce", "all_gather", "all_gather_object",
               "all_gather_into_tensor", "broadcast", "broadcast_object_list",
               "reduce", "reduce_scatter", "reduce_scatter_tensor",
               "all_to_all", "all_to_all_single", "barrier",
               "monitored_barrier", "gather", "gather_object", "scatter",
               "scatter_object_list", "send", "recv", "isend", "irecv")


@pytest.fixture(scope="module", autouse=True)
def _one_blas_thread():
    """One BLAS thread while this module runs (numpy's OpenBLAS threads
    spin-wait for each other under the suite's parallel workers)."""
    with threadpool_limits(limits=1, user_api="blas"):
        yield


def _batch(st, B, seed, lo=-2.0, hi=2.0):
    rng = np.random.default_rng(seed)
    x0 = np.asarray(st["x"])[None, :] * rng.uniform(lo, hi, (B, 1))
    return x0, np.tile(st["xr"], (B, 1)), np.tile(st["ur"], (B, 1))


@pytest.fixture(scope="module")
def solvers_and_data():
    """The JAX test's dense fp64 laxMPC-ADMM solver in both packages, and
    its 32 lanes."""
    sys_, param, st = tsp.systems.tester_fixture()
    kw = dict(formulation="laxMPC", method="ADMM", rho=15.0, tol=1e-6,
              k_max=3000)
    return (tsp.make_solver(sys_, param, device="cpu", **kw),
            jsp.make_solver(sys_, param, **kw), _batch(st, 32, 5))


def _fused(**kw):
    """The JAX test's fused fp32 laxMPC-ADMM solver (tile_b 8, tol 1e-5),
    on the plain version of K1 here."""
    sys_, param, st = tsp.systems.tester_fixture()
    o = tsp.default_options("laxMPC", "ADMM", tile_b=8, rho=15.0, tol=1e-5,
                            k_max=3000, **kw)
    o.precision = "float"
    return tsp.make_solver(sys_, param, formulation="laxMPC", method="ADMM",
                           backend="fused", options=o, device="cpu")


def _assert_same(a, b, keys=None):
    """Two SolveResults bit for bit: u, k, e_flag and the sol entries."""
    for name in ("u", "k", "e_flag"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    for key in keys or [k for k in b.sol if torch.is_tensor(b.sol[k])]:
        assert torch.equal(a.sol[key], b.sol[key]), key


def _assert_per_shard(res, solver, inputs, n_shards, init=None):
    """res equals a separate solve of each shard's lanes, bit for bit."""
    B = res.k.shape[0]
    per = B // n_shards
    for s in range(n_shards):
        sl = slice(s * per, (s + 1) * per)
        part = solver(*(a[sl] for a in inputs),
                      init=None if init is None else tuple(a[sl]
                                                           for a in init))
        _assert_same(type(res)(u=res.u[sl], k=res.k[sl],
                               e_flag=res.e_flag[sl],
                               sol={k: v[sl] for k, v in res.sol.items()
                                    if torch.is_tensor(v)}), part)


def test_host_chip_mesh_shape():
    mesh = tsp.parallel.host_chip_mesh(devices=CPU8)
    assert mesh.axis_names == ("host", "chip")
    # single process: host axis 1, chip axis the given devices; the JAX
    # package's over its 8 virtual CPU devices has the same shape
    assert mesh.devices.shape == (1, 8) == jsp.parallel.host_chip_mesh(
    ).devices.shape
    assert mesh.size == 8 and mesh.shape == {"host": 1, "chip": 8}
    assert tsp.parallel.batch_spec(mesh) == ("host", "chip")
    assert tuple(jsp.parallel.batch_spec(
        jsp.parallel.host_chip_mesh())[0]) == ("host", "chip")
    assert all(d == torch.device("cpu") for d in mesh.devices.ravel())


def test_shard_map_matches_jax_and_plain_solve(solvers_and_data):
    """8 shards of 4 lanes at fp64: the JAX package's shard_map_solver's
    per-lane k and e_flag, iterates within 1e-9; against the port's own
    whole-batch call the same k and e_flag, iterates within 1e-12 (the
    CPU's product rounding depends on the batch's shape)."""
    ts, js, (x0, xr, ur) = solvers_and_data
    res = tsp.parallel.shard_map_solver(
        ts, tsp.parallel.host_chip_mesh(devices=CPU8))(x0, xr, ur)
    ref = jsp.parallel.shard_map_solver(
        js, jsp.parallel.host_chip_mesh())(x0, xr, ur)
    plain = ts(x0, xr, ur)
    for other in (np.asarray(ref.k), plain.k.numpy()):
        np.testing.assert_array_equal(res.k.numpy(), other)
    np.testing.assert_array_equal(res.e_flag.numpy(), np.asarray(ref.e_flag))
    np.testing.assert_array_equal(res.e_flag.numpy(), plain.e_flag.numpy())
    for key in ("z", "v", "lam"):
        np.testing.assert_allclose(res.sol[key].numpy(),
                                   np.asarray(ref.sol[key]), rtol=0,
                                   atol=1e-9, err_msg=key)
        np.testing.assert_allclose(res.sol[key].numpy(),
                                   plain.sol[key].numpy(), rtol=0,
                                   atol=1e-12, err_msg=key)
    np.testing.assert_allclose(res.u.numpy(), np.asarray(ref.u), rtol=0,
                               atol=1e-9)
    _assert_per_shard(res, ts, (x0, xr, ur), 8)
    # every shard's times_ms, in shard order
    assert len(res.sol["times_ms"]) == 8


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture
def world_of_one():
    """A gloo process group of this process alone, brought up through
    parallel.initialize's explicit arguments, torn down afterwards."""
    assert tsp.parallel.initialize(
        coordinator_address=f"localhost:{_free_port()}", num_processes=1,
        process_id=0, backend="gloo") is False
    try:
        assert dist.is_initialized() and dist.get_backend() == "gloo"
        assert not tsp.parallel.is_distributed()
        # idempotent
        assert tsp.parallel.initialize() is False
        yield
    finally:
        dist.destroy_process_group()


def count_collectives(monkeypatch):
    """Wrap every collective of torch.distributed (in its namespace and
    in distributed_c10d, where the library's own helpers call them) with
    a counter; returns the dict of calls by name."""
    calls = {}

    def wrap(name, fn):
        def counted(*args, **kw):
            calls[name] = calls.get(name, 0) + 1
            return fn(*args, **kw)
        return counted

    c10d = dist.distributed_c10d
    for name in COLLECTIVES:
        orig = getattr(c10d, name, None)
        if orig is not None:
            counted = wrap(name, orig)
            monkeypatch.setattr(dist, name, counted, raising=False)
            monkeypatch.setattr(c10d, name, counted)
    return calls


@pytest.mark.parametrize("backend", ["dense", "fused"])
def test_no_collective_in_solve(solvers_and_data, world_of_one, monkeypatch,
                                backend):
    """In place of the JAX tests' HLO checks (no all-reduce, all-gather,
    collective-permute, reduce-scatter or all-to-all in the compiled
    loop), dense and fused: with a process group up, a shard_map solve
    calls no collective of torch.distributed, and global_fleet_metrics
    exactly two all_reduce."""
    ts, _, (x0, xr, ur) = solvers_and_data
    solver = ts if backend == "dense" else _fused()
    mesh = tsp.parallel.host_chip_mesh(devices=CPU8)
    solve = tsp.parallel.shard_map_solver(solver, mesh)
    calls = count_collectives(monkeypatch)
    res = solve(x0, xr, ur)
    res = solve(x0, xr, ur, init=(res.sol["z"], res.sol["v"],
                                  res.sol["lam"]))
    assert calls == {}, calls
    m = tsp.parallel.global_fleet_metrics(res, mesh)
    assert calls == {"all_reduce": 2}, calls
    assert m == dict(tsp.parallel.fleet_metrics(res), n_hosts=1,
                     n_devices=8)


def test_shard_map_warm_start(solvers_and_data):
    ts, _, (x0, xr, ur) = solvers_and_data
    solve = tsp.parallel.shard_map_solver(
        ts, tsp.parallel.host_chip_mesh(devices=CPU8))
    res1 = solve(x0, xr, ur)
    res2 = solve(x0, xr, ur, init=(res1.sol["z"], res1.sol["v"],
                                   res1.sol["lam"]))
    # warm-started from the converged point: immediate exit
    assert int(res2.k.max()) <= 2
    assert bool((res2.e_flag == 1).all())


def test_global_fleet_metrics(solvers_and_data):
    ts, js, (x0, xr, ur) = solvers_and_data
    mesh = tsp.parallel.host_chip_mesh(devices=CPU8)
    m = tsp.parallel.global_fleet_metrics(
        tsp.parallel.shard_map_solver(ts, mesh)(x0, xr, ur), mesh)
    assert m["n_converged"] == m["n_lanes"] == x0.shape[0]
    assert m["k_min"] <= m["k_mean"] <= m["k_max"]
    assert m["n_hosts"] == 1 and m["n_devices"] == 8
    jmesh = jsp.parallel.host_chip_mesh()
    ref = jsp.parallel.global_fleet_metrics(
        jsp.parallel.shard_map_solver(js, jmesh)(x0, xr, ur), jmesh)
    assert set(m) == set(ref)
    for key in ("n_lanes", "n_converged", "k_max", "k_min", "n_hosts",
                "n_devices"):
        assert m[key] == ref[key], key
    # the JAX package takes the mean in float32
    assert m["k_mean"] == pytest.approx(ref["k_mean"], rel=1e-6)


def test_shard_map_batch_divisibility_error(solvers_and_data):
    ts, js, (x0, xr, ur) = solvers_and_data
    solve = tsp.parallel.shard_map_solver(
        ts, tsp.parallel.host_chip_mesh(devices=CPU8))
    with pytest.raises(ValueError, match="divisible"):
        solve(x0[:5], xr[:5], ur[:5])
    with pytest.raises(ValueError, match="divisible"):
        jsp.parallel.shard_map_solver(js, jsp.parallel.host_chip_mesh())(
            x0[:5], xr[:5], ur[:5])
    with pytest.raises(ValueError, match="divisible"):
        tsp.parallel.sharded_solver(
            ts, tsp.parallel.batch_mesh(CPU8))(x0[:5], xr[:5], ur[:5])


@pytest.mark.parametrize("mode", [
    dict(), dict(check_every=8, exact_k=True), dict(check_every=8)],
    ids=["checked", "exact_k", "free_run"])
def test_shard_map_fused_backend(mode):
    """The fused backend (K1's plain version on the CPU) under
    shard_map_solver, in the checked, exact-k and plain free-run modes:
    per-lane results equal a separate solve of each shard bit for bit, so
    sharding adds no numerical effect. (Against one call of the whole
    batch a lane may move at fp32 tolerance boundaries: the rounding of
    the products depends on the batch's shape, and in plain free-run k
    on the lane's group of 8.)"""
    solver = _fused(**mode)
    sys_, param, st = tsp.systems.tester_fixture()
    inputs = _batch(st, 32, 5)
    res = tsp.parallel.shard_map_solver(
        solver, tsp.parallel.host_chip_mesh(devices=CPU8))(*inputs)
    assert bool((res.e_flag == 1).all())
    _assert_per_shard(res, solver, inputs, 8)


def test_hmpc_sadmm_sharded_batch():
    """tests/test_baseline_configs.py::test_hmpc_sadmm_sharded_batch:
    HMPC-SADMM-split with shifted SOCs at a sharded batch over a mesh of
    8 CPU entries, every lane converged, the JAX package's per-lane k and
    u within 1e-9 (its batch cut to 8 lanes a shard)."""
    sys, param, st = tsp.systems.tester_fixture()
    p = dict(param)
    p.pop("T", None)
    p["w"] = 3 * 1.627 * 0.2
    p["Te"] = 10 * p["N"] * np.asarray(p["Q"])
    p["Th"] = p["Te"]
    p["Se"] = np.asarray(p["R"]).copy()
    p["Sh"] = 0.5 * p["Se"]
    kw = dict(formulation="HMPC", method="SADMM", submethod="split",
              rho=2.0, sigma=20.0, tol_p=1e-5, tol_d=1e-5, k_max=2000,
              use_soc=True)
    s = tsp.make_solver(sys, p, device="cpu", **kw)
    mesh = tsp.parallel.batch_mesh(CPU8)
    B = 8 * mesh.size
    inputs = _batch(st, B, 13, -1.5, 1.5)
    out = tsp.parallel.sharded_solver(s, mesh)(*inputs)
    m = tsp.parallel.fleet_metrics(out)
    assert m["n_lanes"] == B and m["n_converged"] == B
    ref = jsp.parallel.sharded_solver(jsp.make_solver(sys, p, **kw),
                                      jsp.parallel.batch_mesh())(*inputs)
    np.testing.assert_array_equal(out.k.numpy(), np.asarray(ref.k))
    np.testing.assert_allclose(out.u.numpy(), np.asarray(ref.u), rtol=0,
                               atol=1e-9)
    assert "batch" in str(ref.u.sharding)


# each family's warm start (the solvers' init tuples)
INIT = {"FISTA": ("lam",), "EADMM": ("z1", "z2", "z3", "lam"),
        "soc": ("z", "s", "lam", "mu"), "split": ("z", "s", "lam", "mu"),
        "HMPC": ("z", "s", "lam"), "ellipHMPC": ("z", "s", "lam")}
CASES = sorted(SOLVER_REGISTRY) + [("laxMPC", "ADMM", "tv")]


def _init_keys(triple):
    f, m, sm = triple
    return (INIT.get(m) or INIT.get(sm) or INIT.get(f)
            or ("z", "v", "lam"))


def _case(triple):
    """(solver, batched inputs) of one case: the triple's dense fp64
    solver at the fixture's N=10 on 8 lanes (every input tiled to a
    batch; ellipMPC-ADMM-soc's radius left to its default), or the
    time-varying laxMPC-ADMM with its nine inputs, each lane's A scaled."""
    sys0, param0, st = tsp.systems.tester_fixture()
    B = 8
    x0 = _batch(st, B, 3, -1.5, 1.5)[0]
    if triple[2] == "tv":
        p = dict(param0, T=np.diag(np.sum(param0["T"], axis=1)))
        o = tsp.default_options("laxMPC", "ADMM", rho=15.0, tol=1e-4,
                                k_max=5000)
        o.time_varying = True
        s = tsp.make_solver(sys0, p, formulation="laxMPC", method="ADMM",
                            options=o, device="cpu")
        scale = np.linspace(0.97, 1.03, B)
        tile = lambda a: np.tile(np.asarray(a), (B, 1))  # noqa: E731
        return s, (x0, tile(st["xr"]), tile(st["ur"]),
                   scale[:, None, None] * np.asarray(sys0["A"]),
                   np.tile(np.asarray(sys0["B"]), (B, 1, 1)),
                   tile(np.diag(p["Q"])), tile(np.diag(p["R"])),
                   tile(np.concatenate([sys0["LBx"], sys0["LBu"]])),
                   tile(np.concatenate([sys0["UBx"], sys0["UBu"]])))
    sys_, p, kw, _ = _float_setup(triple, sys0, param0, st)
    s = tsp.make_solver(sys_, p, formulation=triple[0], method=triple[1],
                        submethod=triple[2], device="cpu", **kw)
    inputs = [np.tile(np.asarray(a), (B, 1)) for a in _inputs_for(s, st)]
    inputs[0] = x0
    return s, tuple(inputs)


@pytest.mark.parametrize("triple", CASES, ids=["-".join(filter(None, t))
                                               for t in CASES])
def test_every_signature_sharded_bitwise(triple):
    """Each of the 13 triples (the 3-input signature, ellipHMPC's 7,
    ellipMPC-ADMM-soc's 4 with its default radius) and the time-varying
    laxMPC-ADMM (9 inputs), dense fp64 on two CPU shards: cold and warm
    (the family's init tuple) solves equal a separate solve of each
    shard's lanes bit for bit, and the warm start exits within 2
    iterations."""
    s, inputs = _case(triple)
    solve = tsp.parallel.shard_map_solver(
        s, tsp.parallel.batch_mesh(["cpu", "cpu"]))
    res = solve(*inputs)
    assert bool((res.e_flag == 1).all()), res.k
    _assert_per_shard(res, s, inputs, 2)
    init = tuple(res.sol[key] for key in _init_keys(triple))
    warm = solve(*inputs, init=init)
    _assert_per_shard(warm, s, inputs, 2, init=init)
    assert int(warm.k.max()) <= 2 and bool((warm.e_flag == 1).all())
    if triple[2] == "soc":
        # the radius given per lane, sharded with the rest
        r = np.linspace(0.4, 0.6, 8)[:, None]
        _assert_per_shard(solve(*inputs, r), s, (*inputs, r), 2)


@pytest.mark.parametrize("backend,extra", [
    ("dense", {}), ("fused", {}), ("banded", {}), ("auto", {}),
    ("dense", dict(time_varying=True)), ("dense", dict(in_engineering=True)),
], ids=["dense", "fused", "banded", "auto", "time_varying", "engineering"])
def test_replica_gives_the_original_bits(backend, extra, tmp_path,
                                         monkeypatch):
    """api._rebuild: a CPU solver rebuilt on the CPU from its recipe (the
    builder, sys, param, options, backend, its numpy ingredients; the
    time-varying solver from sys and param) gives the original's bits;
    _replica returns the solver itself on its own device."""
    monkeypatch.setenv("SPCIES_AUTO_CACHE_DIR", str(tmp_path))
    sys_, param, st = tsp.systems.tester_fixture()
    o = tsp.default_options("laxMPC", "ADMM", rho=15.0, tol=1e-4,
                            k_max=2000, auto_probe_batch=8,
                            auto_probe_iters=3, auto_probe_reps=1)
    o.precision = "float" if backend in ("fused", "auto") else "double"
    inputs = _batch(st, 8, 2)
    if extra.get("time_varying"):
        s, inputs = _case(("laxMPC", "ADMM", "tv"))
    else:
        if extra.get("in_engineering"):
            o.in_engineering = True
            sys_ = dict(sys_, Nx=np.full(6, 1.5), Nu=np.full(2, 0.8),
                        x0=0.01 * np.ones(6), u0=0.02 * np.ones(2))
        s = tsp.make_solver(sys_, param, formulation="laxMPC",
                            method="ADMM", options=o, backend=backend,
                            device="cpu")
    assert _replica(s, "cpu") is s and _replica(s, "cpu:0") is s
    r = _rebuild(s, "cpu")
    assert r is not s and r.device == s.device
    _assert_same(r(*inputs), s(*inputs))
    if backend == "auto":
        assert r.backend_choice == s.backend_choice
    if extra.get("in_engineering"):
        for name in ("_Nx", "_Nu", "_opx", "_opu"):
            np.testing.assert_array_equal(getattr(r, name),
                                          getattr(s, name))


def test_replica_needs_a_recipe():
    """A solver built by a builder directly (no make_solver recipe) serves
    its own device and cannot be replicated."""
    from spcies_tpu_torch.formulations.laxmpc import build_laxmpc_admm
    sys_, param, _ = tsp.systems.tester_fixture()
    s = build_laxmpc_admm(sys_, param, tsp.default_options("laxMPC", "ADMM"),
                          device="cpu")
    assert _replica(s, "cpu") is s
    with pytest.raises(ValueError, match="make_solver"):
        _rebuild(s, "cpu")


def test_meshes_refuse_without_a_card(monkeypatch):
    """No fallback: batch_mesh's and host_chip_mesh's defaults take the
    cards and raise without one, naming devices=; a mesh that spans
    processes is refused by sharded_solver."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (tsp.parallel.batch_mesh, tsp.parallel.host_chip_mesh):
        with pytest.raises(RuntimeError, match="devices="):
            build()
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        tsp.parallel.batch_mesh(["cuda:0"])
    spans = tsp.parallel.Mesh(np.array([["cpu"], [None]], dtype=object),
                              ("host", "chip"))
    with pytest.raises(ValueError, match="shard_map_solver"):
        tsp.parallel.sharded_solver(object(), spans)
    assert spans.size == 2 and spans.local_entries == [
        (0, torch.device("cpu"))]


def test_initialize_reads_the_launcher_environment(monkeypatch):
    """initialize() without torchrun's variables initializes nothing and
    returns False; with some of them and not others it raises, naming
    the missing ones (the JAX package swallows a failed auto-detection);
    a manual bring-up takes its three arguments together."""
    for key in tsp.parallel.distributed.LAUNCHER_ENV:
        monkeypatch.delenv(key, raising=False)
    assert tsp.parallel.initialize() is False
    assert not dist.is_initialized() and not tsp.parallel.is_distributed()
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(ValueError, match="MASTER_ADDR, MASTER_PORT"):
        tsp.parallel.initialize()
    with pytest.raises(ValueError, match="together"):
        tsp.parallel.initialize(coordinator_address="localhost:1")
    assert not dist.is_initialized()


def test_process_local_and_shard_batch(solvers_and_data):
    """Single process: from_process_local tags every lane (offset 0 of
    B); a solve of tagged inputs equals one of the plain arrays;
    shard_batch splits into contiguous chunks, one an entry."""
    ts, _, (x0, xr, ur) = solvers_and_data
    mesh = tsp.parallel.host_chip_mesh(devices=["cpu"] * 4)
    tagged = tsp.parallel.from_process_local(mesh, x0)
    assert (tagged.offset, tagged.global_batch) == (0, 32)
    with pytest.raises(ValueError, match="divisible"):
        tsp.parallel.from_process_local(mesh, x0[:6])
    with pytest.raises(ValueError, match="process-local lanes"):
        tsp.parallel.from_process_local(mesh, x0, global_batch=64)
    solve = tsp.parallel.shard_map_solver(ts, mesh, donate=True)
    _assert_same(solve(tagged, xr, ur), solve(x0, xr, ur))
    chunks = tsp.parallel.shard_batch(mesh, x0, xr)
    assert [len(c) for c in chunks] == [4, 4]
    assert torch.equal(torch.cat(chunks[0]), torch.as_tensor(x0))
    assert all(c.shape[0] == 8 for c in chunks[1])
    assert jax.device_count() == 8
