"""Each plain reference agrees with the port's float64 CPU path at small
sizes: the same per-lane k and e_flag, u within 1e-9; and the closed-loop
reference with the port's rollout."""

import numpy as np
import pytest
import torch

import spcies_tpu_torch as sp
from spcies_tpu_torch.runtime import closed_loop_rollout

from harness.plant import options, sys_param
from harness.spec import Cell
from harness.traffic import draw_pool
from harness.spec import load_module
from reference.common import Arith, plant_matrices


def _setup(cell_name, N, batch):
    cell = Cell(cell_name)
    config = dict(cell.config, N=N)
    traffic = dict(cell.traffic, batch=batch, pool=1)
    A, B = plant_matrices(config)
    sysd, param = sys_param(config)
    opt = options(sp, config)
    opt.precision = "double"
    solver = sp.make_solver(sysd, param, formulation=config["formulation"],
                            method=config["method"],
                            submethod=config["submethod"], options=opt,
                            backend="dense", device="cpu")
    ref = load_module("reference", config["reference"])
    return config, traffic, A, B, solver, ref


@pytest.mark.parametrize("cell_name,N", [("laxmpc_admm.sweep", 30),
                                         ("laxmpc_admm.sweep", 8),
                                         ("hmpc_split.sweep", 30),
                                         ("hmpc_split.sweep", 6)])
def test_reference_matches_port_fp64(cell_name, N):
    config, traffic, A, B, solver, ref = _setup(cell_name, N, 48)
    (x0, xr, ur), = draw_pool(traffic, A, B, 5)
    res = solver(x0, xr, ur)
    ans = ref.answers(ref.Problem(config), traffic, (x0, xr, ur),
                      Arith("fp64", "cpu"))
    np.testing.assert_array_equal(res.k.numpy(), ans["k"].numpy())
    np.testing.assert_array_equal(res.e_flag.numpy(), ans["e_flag"].numpy())
    np.testing.assert_allclose(res.u.numpy(), ans["u"].numpy(), atol=1e-9)


def test_closed_loop_reference_matches_port_rollout():
    config, traffic, A, B, solver, ref = _setup("laxmpc_admm.fleet_shift",
                                                30, 24)
    traffic = dict(traffic, steps=6)
    (x0, xr, ur), = draw_pool(traffic, A, B, 9)
    out = closed_loop_rollout(solver, A, B, x0, xr, ur, n_steps=6,
                              warm_start="shift")
    ans = ref.answers(ref.Problem(config), traffic, (x0, xr, ur),
                      Arith("fp64", "cpu"))
    for key in ("ks", "e_flags"):
        np.testing.assert_array_equal(out[key].numpy(), ans[key].numpy())
    for key in ("xs", "us"):
        np.testing.assert_allclose(out[key].numpy(), ans[key].numpy(),
                                   atol=1e-9)
    # the warm start is used: later steps take fewer iterations
    assert ans["ks"][1:].double().mean() < 0.5 * ans["ks"][0].double().mean()


def test_reference_imports_nothing_of_the_program():
    import ast
    from harness.spec import BENCH
    for path in (BENCH / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for name in names:
                top = name.split(".")[0]
                assert top in ("__future__", "numpy", "scipy", "torch",
                               "contextlib", "reference"), (path, name)


def test_tf32_rounding():
    from reference.common import tf32_round
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                      1.0 + 2 ** -10, -3.14159])
    r = tf32_round(x)
    # ties to even at 2^-11, exact at 2^-10
    assert r[0] == 1.0 and r[1] == 1.0 and r[3] == 1.0 + 2 ** -10
    assert r[2] == 1.0 + 2 * 2 ** -10
    assert abs(float(r[4]) + 3.14159) < 2 ** -9
