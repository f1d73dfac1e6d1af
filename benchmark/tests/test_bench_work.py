"""Each kernel's work count matches a hand count."""

import numpy as np

from harness.spec import Cell, load_module


def _problem(cell_name):
    cell = Cell(cell_name)
    ref = load_module("reference", cell.config["reference"])
    return ref.Problem(cell.config), load_module("work", cell.config["kernel"])


def test_k1_hand_count():
    problem, work = _problem("laxmpc_admm.sweep")
    # nz = N (n + m) = 30 * 8; laxMPC's z-step map is dense
    assert problem.nz == 240
    assert work.nonzeros(problem) == 240 * 240
    k = np.array([100, 200, 7], np.int32)
    assert work.flops(problem, k) == 2 * 57600 * 307
    # z1, v0, lam0 in and z, v, lam out (6 x 3 lanes x 240), the map,
    # two bounds, k, e_flag, r_p, r_d: 4 bytes each
    assert work.nbytes(problem, 3) == 4 * (6 * 3 * 240 + 57600 + 480 + 12)
    assert work.TRACE_NAME == "fused_admm"


def test_k7_hand_count():
    problem, work = _problem("hmpc_split.sweep")
    # dim = m + (N - 1)(n + m) + 3 (n + m) = 2 + 232 + 24; a diamond of
    # three rows for each of the 8 outputs
    assert (problem.dim, problem.n_s) == (258, 24)
    nnz = work.nonzeros(problem)
    # the map's zeros are structural: float64 leaves them at round-off,
    # far below the threshold, and no entry lies between the two
    mag = np.abs(problem.P_q) / np.abs(problem.P_q).max()
    assert nnz == np.count_nonzero(mag > 1e-9) < 282 * 282
    assert np.count_nonzero((mag > 1e-14) & (mag <= 1e-9)) == 0
    k = np.array([10, 1000], np.int32)
    assert work.flops(problem, k) == 2 * nnz * 1010
    assert work.nbytes(problem, 2) == 4 * (6 * 2 * 282 + nnz + 4 * 282 + 8)
    assert work.TRACE_NAME == "fused_split"
