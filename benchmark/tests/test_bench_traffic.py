"""The traffic draws repeat from a seed."""

import numpy as np

from harness.spec import Cell, load_json, BENCH
from harness.traffic import draw_pool
from reference.common import plant_matrices


def _pool(seed, mix="sweep", **over):
    cell = Cell("laxmpc_admm.sweep")
    traffic = dict(load_json(BENCH / "traffic" / f"{mix}.json"), **over)
    A, B = plant_matrices(cell.config)
    return draw_pool(traffic, A, B, seed), A, B


def test_same_seed_same_pool():
    big = 2 ** 31 + 12345
    a, _, _ = _pool(big, batch=64, pool=3)
    b, _, _ = _pool(big, batch=64, pool=3)
    for x, y in zip(a, b):
        for u, v in zip(x, y):
            assert u.dtype == np.float64
            np.testing.assert_array_equal(u, v)


def test_other_seed_same_batches_in_another_order():
    a, _, _ = _pool(1, batch=64, pool=8)
    b, _, _ = _pool(2, batch=64, pool=8)
    key = [x0[0, 0] for x0, _, _ in a]
    assert key != [x0[0, 0] for x0, _, _ in b]
    assert sorted(key) == sorted(x0[0, 0] for x0, _, _ in b)
    for x0, xr, ur in a:
        j = [x[0, 0] for x, _, _ in b].index(x0[0, 0])
        np.testing.assert_array_equal(ur, b[j][2])


def test_ranges_and_steady_states():
    pool, A, B = _pool(7, batch=4096, pool=1)
    x0, xr, ur = pool[0]
    assert x0.shape == (4096, 6) and ur.shape == (4096, 2)
    assert np.all(np.abs(x0[:, :3]) <= 0.2) and np.all(np.abs(x0[:, 3:])
                                                        <= 0.1)
    assert np.all(np.abs(ur) <= 0.5)
    # xr is the steady state of ur: (A - I) xr = -B ur
    np.testing.assert_allclose(xr @ (A - np.eye(6)).T, -ur @ B.T,
                               atol=1e-12)
    # the lanes are independent: states and set points both vary
    assert np.std(x0[:, 0]) > 0.05 and np.std(ur[:, 1]) > 0.2


def test_every_traffic_file_draws():
    for path in sorted((BENCH / "traffic").glob("*.json")):
        traffic = dict(load_json(path), batch=8, pool=2)
        cell = Cell("laxmpc_admm.sweep")
        pool = draw_pool(traffic, *plant_matrices(cell.config), 3)
        assert len(pool) == 2 and pool[1][0].shape == (8, 6)
