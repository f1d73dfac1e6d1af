"""HMPC's banded backend on the random plants of
tests/test_fuzz_differential.py (random stable plants, n 3-8, m 1-3, N
6-13, random harmonic frequencies): the port of its
test_fuzz_hmpc_banded_structure, in fp64, the port's banded solver held
to the JAX package's banded solver (per-lane k and e_flag, iterates
within 1e-9) and to the port's dense engine. Its lanes run close to
k_max = 20000, so it has a file of its own beside
tests/test_torch_hmpc_banded.py."""

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from tests import test_torch_hmpc_banded as hb
from tests.test_fuzz_differential import DIMS, _random_system

torch.set_num_threads(2)


@pytest.fixture(scope="module", autouse=True)
def _one_blas_thread():
    """One BLAS thread while this module runs (as
    tests/test_torch_hmpc_banded.py's)."""
    with threadpool_limits(limits=1, user_api="blas"):
        yield


@pytest.mark.parametrize("n,m,seed", DIMS)
def test_fuzz_hmpc_banded_structure(n, m, seed):
    """test_fuzz_differential.py:108-137: the structural assumptions
    (arrowhead Hessian, the tail coupled through the last dynamics row
    alone) hold on random stable plants and harmonic frequencies, single
    and split."""
    sys, param, x0, xr, ur = _random_system(400 + seed, n, m)
    rng = np.random.default_rng(900 + seed)
    param = dict(param)
    param["w"] = float(rng.uniform(0.3, 1.5))
    param["Te"] = 5.0 * param["N"] * np.asarray(param["Q"])
    param["Th"] = param["Te"]
    param["Se"] = np.asarray(param["R"]).copy()
    param["Sh"] = 0.5 * param["Se"]
    kw = dict(rho=2.0, sigma=5.0, tol_p=1e-6, tol_d=1e-6, k_max=20000)
    for which in ("single", "split"):
        hb._hold_both(which, sys, param, (x0, xr, ur), **kw)
