"""spcies_tpu_torch.entry.entry() and _flagship against the JAX package's
__graft_entry__ (the flagship's solve step: laxMPC-ADMM on the oscillating
masses, N=10, B=256, 10 fixed iterations) on the CPU: the same k, u within
1e-5 at fp32 and within 1e-9 at fp64 (z too); entry() without a card
raises."""

import numpy as np
import pytest
import torch

import __graft_entry__ as jentry
from spcies_tpu_torch import entry as tentry

torch.set_num_threads(2)


def test_entry_matches_jax_flagship_step():
    fn, args = jentry.entry()
    ref = fn(*args)
    tfn, targs = tentry.entry(device="cpu")
    assert [tuple(a.shape) for a in targs] == [(256, 6), (256, 6), (256, 2)]
    assert all(a.dtype == torch.float32 and a.device.type == "cpu"
               for a in targs)
    for a, b in zip(targs, args):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    res = tfn(*targs)
    assert bool((res.k == 10).all())
    np.testing.assert_array_equal(res.k.numpy(), np.asarray(ref.k))
    np.testing.assert_array_equal(res.e_flag.numpy(), np.asarray(ref.e_flag))
    np.testing.assert_allclose(res.u.numpy(), np.asarray(ref.u), atol=1e-5)


@pytest.mark.parametrize("N", [10, 30])
def test_flagship_fp64_matches_jax(N):
    """The fp64 flagship run to convergence: k and e_flag equal on every
    lane, u and z within 1e-9."""
    solver, args = jentry._flagship(64, "float64", N=N)
    ref = solver.raw_fn(*args, None, None)
    tsolver, targs = tentry._flagship(64, "float64", N=N, device="cpu")
    assert tsolver.dtype == torch.float64 and tsolver.N == N
    res = tsolver.raw_fn(*targs, None, None)
    np.testing.assert_array_equal(res.k.numpy(), np.asarray(ref.k))
    np.testing.assert_array_equal(res.e_flag.numpy(), np.asarray(ref.e_flag))
    np.testing.assert_allclose(res.u.numpy(), np.asarray(ref.u), atol=1e-9)
    np.testing.assert_allclose(res.sol["z"].numpy(), np.asarray(ref.sol["z"]),
                               atol=1e-9)


def test_entry_without_a_card_raises(monkeypatch):
    """entry() runs on the card by default and raises without one, naming
    device="cpu"; it does not fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tentry.entry()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tentry._flagship(8)
