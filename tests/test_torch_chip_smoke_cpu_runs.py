"""chip_smoke.py's fp64 CPU runs of phases 19 and 20, which main() starts
in a pool of processes before phase 18: the jobs cover every correctness
row and full-size reference those phases read, and a run in the pool gives
the bits of the same run in this process. Needs no card."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def cs():
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    import chip_smoke
    return chip_smoke


def test_cpu_jobs_cover_every_fp64_row(cs):
    jobs = cs.cpu_jobs()
    assert len(jobs) == len(set(jobs))
    checks = [(fam, tv, cs._items(extra)) for fam, tv, extra in cs.BAND_CHECKS]
    assert [j[1:] for j in jobs if j[0] == "band check"] == checks
    longs = [(fam, cs._items(extra)) for fam, extra in cs.LONG_CHECKS]
    assert [j[1:] for j in jobs if j[0] == "long check"] == longs
    refs = [j[1:] for j in jobs if j[0] == "band ref"]
    keys = {(fam, horizon, tv) for fam, horizon, _, _, tv, _ in cs.BAND_ROWS}
    assert {(fam, horizon, tv) for fam, horizon, _, tv in refs} == keys
    assert len(refs) == len(keys)
    # each reference is drawn at its rows' batch, whose first lanes it runs
    for fam, horizon, B, tv in refs:
        assert {b for f, h, b, _, t, _ in cs.BAND_ROWS
                if (f, h, t) == (fam, horizon, tv)} == {B}


def test_pool_run_has_the_bits_of_a_run_here(cs, monkeypatch):
    jobs = [("band check", "laxMPC-FISTA", False, ()),
            ("long check", "MPCT-ADMM-semiband",
             cs._items(cs.VECTOR_RHO))]
    monkeypatch.setattr(cs, "cpu_jobs", lambda: jobs)
    monkeypatch.setattr(cs, "CPU_WORKERS", 2)
    cs.start_cpu_runs()
    try:
        pooled = [cs.cpu_run(job)[0] for job in jobs]
    finally:
        cs.stop_cpu_runs()
    assert not cs._CPU_RUNS and not cs._CPU_POOL
    threads = torch.get_num_threads()
    torch.set_num_threads(1)        # as a worker runs
    try:
        here_runs = [cs.cpu_run(job) for job in jobs]
    finally:
        torch.set_num_threads(threads)
    for job, got, (here, seconds, waited) in zip(jobs, pooled, here_runs):
        assert seconds >= 0 and waited >= seconds
        for a, b in ((got.u, here.u), (got.k, here.k),
                     (got.e_flag, here.e_flag)):
            assert np.array_equal(a.numpy(), b.numpy()), job
        assert bool((here.e_flag == 1).all()), job
