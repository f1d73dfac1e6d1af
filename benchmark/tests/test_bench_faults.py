"""A run with the timed path broken underneath comes out not correct:
the harness's look for a card is skipped (the run is on the CPU, where
the program runs its kernels' plain versions) and the rest of a run is
driven as on the chip, with the kernel wrapper the adapter calls
replaced by a faulty one:

    unchanged  every lane's state comes back as it went in
    half       the second half of the batch's rows is left out (zeros)
    altered    one lane's answer is changed where it is produced

(One chip a cell: no exchange between chips to leave out.)"""

import pytest
import torch

from bench_small import SMALL, small_run

import spcies_tpu_torch.solvers.fused_backend as backend

# the wrapper each cell's adapter calls, and the output holding u
WRAPPER = {"laxmpc_admm.sweep": "fused_admm_solve",
           "laxmpc_admm.fleet_shift": "fused_admm_solve",
           "hmpc_split.sweep": "fused_split_solve",
           "hmpc_split.step_b1024": "fused_split_solve"}
# the output that holds u at column 0, and the state the kernel starts
# from (outputs and inputs in the wrappers' order)
U_OUT = {"fused_admm_solve": 1, "fused_split_solve": 0}
STATE_IN = {"fused_admm_solve": (0, 1, 2), "fused_split_solve": (1, 2, 0)}


def _faulty(real, kind, name):
    def unchanged(*args, **kw):
        B = args[0].shape[0]
        ones = torch.ones(B, dtype=torch.int32)
        r = torch.zeros(B, dtype=args[0].dtype)
        return (*(args[i].clone() for i in STATE_IN[name]), ones,
                ones.clone(), r, r.clone())

    def half(*args, **kw):
        h = args[0].shape[0] // 2
        out = real(*(a[:h] for a in args[:3]), *args[3:], **kw)
        return tuple(torch.cat([o, torch.zeros((h,) + o.shape[1:],
                                               dtype=o.dtype)])
                     for o in out)

    def altered(*args, **kw):
        out = list(real(*args, **kw))
        u = out[U_OUT[name]].clone()
        u[0, 0] += 0.05
        out[U_OUT[name]] = u
        return tuple(out)

    return dict(unchanged=unchanged, half=half, altered=altered)[kind]


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_fault_is_not_correct(cell, kind, monkeypatch):
    name = WRAPPER[cell]
    monkeypatch.setattr(backend, name,
                        _faulty(getattr(backend, name), kind, name))
    res = small_run(cell)
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_sound_run_is_correct(cell):
    res = small_run(cell)
    assert res["correct"] is True, res["checks"]
