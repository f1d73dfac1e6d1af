"""Masked batched iteration engine.

The reference solves ONE problem with a data-dependent `while(done==0)` loop
(code_laxMPC_ADMM_C.c:308-633). Here the unit of work is a batch of B
independent problems living in one set of [B, ...] tensors; the loop runs
while ANY lane is still active, with per-lane freeze masking: once a lane
converges its state stops updating, so its final iterates and iteration
count are identical to running it alone. This preserves the reference's
per-problem (k, e_flag) semantics (code_laxMPC_ADMM_C.c:622-631) under
batching.

Reading "is any lane still active" is a device-to-host copy and, on a GPU,
a synchronisation. With freeze masking an iteration in which every lane is
frozen changes nothing, so the loop reads that flag only every
`_SYNC_EVERY` iterations; the few extra iterations are exact no-ops. Modes
in which an extra iteration would change the result (free-running lanes,
recorded traces) read it every iteration.
"""

from __future__ import annotations

from typing import Callable

import torch

_SYNC_EVERY = 8


def _mask_like(mask, leaf):
    """Broadcast a [B] bool mask against a [B, ...] leaf."""
    return mask.reshape(mask.shape + (1,) * (leaf.ndim - 1))


def run_masked_loop(body: Callable, state0: dict, k_max: int, batch: int,
                    fixed_iters: int | None = None,
                    history_keys: tuple = (),
                    freeze: bool = True):
    """Run `body` until every lane converges or k_max is hit.

    body(state, k) -> (new_state, conv[B] bool). `state` is a dict whose
    tensors all have leading dim B. Returns (state, k[B], e_flag[B]) with
    k = iterations performed per lane (1-based, like the reference's k
    counter) and e_flag = 1 converged / -1 hit k_max.

    freeze=False runs FREE: converged lanes keep iterating (converging
    further) until the whole batch is done, instead of being frozen by
    per-leaf masking. Per-lane k still records the first iteration that
    met tolerance.

    fixed_iters: if given, run exactly that many iterations with no
    convergence checks or masking (benchmark mode).

    history_keys: names of per-lane state entries to record per iteration —
    the reference's genHist traces (spcies_laxMPC_ADMM_solver.m:308-319).
    When non-empty the return is (state, k, e_flag, hist) with hist[key]
    of shape [B, k_max, ...]; entries past a lane's exit hold the frozen
    final value (consume with `k`), entries past the whole batch's exit
    stay zero.
    """
    device = next(iter(state0.values())).device
    if fixed_iters is not None and not history_keys:
        state = state0
        for it in range(fixed_iters):
            state, _conv = body(state, it)
        k = torch.full((batch,), fixed_iters, dtype=torch.int32,
                       device=device)
        return state, k, torch.ones((batch,), dtype=torch.int32,
                                    device=device)

    done = torch.zeros((batch,), dtype=torch.bool, device=device)
    k = torch.zeros((batch,), dtype=torch.int32, device=device)
    n_iter = fixed_iters if fixed_iters is not None else k_max
    # preallocated traces, filled in place one iteration at a time
    hist = {key: torch.zeros((n_iter,) + tuple(state0[key].shape),
                             dtype=state0[key].dtype, device=device)
            for key in history_keys}
    sync_every = (_SYNC_EVERY if freeze and fixed_iters is None
                  and not history_keys else 1)

    state = state0
    for it in range(n_iter):
        if it % sync_every == 0 and bool(done.all()):
            break
        new_state, conv = body(state, it)
        active = torch.logical_not(done)
        if fixed_iters is not None:
            state = new_state
            conv = torch.zeros_like(conv)
        elif freeze:
            state = {key: torch.where(_mask_like(active, new), new,
                                      state[key])
                     for key, new in new_state.items()}
        else:
            state = new_state
        for key, h in hist.items():
            h[it] = state[key]
        k = torch.where(active, it + 1, k)
        done = torch.logical_or(done, torch.logical_and(active, conv))

    if fixed_iters is not None:
        e_flag = torch.ones((batch,), dtype=torch.int32, device=device)
    else:
        e_flag = torch.where(done, 1, -1).to(torch.int32)
    if history_keys:
        hist = {key: torch.movedim(h, 0, 1) for key, h in hist.items()}
        return state, k, e_flag, hist
    return state, k, e_flag
