"""The mode loops shared by the plain versions of the split-state fused
kernels (kernels/fused_soc.py, fused_hmpc.py, fused_split.py): checked
(check_every=1, freeze blending), plain free-run (check_every>1, drained
per tile) and exact-k (window snapshots and a budgeted replay), as the JAX
kernels run them; there is no fixed_iters mode."""

from __future__ import annotations

import torch

from spcies_tpu_torch.kernels.fused_admm import RBIG

# read "all lanes done" on the host every this many iterations of the
# checked loop (extra iterations of frozen lanes are exact no-ops)
_SYNC_EVERY = 8


def _sel(mask, new, old):
    return torch.where(mask.reshape(-1, *([1] * (new.ndim - 1))), new, old)


def run_modes(iterate, x1, s0, l0, *, tol_p: float, tol_d: float,
              k_max: int, tile_b: int, check_every: int, exact_k: bool):
    """The fused kernels' modes over `iterate(x, s, l) -> (x_next, s, l,
    r_p, r_d)`, whose first leaf x is carried as the prepared and the
    consumed iterate (the checked and exact-k modes return the consumed
    one, plain free-run the prepared one). Returns (x, s, l, k, e_flag,
    r_p, r_d)."""
    B = x1.shape[0]
    dt, dev = x1.dtype, x1.device
    C = int(check_every)

    def conv_of(r_p, r_d):
        return torch.logical_and(r_p <= tol_p, r_d <= tol_d)

    rbig = torch.full((B,), RBIG, dtype=dt, device=dev)
    x, s, lm = x1, s0, l0
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    k = torch.zeros((B,), dtype=torch.int32, device=dev)
    rp, rd = rbig, rbig
    if C > 1 and exact_k:
        sx, ss, sl = x, s, lm
        kws = torch.zeros_like(k)
        it = 0
        while it < k_max and not bool(done.all()):
            a = torch.logical_not(done)
            sx, ss, sl = _sel(a, x, sx), _sel(a, s, ss), _sel(a, lm, sl)
            kws = torch.where(a, it, kws)
            # windows may overshoot k_max: the replay budget cuts each
            # lane off at exactly k_max
            for _ in range(C):
                x, s, lm, r_p, r_d = iterate(x, s, lm)
            done = torch.logical_or(done, a & conv_of(r_p, r_d))
            it += C
        # replay each lane's last window with per-iteration checks
        budget = torch.clamp(k_max - kws, max=C)
        convd = torch.zeros_like(done)
        k = kws
        x, xn, s, lm = sx, sx, ss, sl
        for j in range(C):
            act = torch.logical_not(convd) & (j < budget)
            x2, s2, l2, r_p, r_d = iterate(xn, s, lm)
            x, xn = _sel(act, xn, x), _sel(act, x2, xn)
            s, lm = _sel(act, s2, s), _sel(act, l2, lm)
            k = k + act.to(torch.int32)
            rp, rd = _sel(act, r_p, rp), _sel(act, r_d, rd)
            convd = torch.logical_or(convd, act & conv_of(r_p, r_d))
        done = convd
    elif C > 1:
        # a tile of tile_b lanes stops iterating once all its lanes are
        # done; until then its converged lanes keep iterating too
        if B % tile_b:
            raise ValueError(f"batch {B} is not a multiple of tile_b "
                             f"{tile_b}")
        it = 0
        while it < k_max and not bool(done.all()):
            ta = torch.logical_not(
                done.reshape(-1, tile_b).all(dim=1)).repeat_interleave(tile_b)
            n_fast = min(C - 1, k_max - 1 - it)
            for _ in range(n_fast + 1):
                x2, s2, l2, r_p, r_d = iterate(x, s, lm)
                x, s, lm = _sel(ta, x2, x), _sel(ta, s2, s), _sel(ta, l2, lm)
            a = torch.logical_not(done)
            k = k + a.to(torch.int32) * (n_fast + 1)
            rp, rd = _sel(a, r_p, rp), _sel(a, r_d, rd)
            done = torch.logical_or(done, a & conv_of(r_p, r_d))
            it += n_fast + 1
    else:
        xn = x
        for it in range(k_max):
            if it % _SYNC_EVERY == 0 and bool(done.all()):
                break
            x2, s2, l2, r_p, r_d = iterate(xn, s, lm)
            a = torch.logical_not(done)
            x, xn = _sel(a, xn, x), _sel(a, x2, xn)
            s, lm = _sel(a, s2, s), _sel(a, l2, lm)
            k = k + a.to(torch.int32)
            rp, rd = _sel(a, r_p, rp), _sel(a, r_d, rd)
            done = torch.logical_or(done, a & conv_of(r_p, r_d))
    e_flag = torch.where(done, 1, -1).to(torch.int32)
    return x, s, lm, k, e_flag, rp, rd
