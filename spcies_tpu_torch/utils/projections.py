"""Projections (torch, batched, branch-free).

The reference implements these as scalar three-case branches
(+sp_utils/proj_SOC.m, proj_SSOC.m, proj_D.m, snippets/proj_SOC3.c:4-35,
code_ellipMPC_ADMM_C.c:321-351, solve_boxQP.m:44-63). Every branch becomes
a `torch.where` select so a whole batch is projected without divergence.
All functions accept arbitrary leading batch dims, operate on the trailing
axis and keep the input's dtype and device.
"""

from __future__ import annotations

import torch


def proj_box(y, lb, ub):
    """Clip onto [lb, ub] — the v-update of every box-constrained solver
    (reference platforms/Matlab/solve_boxQP.m:44-63)."""
    return torch.minimum(torch.maximum(y, lb), ub)


def proj_ellipsoid(y, P, c, r):
    """Exact projection of the trailing axis of `y` onto the ellipsoid
    {x : (x-c)^T P (x-c) <= r^2}, *in the P-norm* (reference
    code_ellipMPC_ADMM_C.c:321-351).

    Scales (y - c) by r/sqrt((y-c)^T P (y-c)) about c when outside.
    """
    d = y - c
    vPv = torch.einsum("...i,ij,...j->...", d, P, d)
    vPv = torch.clamp(vPv, min=1e-300)  # guard sqrt(0); inside lanes ignore it
    scale = torch.where(vPv <= r * r, torch.ones_like(vPv),
                        r / torch.sqrt(vPv))
    return c + d * scale[..., None]


def proj_soc(y):
    """Projection onto the second-order cone {(y0, y1): ||y1|| <= y0} with
    y0 = y[..., 0] (reference +sp_utils/proj_SOC.m three-case form)."""
    return proj_ssoc(y, 1.0, 0.0)


def proj_ssoc(y, alpha, d):
    """Projection onto the shifted SOC
    {(y0, y1): ||y1|| <= alpha*(y0 - d)}, alpha in {-1, +1}
    (reference +sp_utils/proj_SSOC.m, snippets/proj_SOC3.c:4-35).

    The three cases (inside / polar cone -> apex / boundary scaling) are
    combined with nested selects. `alpha` and `d` may be scalars or tensors
    broadcastable against y[..., 0].
    """
    y0 = y[..., 0]
    y1 = y[..., 1:]
    ny1 = torch.sqrt(torch.sum(y1 * y1, dim=-1))
    corr = alpha * (y0 - d)
    inside = ny1 <= corr
    at_apex = ny1 <= -corr
    safe_ny1 = torch.where(ny1 > 0.0, ny1, torch.ones_like(ny1))
    step = (corr + ny1) / (2.0 * safe_ny1)
    z0_proj = step * ny1 * alpha + d
    z1_proj = y1 * step[..., None]
    z0 = torch.where(inside, y0, torch.where(at_apex, d + 0.0 * y0, z0_proj))
    z1 = torch.where(inside[..., None], y1,
                     torch.where(at_apex[..., None], torch.zeros_like(y1),
                                 z1_proj))
    return torch.cat([z0[..., None], z1], dim=-1)


def proj_diamond(y, lb, ub):
    """Projection onto the 'diamond' set K_- ∩ K_+ as the composition of two
    shifted-SOC projections (reference +sp_utils/proj_D.m:19-22):
    first onto {||y1|| <= y0 - lb}, then onto {||y1|| <= ub - y0}."""
    return proj_ssoc(proj_ssoc(y, 1.0, lb), -1.0, ub)
