"""Generic 'fused' backend builder for dense single-split box-ADMM solvers.

Any formulation whose z-step is a baked dense affine map and whose
projection is a box (laxMPC, equMPC, MPCT-ADMM-cs) runs the same fused
loop (kernels/fused_admm.py): the affine offset only enters through the
peeled first solve z1, and the in-loop delta iteration touches nothing but
M_q and the bounds. This module adapts a formulation's (q_ref, aux_b)
builders onto that kernel. Port of spcies_tpu/solvers/fused_backend.py.

The options `interleave` and `unroll_window` of the JAX package are
accepted and change nothing: both only steered the TPU compiler, with
identical results.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from spcies_tpu_torch.kernels.fused_admm import (COL_PAD, fused_admm_solve,
                                                 round_up)
from spcies_tpu_torch.solvers.common import SolveResult


class FusedBoxADMMSolve:
    """`(*inputs, init, fixed_iters) -> SolveResult` running the fused
    kernel for a dense box-ADMM formulation.

    make_q_ref(*inputs) -> [B, nz] linear cost; make_aux_b(*inputs) ->
    [B, nz] affine offset of the z-step (M_b terms); u = v[:, u_start :
    u_start + m]. `prepare` and `operator` expose the kernel's exact
    arguments, so a caller can run the kernel and its plain version on
    the inputs the solve gives it.
    """

    def __init__(self, ing, opt, device, *, make_q_ref, make_aux_b,
                 u_start: int, lb_key: str, ub_key: str):
        self.m, self.nz = ing["m"], ing["nz"]
        self.make_q_ref, self.make_aux_b = make_q_ref, make_aux_b
        self.u_start = u_start
        s = opt.solver
        tol = float(s["tol"])
        self.tile_b = int(s.get("tile_b", 256))
        # exact_k: free-run in check_every windows, then replay each lane's
        # convergence window with per-iteration checks — the dense loop's
        # k/e_flag/exit iterates at free-run throughput
        self.kernel_kw = dict(
            rho=float(ing["rho_scalar"]), tol_p=tol, tol_d=tol,
            k_max=int(s["k_max"]), tile_b=self.tile_b,
            bf16=bool(s.get("bf16_delta", False)),
            relax_alpha=float(s.get("relax_alpha", 1.0)),
            check_every=int(s.get("check_every", 1)),
            exact_k=bool(s.get("exact_k", False)))
        # sort_lanes: order lanes by a difficulty proxy before tiling so
        # each tile drains at about its own mean k instead of the global
        # max. Results are permuted back; in exact-k mode per-lane outputs
        # do not depend on the tile composition.
        self.sort_lanes = bool(s.get("sort_lanes", False))

        nz = self.nz
        nzp = round_up(nz, COL_PAD)
        M_q_pad = np.zeros((nzp, nzp), dtype=np.float32)
        M_q_pad[:nz, :nz] = ing["M_q"].T          # kernel does dq @ M_q_pad
        LB_pad = np.zeros((1, nzp), dtype=np.float32)
        UB_pad = np.zeros((1, nzp), dtype=np.float32)
        LB_pad[0, :nz] = np.maximum(ing[lb_key], -1e30)
        UB_pad[0, :nz] = np.minimum(ing[ub_key], 1e30)
        self.operator = tuple(torch.as_tensor(a, device=device)
                              for a in (M_q_pad, LB_pad, UB_pad))
        self.M_q = torch.as_tensor(ing["M_q"], dtype=torch.float32,
                                   device=device)
        self.rho = float(ing["rho_scalar"])

    def prepare(self, *inputs, init=None):
        """Kernel inputs for one call: (z1, v0, lam0) padded to
        [Bp, nzp], the lane order (None when unsorted) and the batch B."""
        Bsz, nz = inputs[0].shape[0], self.nz
        q_ref = self.make_q_ref(*inputs)
        aux_b = self.make_aux_b(*inputs)
        if init is None:
            v0 = torch.zeros_like(q_ref)
            lam0 = torch.zeros_like(q_ref)
        else:
            _, v0, lam0 = init
        # the peeled first solve, a plain full-fp32 product
        z1 = (q_ref + lam0 - self.rho * v0) @ self.M_q.T + aux_b

        order = None
        if self.sort_lanes and Bsz > self.tile_b:
            # difficulty proxy: the initial primal infeasibility
            # max|z1 - clip(z1)|; stable so ties keep jnp.argsort's order
            _, LB, UB = self.operator
            proxy = torch.amax(torch.abs(
                z1 - torch.minimum(torch.maximum(z1, LB[0, :nz]),
                                   UB[0, :nz])), dim=1)
            order = torch.argsort(proxy, stable=True)
            z1, v0, lam0 = z1[order], v0[order], lam0[order]

        pad = (0, self.operator[0].shape[0] - nz,
               0, round_up(Bsz, self.tile_b) - Bsz)
        return (F.pad(z1, pad), F.pad(v0, pad), F.pad(lam0, pad), order,
                Bsz)

    def __call__(self, *args):
        *inputs, init, fixed_iters = args
        z1p, v0p, lam0p, order, Bsz = self.prepare(*inputs, init=init)
        z, v, lam, k, e_flag, r_p, r_d = fused_admm_solve(
            z1p, v0p, lam0p, *self.operator,
            fixed_iters=int(fixed_iters or 0), **self.kernel_kw)
        nz = self.nz
        z, v, lam = z[:Bsz, :nz], v[:Bsz, :nz], lam[:Bsz, :nz]
        k, e_flag, r_p, r_d = k[:Bsz], e_flag[:Bsz], r_p[:Bsz], r_d[:Bsz]
        if order is not None:
            inv = torch.argsort(order)
            z, v, lam, k, e_flag, r_p, r_d = (
                a[inv] for a in (z, v, lam, k, e_flag, r_p, r_d))
        return SolveResult(
            u=v[:, self.u_start:self.u_start + self.m], k=k, e_flag=e_flag,
            sol=dict(z=z, v=v, lam=lam, r_p=r_p, r_d=r_d))


def build_fused_box_admm_solve(ing, opt, dtype, device, *, make_q_ref,
                               make_aux_b, u_start: int,
                               lb_key: str = "LB_z", ub_key: str = "UB_z"):
    """Return a FusedBoxADMMSolve for a dense box-ADMM formulation."""
    if dtype != torch.float32:
        raise ValueError("the fused backend is the fp32 production path; "
                         "use backend='dense' for fp64 verification")
    if not ing["rho_is_scalar"]:
        raise ValueError("the fused backend requires scalar rho")
    return FusedBoxADMMSolve(ing, opt, device, make_q_ref=make_q_ref,
                             make_aux_b=make_aux_b, u_start=u_start,
                             lb_key=lb_key, ub_key=ub_key)
