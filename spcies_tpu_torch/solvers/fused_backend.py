"""Generic 'fused' backend builders: dense single-split box-ADMM solvers
on kernels/fused_admm.py, laxMPC/equMPC dual FISTA on
kernels/fused_fista.py, and MPCT three-block EADMM on
kernels/fused_eadmm.py.

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
from spcies_tpu_torch.kernels.fused_eadmm import fused_eadmm_solve
from spcies_tpu_torch.kernels.fused_fista import fused_fista_solve
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


def _require_fp32(dtype):
    if dtype != torch.float32:
        raise ValueError("the fused backend is the fp32 production path; "
                         "use backend='dense' for fp64 verification")


def build_fused_box_admm_solve(ing, opt, dtype, device, *, make_q_ref,
                               make_aux_b, u_start: int,
                               lb_key: str = "LB_z", ub_key: str = "UB_z"):
    """Return a FusedBoxADMMSolve for a dense box-ADMM formulation."""
    _require_fp32(dtype)
    if not ing["rho_is_scalar"]:
        raise ValueError("the fused backend requires scalar rho")
    return FusedBoxADMMSolve(ing, opt, device, make_q_ref=make_q_ref,
                             make_aux_b=make_aux_b, u_start=u_start,
                             lb_key=lb_key, ub_key=ub_key)


class FusedFISTASolve:
    """`(*inputs, init, fixed_iters) -> SolveResult` running the fused
    dual-FISTA kernel (kernels/fused_fista.py) for laxMPC and equMPC,
    which differ only in how they build q_ref and b. Port of
    spcies_tpu/formulations/laxmpc.py `_build_fista_fused`.

    make_q_ref(*inputs) -> [B, nz] linear cost; make_b(*inputs) ->
    [B, N n] equality right-hand side. `init` is (lam,). `prepare` and
    `operator` expose the kernel's exact arguments.
    """

    def __init__(self, ing, opt, device, *, make_q_ref, make_b):
        self.m, self.nz = ing["m"], ing["nz"]
        self.nlam = ing["N"] * ing["n"]
        self.make_q_ref, self.make_b = make_q_ref, make_b
        s = opt.solver
        self.tile_b = int(s.get("tile_b", 256))
        # exact_k: free-run windows + per-iteration window replay — the
        # dense masked loop's exit semantics at free-run speed
        self.kernel_kw = dict(
            tol=float(s["tol"]), k_max=int(s["k_max"]),
            restart=bool(s.get("restart", False)), tile_b=self.tile_b,
            check_every=int(s.get("check_every", 1)),
            exact_k=bool(s.get("exact_k", False)))

        nz, nlam = self.nz, self.nlam
        nzp, nlamp = round_up(nz, COL_PAD), round_up(nlam, COL_PAD)
        G_pad = np.zeros((nlamp, nzp), np.float32)
        G_pad[:nlam, :nz] = ing["G"]
        WinvT_pad = np.zeros((nlamp, nlamp), np.float32)
        WinvT_pad[:nlam, :nlam] = np.asarray(ing["Winv"]).T
        rows = np.zeros((3, nzp), np.float32)   # hinv, LB, UB
        rows[0, :nz] = ing["hinv_diag"]
        rows[1, :nz] = np.maximum(ing["LB_z"], -1e30)
        rows[2, :nz] = np.minimum(ing["UB_z"], 1e30)
        self.operator = tuple(
            torch.as_tensor(np.ascontiguousarray(a), device=device)
            for a in (G_pad, G_pad.T, WinvT_pad, rows[0:1], rows[1:2],
                      rows[2:3]))
        # the warm-start prologue's operators, unpadded, at full fp32
        self.G = torch.as_tensor(ing["G"], dtype=torch.float32,
                                 device=device)
        self.Winv = torch.as_tensor(ing["Winv"], dtype=torch.float32,
                                    device=device)
        self.hinv = torch.as_tensor(ing["hinv_diag"], dtype=torch.float32,
                                    device=device)
        self.LB, self.UB = self.operator[4][0, :nz], self.operator[5][0, :nz]

    def prepare(self, *inputs, init=None):
        """Kernel inputs for one call: (q1, z0, r0, y0, lam0) padded to
        [Bp, nzp] and [Bp, nlamp], and the batch B."""
        Bsz = inputs[0].shape[0]
        q_ref = self.make_q_ref(*inputs)
        b = self.make_b(*inputs)
        lam0 = (torch.zeros_like(b) if init is None
                else torch.as_tensor(init[0], dtype=torch.float32,
                                     device=b.device))
        # k = 0 warm-start gradient step (solvers/fista.py prologue), plain
        # full-fp32 products
        z0 = torch.minimum(torch.maximum(-self.hinv * (q_ref - lam0 @ self.G),
                                         self.LB), self.UB)
        r0 = b - z0 @ self.G.T
        y = lam0 + r0 @ self.Winv.T          # lam = y after the warm start
        q1 = q_ref - y @ self.G
        nzp, nlamp = self.operator[0].shape[1], self.operator[0].shape[0]
        padb = round_up(Bsz, self.tile_b) - Bsz
        padz = (0, nzp - self.nz, 0, padb)
        padl = (0, nlamp - self.nlam, 0, padb)
        y_p = F.pad(y, padl)
        return (F.pad(q1, padz), F.pad(z0, padz), F.pad(r0, padl), y_p,
                y_p, Bsz)

    def __call__(self, *args):
        *inputs, init, fixed_iters = args
        *kin, Bsz = self.prepare(*inputs, init=init)
        z, y, lam, k, e_flag, res = fused_fista_solve(
            *kin, *self.operator, fixed_iters=int(fixed_iters or 0),
            **self.kernel_kw)
        z = z[:Bsz, :self.nz]
        return SolveResult(u=z[:, :self.m], k=k[:Bsz], e_flag=e_flag[:Bsz],
                           sol=dict(z=z, lam=y[:Bsz, :self.nlam],
                                    res=res[:Bsz]))


def build_fused_fista_solve(ing, opt, dtype, device, *, make_q_ref, make_b):
    """Return a FusedFISTASolve for laxMPC or equMPC dual FISTA."""
    _require_fp32(dtype)
    return FusedFISTASolve(ing, opt, device, make_q_ref=make_q_ref,
                           make_b=make_b)


class FusedEADMMSolve:
    """`(x0, xr, ur, init, fixed_iters) -> SolveResult` running the fused
    MPCT-EADMM kernel (kernels/fused_eadmm.py). Port of
    spcies_tpu/formulations/mpct.py `_build_mpct_eadmm_fused`.

    The A1/A3 coupling applies are elementwise in the kernel's lane
    layout; the A2/W2 block is folded offline into two Z x Z constants,
    C2m (middle rows) and C2t (tail rows). `init` is (z1, z2, z3, lam).
    `prepare` and `operator` expose the kernel's exact arguments; the
    kernel takes them in float32, and `dtype` other than that builds them
    for the plain version alone.
    """

    def __init__(self, ing, opt, device, dtype=torch.float32):
        n, m, N, nm = ing["n"], ing["m"], ing["N"], ing["nm"]
        nz1 = ing["nz1"]
        self.n, self.m, self.N, self.nm, self.nz1 = n, m, N, nm, nz1
        s = opt.solver
        self.tile_b = int(s.get("tile_b", 256))
        self.kernel_kw = dict(
            tol=float(s["tol"]), k_max=int(s["k_max"]), tile_b=self.tile_b,
            check_every=int(s.get("check_every", 1)),
            exact_k=bool(s.get("exact_k", False)))

        Z = round_up(nz1, COL_PAD)
        rho = ing["rho"]
        # z2 block folded offline: v(mid rows) @ C2m + v(tail rows) @ C2t =
        # tile(W2 (A2' v), N+1) -- blocksum (A2mid), W2 map, broadcast (BC)
        W2BC = ing["W2"].T @ np.tile(np.eye(nm), (1, N + 1))    # [nm, nz1]
        A2mid = np.tile(np.eye(nm), (N + 1, 1))                 # [nz1, nm]
        npdt = {torch.float32: np.float32, torch.float64: np.float64}[dtype]
        mats = np.zeros((3, Z, Z), npdt)                        # C2m C2t M3p
        mats[0, :nz1, :nz1] = A2mid @ W2BC
        mats[1, N * nm:nz1, :nz1] = W2BC
        mats[2, :nz1, :nz1] = ing["M3"].T
        # rm, rht, mh, mt, mr, h1i, lb, ub
        rows = np.zeros((8, Z), npdt)
        rows[0, :nz1] = rho[n:n + nz1]
        rows[1, :n] = rho[:n]
        rows[1, N * nm:nz1] = rho[-nm:]
        rows[2, :n] = 1.0
        rows[3, N * nm:nz1] = 1.0
        rows[4, :nz1] = 1.0
        rows[5, :nz1] = ing["H1i"]
        rows[6, :nz1] = np.maximum(ing["LB"], -1e30)
        rows[7, :nz1] = np.minimum(ing["UB"], 1e30)
        self.operator = tuple(torch.as_tensor(a, device=device)
                              for a in (*mats, *rows[:, None, :]))
        self.dtype = dtype
        self.W2, self.T, self.S = (
            torch.as_tensor(ing[key], dtype=dtype, device=device)
            for key in ("W2", "T", "S"))

    def prepare(self, x0, xr, ur, init=None):
        """Kernel inputs for one call: (x0b, z2refb, z2b0, z30, lm0, lht0)
        padded to [Bp, Z], and the batch B."""
        n, N, nm, nz1 = self.n, self.N, self.nm, self.nz1
        Bsz = x0.shape[0]
        Z = self.operator[0].shape[0]
        q2_ref = -torch.cat([xr @ self.T.T, ur @ self.S.T], dim=-1)
        z2ref = q2_ref @ self.W2.T             # a plain full-fp32 product
        Bp = round_up(Bsz, self.tile_b)

        def padB(a):
            return F.pad(a, (0, Z - a.shape[1], 0, Bp - Bsz))

        x0b = padB(x0)                         # x0 at the head lanes
        z2refb = padB(z2ref.repeat(1, N + 1))
        dt = dict(dtype=self.dtype, device=x0.device)
        if init is None:
            zero = torch.zeros((Bp, Z), **dt)
            return x0b, z2refb, zero, zero, zero, zero, Bsz
        _z1i, z2i, z3i, lami = (torch.as_tensor(a, **dt) for a in init)
        lht0 = torch.zeros((Bp, Z), **dt)
        lht0[:Bsz, :n] = lami[:, :n]
        lht0[:Bsz, N * nm:nz1] = lami[:, -nm:]
        return (x0b, z2refb, padB(z2i.repeat(1, N + 1)), padB(z3i),
                padB(lami[:, n:n + nz1]), lht0, Bsz)

    def __call__(self, x0, xr, ur, init, fixed_iters):
        if fixed_iters is not None:
            raise ValueError("fixed_iters is not supported by the fused "
                             "EADMM backend; use backend='dense'")
        *kin, Bsz = self.prepare(x0, xr, ur, init=init)
        (z1, z2b, z3, lm, lht, k, e_flag, r_pf, r_z2,
         r_z3) = fused_eadmm_solve(*kin, *self.operator, **self.kernel_kw)
        n, m, N, nm, nz1 = self.n, self.m, self.N, self.nm, self.nz1
        lam = torch.cat([lht[:Bsz, :n], lm[:Bsz, :nz1],
                         lht[:Bsz, N * nm:nz1]], dim=-1)
        return SolveResult(
            u=z1[:Bsz, n:n + m], k=k[:Bsz], e_flag=e_flag[:Bsz],
            sol=dict(z1=z1[:Bsz, :nz1], z2=z2b[:Bsz, :nm],
                     z3=z3[:Bsz, :nz1], lam=lam, r_pf=r_pf[:Bsz],
                     r_z2=r_z2[:Bsz], r_z3=r_z3[:Bsz]))


def build_fused_eadmm_solve(ing, opt, dtype, device):
    """Return a FusedEADMMSolve for MPCT-EADMM."""
    _require_fp32(dtype)
    return FusedEADMMSolve(ing, opt, device)
