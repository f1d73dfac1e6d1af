"""Generic 'fused' backend builders: dense single-split box-ADMM solvers
on kernels/fused_admm.py, laxMPC/equMPC dual FISTA on
kernels/fused_fista.py, MPCT three-block EADMM on kernels/fused_eadmm.py,
ellipMPC-ADMM and ADMM-soc on kernels/fused_ellip.py and
kernels/fused_soc.py, HMPC-ADMM and ellipHMPC-ADMM on kernels/fused_hmpc.py,
and HMPC-ADMM-split and HMPC-SADMM-split on kernels/fused_split.py.

Any formulation whose z-step is a baked dense affine map and whose
projection is a box (laxMPC, equMPC, MPCT-ADMM-cs) runs the same fused
loop (kernels/fused_admm.py): the affine offset only enters through the
peeled first solve z1, and the in-loop delta iteration touches nothing but
M_q and the bounds. This module adapts a formulation's (q_ref, aux_b)
builders onto that kernel. Port of spcies_tpu/solvers/fused_backend.py.

The options `interleave` and `unroll_window` of the JAX package are
accepted and change nothing: both only steered the TPU compiler, with
identical results.

Built for a CUDA device, each adapter asks its kernel module's
`check_width` whether some build of the kernel takes the operator's padded
widths, so that a width no build takes is refused by make_solver and not
by the first request. The plain versions, which CPU tensors run, take any
width.
"""

from __future__ import annotations

import copy

import numpy as np
import torch
import torch.nn.functional as F

from spcies_tpu_torch.diagnostics import spans
from spcies_tpu_torch.kernels import (fused_admm, fused_eadmm, fused_ellip,
                                      fused_fista, fused_hmpc, fused_soc,
                                      fused_split)
from spcies_tpu_torch.kernels.fused_admm import (COL_PAD, fused_admm_solve,
                                                 round_up)
from spcies_tpu_torch.kernels.fused_eadmm import (fused_eadmm_solve,
                                                  narrow_operands)
from spcies_tpu_torch.kernels.fused_ellip import (fused_ellip_solve,
                                                  slab_start)
from spcies_tpu_torch.kernels.fused_fista import fused_fista_solve
from spcies_tpu_torch.kernels.fused_hmpc import (WARP, cone_columns,
                                                 cone_layout,
                                                 fused_hmpc_solve)
from spcies_tpu_torch.kernels.fused_soc import fused_soc_solve
from spcies_tpu_torch.kernels.fused_split import fused_split_solve
from spcies_tpu_torch.solvers.common import SolveResult


class FusedBoxADMMSolve:
    """`(*inputs, init, fixed_iters) -> SolveResult` running the fused
    kernel for a dense box-ADMM formulation.

    make_q_ref(*inputs) -> [B, nz] linear cost; make_aux_b(*inputs) ->
    [B, nz] affine offset of the z-step (M_b terms); u = v[:, u_start :
    u_start + m]. `prepare` and `operator` expose the kernel's exact
    arguments, so a caller can run the kernel and its plain version on
    the inputs the solve gives it.

    A call only enqueues work on the current stream, one launch of
    `kernel`, and reads nothing back to the host, so it is `capturable`:
    runtime.closed_loop_rollout replays its episodes as CUDA graphs, kept
    in `episode_graphs`.
    """

    capturable = True
    kernel = staticmethod(fused_admm_solve)

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
        # runtime.rollout.EpisodeGraph by episode shape
        self.episode_graphs = {}

    def prepare(self, *inputs, init=None):
        """Kernel inputs for one call: (z1, v0, lam0) padded to
        [Bp, nzp], the lane order (None when unsorted) and the batch B.
        The call is the span `adapter.prepare` (diagnostics.spans)."""
        t0 = spans.begin()
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
        out = (F.pad(z1, pad), F.pad(v0, pad), F.pad(lam0, pad), order, Bsz)
        spans.end("adapter.prepare", t0)
        return out

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


def for_iterations(solve, iters: int):
    """A copy of the fused solve `solve` whose kernel runs exactly `iters`
    iterations on every lane: k_max = iters and a tolerance no residual
    meets (-1), in the kernel's own mode. backend='auto' times through it
    the kernels that have no fixed_iters mode (the solves whose
    `takes_fixed_iters` is False), for the same work as the other
    candidates' fixed_iters runs; the public call keeps refusing
    fixed_iters, as the JAX package does."""
    out = copy.copy(solve)
    out.kernel_kw = dict(solve.kernel_kw, k_max=int(iters), **{
        key: -1.0 for key in ("tol", "tol_p", "tol_d")
        if key in solve.kernel_kw})
    return out


def _require_fp32(dtype):
    if dtype != torch.float32:
        raise ValueError("the fused backend is the fp32 production path; "
                         "use backend='dense' for fp64 verification")


def _on_card(solve, device, check, *widths):
    """Return `solve`, after check(*widths) (a kernel module's
    `check_width`) where it runs on a CUDA device."""
    if torch.device(device).type == "cuda":
        check(*widths)
    return solve


def build_fused_box_admm_solve(ing, opt, dtype, device, *, make_q_ref,
                               make_aux_b, u_start: int,
                               lb_key: str = "LB_z", ub_key: str = "UB_z"):
    """Return a FusedBoxADMMSolve for a dense box-ADMM formulation."""
    _require_fp32(dtype)
    if not ing["rho_is_scalar"]:
        raise ValueError("the fused backend requires scalar rho")
    solve = FusedBoxADMMSolve(ing, opt, device, make_q_ref=make_q_ref,
                              make_aux_b=make_aux_b, u_start=u_start,
                              lb_key=lb_key, ub_key=ub_key)
    return _on_card(solve, device, fused_admm.check_width,
                    solve.operator[0].shape[0])


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
    solve = FusedFISTASolve(ing, opt, device, make_q_ref=make_q_ref,
                            make_b=make_b)
    nlamp, nzp = solve.operator[0].shape
    return _on_card(solve, device, fused_fista.check_width, nzp, nlamp)


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

    # the kernel has no fixed_iters mode (for_iterations)
    takes_fixed_iters = False

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
        # the kernel's z2 product over the distinct columns of C2m and C2t,
        # found once here so that a request does no comparison
        self.classes = narrow_operands(*self.operator[:2])
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
         r_z3) = fused_eadmm_solve(*kin, *self.operator,
                                   classes=self.classes, **self.kernel_kw)
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
    solve = FusedEADMMSolve(ing, opt, device)
    return _on_card(solve, device, fused_eadmm.check_width,
                    solve.operator[0].shape[0], solve.classes[0].shape[1])


class FusedEllipADMMSolve:
    """`(x0, xr, ur, init, fixed_iters) -> SolveResult` running the fused
    ellipMPC-ADMM kernel (kernels/fused_ellip.py) in P_half coordinates.
    Port of spcies_tpu/formulations/ellipmpc.py `_build_ellipmpc_admm_fused`.

    M2 = S M_q S with S = blkdiag(I, P_half) and the centre c' = P_half c
    are built offline in fp64. The kernel's columns are the ns stage
    entries, then the n terminal entries from column t0 (`slab_start`),
    padded to a multiple of COL_PAD. The peeled first z-solve runs outside
    the kernel at full fp32; `_to_t` / `_from_t` map the terminal block
    into and out of the transformed coordinates (lam is not transformed).
    `init` is (z, v, lam). `prepare` and `operator` expose the kernel's
    exact arguments; the kernel takes them in float32, and `dtype` other
    than that builds them for the plain version alone.
    """

    def __init__(self, ing, opt, device, *, make_q_ref,
                 dtype=torch.float32):
        n, m, nz = ing["n"], ing["m"], ing["nz"]
        self.dtype = dtype
        self.n, self.m, self.nz, self.ns = n, m, nz, nz - n
        self.make_q_ref = make_q_ref
        ns = self.ns
        s = opt.solver
        tol = float(s["tol"])
        self.tile_b = int(s.get("tile_b", 256))
        self.rho = float(ing["rho_T"])
        self.t0 = slab_start(ns, n)
        nzp = round_up(self.t0 + n, COL_PAD)
        # kernel column of each entry of the decision vector
        self.pos = np.concatenate([np.arange(ns), self.t0 + np.arange(n)])
        self.kernel_kw = dict(
            t0=self.t0, rho=self.rho, r_ball=float(ing["r"]), tol_p=tol,
            tol_d=tol, k_max=int(s["k_max"]), tile_b=self.tile_b,
            check_every=int(s.get("check_every", 1)),
            exact_k=bool(s.get("exact_k", False)))

        # offline fp64: M2 = S M_q S (symmetric, as M_q and S are)
        P_half = np.asarray(ing["P_half"], float)
        Pinv_half = np.linalg.inv(P_half)
        S = np.eye(nz)
        S[ns:, ns:] = P_half
        M2 = S @ np.asarray(ing["M_q"], float) @ S
        npdt = {torch.float32: np.float32, torch.float64: np.float64}[dtype]
        M2_pad = np.zeros((nzp, nzp), npdt)
        M2_pad[np.ix_(self.pos, self.pos)] = M2.T   # kernel: dq @ M2_pad
        rows = np.zeros((3, nzp), npdt)             # LB, UB, c'
        rows[0, :ns] = np.maximum(ing["LB"], -1e30)
        rows[1, :ns] = np.minimum(ing["UB"], 1e30)
        rows[2, self.t0:self.t0 + n] = P_half @ np.asarray(ing["c"], float)
        self.operator = tuple(
            torch.as_tensor(np.ascontiguousarray(a), device=device)
            for a in (M2_pad, Pinv_half.T.astype(npdt), rows[0:1],
                      rows[1:2], rows[2:3]))
        self.M_q, self.M_b, self.A, self.P, self.P_half, self.Pinv_half = (
            torch.as_tensor(np.asarray(a, float), dtype=dtype, device=device)
            for a in (ing["M_q"], ing["M_b"], ing["A"], ing["P"], P_half,
                      Pinv_half))

    def _to_t(self, x):
        """Original -> transformed coordinates (the terminal block through
        P_half)."""
        return torch.cat([x[:, :self.ns], x[:, self.ns:] @ self.P_half.T],
                         dim=-1)

    def _from_t(self, x):
        return torch.cat([x[:, :self.ns], x[:, self.ns:] @ self.Pinv_half.T],
                         dim=-1)

    def _scatter(self, x, Bp):
        out = torch.zeros((Bp, self.operator[0].shape[0]), dtype=x.dtype,
                          device=x.device)
        out[:x.shape[0], self.pos] = x
        return out

    def prepare(self, x0, xr, ur, init=None):
        """Kernel inputs for one call: (z1', v0', lam0) in the kernel's
        padded layout [Bp, nzp], and the batch B."""
        ns, rho = self.ns, self.rho
        Bsz = x0.shape[0]
        q_ref = self.make_q_ref(xr, ur)
        b0 = -(x0 @ self.A.T)
        if init is None:
            v0 = torch.zeros_like(q_ref)
            lam0 = torch.zeros_like(q_ref)
        else:
            v0, lam0 = (torch.as_tensor(a, dtype=self.dtype,
                                        device=x0.device) for a in init[1:])
        # the peeled first equality-QP solve, plain full-fp32 products
        qs = q_ref[:, :ns] + lam0[:, :ns] - rho * v0[:, :ns]
        qT = (q_ref[:, ns:] + lam0[:, ns:] @ self.P_half.T
              - rho * (v0[:, ns:] @ self.P.T))
        z1 = torch.cat([qs, qT], dim=-1) @ self.M_q.T + b0 @ self.M_b.T
        Bp = round_up(Bsz, self.tile_b)
        return (self._scatter(self._to_t(z1), Bp),
                self._scatter(self._to_t(v0), Bp), self._scatter(lam0, Bp),
                Bsz)

    def __call__(self, x0, xr, ur, init, fixed_iters):
        *kin, Bsz = self.prepare(x0, xr, ur, init=init)
        z, v, lam, k, e_flag, r_p, r_d = fused_ellip_solve(
            *kin, *self.operator, fixed_iters=int(fixed_iters or 0),
            **self.kernel_kw)
        pos = torch.as_tensor(self.pos, device=z.device)
        z_o = self._from_t(z[:Bsz, pos])
        v_o = self._from_t(v[:Bsz, pos])
        return SolveResult(
            u=v_o[:, :self.m], k=k[:Bsz], e_flag=e_flag[:Bsz],
            sol=dict(z=z_o, v=v_o, lam=lam[:Bsz, pos], r_p=r_p[:Bsz],
                     r_d=r_d[:Bsz]))


def build_fused_ellip_solve(ing, opt, dtype, device, *, make_q_ref):
    """Return a FusedEllipADMMSolve for ellipMPC-ADMM; make_q_ref(xr, ur)
    -> [B, nz] linear cost."""
    _require_fp32(dtype)
    if not ing["rho_is_scalar"]:
        raise ValueError("the fused ellipMPC backend supports scalar rho; "
                         "use backend='dense' for vector rho")
    solve = FusedEllipADMMSolve(ing, opt, device, make_q_ref=make_q_ref)
    return _on_card(solve, device, fused_ellip.check_width,
                    solve.operator[0].shape[0])


class FusedSOCSolve:
    """`(x0, xr, ur, r_ellip, init, fixed_iters) -> SolveResult` running
    the fused slack-SOC kernel (kernels/fused_soc.py) for
    ellipMPC-ADMM-soc. Port of spcies_tpu/formulations/ellipmpc.py
    `_build_ellipmpc_soc_fused`.

    The layout is [z | s], each slab padded to COL_PAD columns (at N=30,
    256 + 32). The runtime radius enters only the prologue offset aux_b.
    `init` is (z, s, lam, mu). `prepare` and `operator` expose the
    kernel's exact arguments; the kernel takes them in float32, and
    `dtype` other than that builds them for the plain version alone.
    """

    # the kernel has no fixed_iters mode (for_iterations)
    takes_fixed_iters = False

    def __init__(self, ing, opt, device, *, make_q, dtype=torch.float32):
        n, m, N = ing["n"], ing["m"], ing["N"]
        dim, n_s = ing["dim"], ing["n_s"]
        self.make_q = make_q
        self.m, self.dim, self.n_s = m, dim, n_s
        nbox = (N - 1) * (n + m) + m
        s = opt.solver
        self.tile_b = int(s.get("tile_b", 256))
        sigma, rho = float(ing["sigma"]), float(ing["rho"])
        dim_p = round_up(dim, COL_PAD)
        P = dim_p + round_up(n_s, COL_PAD)
        self.kernel_kw = dict(
            dim_p=dim_p, tol_p=float(s["tol_p"]), tol_d=float(s["tol_d"]),
            k_max=int(s["k_max"]), tile_b=self.tile_b,
            check_every=int(s.get("check_every", 1)),
            exact_k=bool(s.get("exact_k", False)))
        # kernel column of each entry of [z | s]
        self.pos = np.concatenate([np.arange(dim), dim_p + np.arange(n_s)])

        npdt = {torch.float32: np.float32, torch.float64: np.float64}[dtype]
        M1P = np.zeros((P, P), npdt)
        M1P[np.ix_(self.pos, self.pos)] = np.asarray(ing["M1"]).T
        head = np.zeros((2, dim_p), npdt)           # LB, UB
        head[0, :nbox] = np.maximum(ing["LB"], -1e30)
        head[1, :nbox] = np.minimum(ing["UB"], 1e30)
        head[0, nbox:dim] = -3.0e38                 # x_N, slack unclipped
        head[1, nbox:dim] = 3.0e38
        scales = np.zeros((2, P), npdt)             # scale, iscale
        scales[0, :dim_p] = sigma
        scales[0, dim_p:] = rho
        scales[1, :dim] = 1.0 / sigma
        scales[1, dim_p:dim_p + n_s] = 1.0 / rho
        self.operator = tuple(
            torch.as_tensor(np.ascontiguousarray(a), device=device)
            for a in (M1P, head[0:1], head[1:2], scales[0:1], scales[1:2]))
        self.dtype = dtype
        self.M1, self.M2_b0, self.M2_r, self.M2_d, self.PhiP, self.A = (
            torch.as_tensor(ing[key], dtype=dtype, device=device)
            for key in ("M1", "M2_b0", "M2_r", "M2_d", "PhiP", "A"))
        self.sigma, self.rho = sigma, rho

    def prepare(self, x0, xr, ur, r_ellip, init=None):
        """Kernel inputs for one call: (aux1, zs0, lm0) in the kernel's
        padded layout [Bp, P], and the batch B."""
        Bsz, dim, n_s = x0.shape[0], self.dim, self.n_s
        q = self.make_q(xr, ur)
        aux_b = ((-(x0 @ self.A.T)) @ self.M2_b0.T
                 + r_ellip[:, 0:1] * self.M2_r
                 + (-(xr @ self.PhiP.T)) @ self.M2_d.T)
        dt = dict(dtype=self.dtype, device=x0.device)
        if init is None:
            z0 = torch.zeros((Bsz, dim), **dt)
            s0 = torch.zeros((Bsz, n_s), **dt)
            lam0, mu0 = torch.zeros_like(z0), torch.zeros_like(s0)
        else:
            z0, s0, lam0, mu0 = (torch.as_tensor(a, **dt) for a in init)
        # the peeled first KKT solve, a plain full-fp32 product
        q_hat0 = torch.cat([q - self.sigma * z0 + lam0,
                            mu0 - self.rho * s0], dim=-1)
        aux1 = q_hat0 @ self.M1.T + aux_b
        Bp = round_up(Bsz, self.tile_b)
        P = self.operator[0].shape[0]

        def scatter(x):
            out = torch.zeros((Bp, P), **dt)
            out[:Bsz, self.pos] = x
            return out

        return (scatter(aux1), scatter(torch.cat([z0, s0], dim=-1)),
                scatter(torch.cat([lam0, mu0], dim=-1)), Bsz)

    def __call__(self, x0, xr, ur, r_ellip, init, fixed_iters):
        if fixed_iters is not None:
            raise ValueError("fixed_iters is not supported by the fused "
                             "soc backend; use backend='dense'")
        *kin, Bsz = self.prepare(x0, xr, ur, r_ellip, init=init)
        zs, lm, aux, k, e_flag, r_p, r_d = fused_soc_solve(
            *kin, *self.operator, **self.kernel_kw)
        pos = torch.as_tensor(self.pos, device=zs.device)
        zs, lm, aux = zs[:Bsz, pos], lm[:Bsz, pos], aux[:Bsz, pos]
        dim = self.dim
        return SolveResult(
            u=zs[:, :self.m], k=k[:Bsz], e_flag=e_flag[:Bsz],
            sol=dict(z=zs[:, :dim], s=zs[:, dim:], z_hat=aux[:, :dim],
                     s_hat=aux[:, dim:], lam=lm[:, :dim], mu=lm[:, dim:],
                     r_p=r_p[:Bsz], r_d=r_d[:Bsz]))


def build_fused_soc_solve(ing, opt, dtype, device, *, make_q):
    """Return a FusedSOCSolve for ellipMPC-ADMM-soc; make_q(xr, ur) ->
    [B, dim] linear cost."""
    _require_fp32(dtype)
    solve = FusedSOCSolve(ing, opt, device, make_q=make_q)
    return _on_card(solve, device, fused_soc.check_width,
                    solve.operator[0].shape[0])


def _cone_positions(ing, start: int):
    """(cone0, warps, g, columns [n_cones, 3]) of the HMPC cones in a
    kernel layout whose box rows take columns [start, start + n_box)."""
    n_cones = ing["n_soc"] if ing["use_soc"] else ing["n_y"]
    cone0 = start + round_up(ing["n_box"], COL_PAD)
    warps, g = cone_layout(n_cones)
    return cone0, warps, g, cone_columns(warps, g, cone0)[:n_cones]


def _cone_bounds(rows, cols, lby, uby):
    """Write each cone's D-set bounds onto its three lanes of rows[0:2]."""
    rows[0, cols] = np.asarray(lby)[:, None]
    rows[1, cols] = np.asarray(uby)[:, None]


class FusedHMPCSolve:
    """`(*inputs, init, fixed_iters) -> SolveResult` running the fused
    single-split cone-ADMM kernel (kernels/fused_hmpc.py) for HMPC-ADMM and
    ellipHMPC-ADMM. Port of spcies_tpu/formulations/hmpc.py
    `_build_hmpc_admm_fused`.

    The constraint rows are permuted into the kernel's layout: the box
    rows first, then the cone warps (`pos`); CT = C' and MC = C M1' are
    built offline in fp64 at the padded widths. make_q(*inputs) -> [B, dim]
    linear cost, x0 the first input; lby/uby override the D-set bounds
    (ellipHMPC's sigma-tightened ones). The peeled first solve
    z1 = (q + (rho (s0 - d) + lam0) @ C) @ M1' + aux_b runs outside the
    kernel at full fp32. `init` is (z, s, lam). `prepare` and `operator`
    expose the kernel's exact arguments; the kernel takes them in float32,
    and `dtype` other than that builds them for the plain version alone.
    """

    # the kernel has no fixed_iters mode (for_iterations)
    takes_fixed_iters = False

    def __init__(self, ing, opt, device, M1_np, M2_np, *, make_q, lby=None,
                 uby=None, dtype=torch.float32):
        dim, n_s, n_box = ing["dim"], ing["n_s"], ing["n_box"]
        self.m, self.dim, self.make_q, self.dtype = ing["m"], dim, make_q, dtype
        s = opt.solver
        self.tile_b = int(s.get("tile_b", 256))
        self.rho = float(s["rho"])
        use_soc = bool(ing["use_soc"])
        cone0, warps, g, cols = _cone_positions(ing, 0)
        dim_p, ns_p = round_up(dim, COL_PAD), cone0 + WARP * warps
        # kernel column of each constraint row: box rows, then cone c's
        # (y0, y1, y2)
        self.pos = np.concatenate([np.arange(n_box), cols.ravel()])
        self.kernel_kw = dict(
            rho=self.rho, tol_p=float(s["tol_p"]), tol_d=float(s["tol_d"]),
            k_max=int(s["k_max"]), use_soc=use_soc, cone0=cone0, cone_g=g,
            tile_b=self.tile_b, check_every=int(s.get("check_every", 1)),
            exact_k=bool(s.get("exact_k", False)))

        npdt = {torch.float32: np.float32, torch.float64: np.float64}[dtype]
        C_pp = np.zeros((ns_p, dim))
        C_pp[self.pos] = ing["C"]
        CT = np.zeros((dim_p, ns_p), npdt)
        CT[:dim] = C_pp.T
        MC = np.zeros((ns_p, dim_p), npdt)
        MC[:, :dim] = C_pp @ np.asarray(M1_np).T
        rows = np.zeros((3, ns_p), npdt)           # d, lb, ub
        rows[0, self.pos] = ing["d"]
        rows[1, :n_box] = np.maximum(ing["box_LB"], -1e30)
        rows[2, :n_box] = np.minimum(ing["box_UB"], 1e30)
        if not use_soc:
            _cone_bounds(rows[1:], cols, ing["LBy"] if lby is None else lby,
                         ing["UBy"] if uby is None else uby)
        self.operator = tuple(
            torch.as_tensor(np.ascontiguousarray(a), device=device)
            for a in (CT, MC, rows[0:1], rows[1:2], rows[2:3]))
        self.M1, self.M2, self.C, self.d, self.A = (
            torch.as_tensor(np.asarray(a, float), dtype=dtype, device=device)
            for a in (M1_np, M2_np, ing["C"], ing["d"], ing["A"]))

    def _scatter(self, x, Bp):
        out = torch.zeros((Bp, self.operator[0].shape[1]), dtype=x.dtype,
                          device=x.device)
        out[:x.shape[0], self.pos] = x
        return out

    def prepare(self, *inputs, init=None):
        """Kernel inputs for one call: z1 padded to [Bp, dim_p], (s0, lam0)
        in the kernel's layout [Bp, ns_p], and the batch B."""
        x0 = inputs[0]
        Bsz = x0.shape[0]
        q = self.make_q(*inputs)
        aux_b = (-(x0 @ self.A.T)) @ self.M2.T
        dt = dict(dtype=self.dtype, device=x0.device)
        if init is None:
            s0 = torch.zeros((Bsz, self.C.shape[0]), **dt)
            lam0 = torch.zeros_like(s0)
        else:
            s0, lam0 = (torch.as_tensor(a, **dt) for a in init[1:])
        # the peeled first z-solve, plain full-fp32 products
        z1 = (q + (self.rho * (s0 - self.d) + lam0) @ self.C) @ self.M1.T \
            + aux_b
        Bp = round_up(Bsz, self.tile_b)
        z1p = F.pad(z1, (0, self.operator[0].shape[0] - self.dim,
                         0, Bp - Bsz))
        return z1p, self._scatter(s0, Bp), self._scatter(lam0, Bp), Bsz

    def __call__(self, *args):
        *inputs, init, fixed_iters = args
        if fixed_iters is not None:
            raise ValueError("fixed_iters is not supported by the fused "
                             "HMPC backend; use backend='dense'")
        *kin, Bsz = self.prepare(*inputs, init=init)
        z, s, lam, k, e_flag, r_p, r_d = fused_hmpc_solve(
            *kin, *self.operator, **self.kernel_kw)
        pos = torch.as_tensor(self.pos, device=z.device)
        z = z[:Bsz, :self.dim]
        return SolveResult(
            u=z[:, :self.m], k=k[:Bsz], e_flag=e_flag[:Bsz],
            sol=dict(z=z, s=s[:Bsz, pos], lam=lam[:Bsz, pos],
                     r_p=r_p[:Bsz], r_d=r_d[:Bsz]))


def build_fused_hmpc_solve(ing, opt, dtype, device, M1_np, M2_np, *, make_q,
                           lby=None, uby=None):
    """Return a FusedHMPCSolve for HMPC-ADMM or ellipHMPC-ADMM."""
    _require_fp32(dtype)
    solve = FusedHMPCSolve(ing, opt, device, M1_np, M2_np, make_q=make_q,
                           lby=lby, uby=uby)
    return _on_card(solve, device, fused_hmpc.check_width,
                    *solve.operator[0].shape)


class FusedSplitSolve:
    """`(x0, xr, ur, init, fixed_iters) -> SolveResult` running the fused
    split (S)ADMM kernel (kernels/fused_split.py) for HMPC-ADMM-split and
    HMPC-SADMM-split. Port of spcies_tpu/formulations/hmpc.py
    `_build_hmpc_split_fused`.

    The layout is [z | s] with z padded to COL_PAD columns and the s rows
    permuted into box rows, then cone warps (`pos`); M1' is permuted to
    match. Head clip rows: the box bounds on z's stage entries (box mode)
    or on s's box rows (output mode), +-3e38 on the free entries, [0, 0]
    on pads. aux_b = -(x0 A') M2_b0' + aux_d with aux_d = M2[:, n_eq:] d
    from fp64, and the peeled first aux1 = q_hat0 @ M1' + aux_b at full
    fp32. `init` is (z, s, lam, mu). `prepare` and `operator` expose the
    kernel's exact arguments; the kernel takes them in float32, and `dtype`
    other than that builds them for the plain version alone.
    """

    # the kernel has no fixed_iters mode (for_iterations)
    takes_fixed_iters = False

    def __init__(self, ing, opt, device, M1_np, M2_np, *, make_q,
                 symmetric: bool, dtype=torch.float32):
        n, dim, n_s = ing["n"], ing["dim"], ing["n_s"]
        ns, n_box = ing["ns"], ing["n_box"]
        self.m, self.dim, self.make_q, self.dtype = ing["m"], dim, make_q, dtype
        s = opt.solver
        self.tile_b = int(s.get("tile_b", 256))
        self.sigma, self.rho = float(s["sigma"]), float(s["rho"])
        use_soc = bool(ing["use_soc"])
        dim_p = round_up(dim, COL_PAD)
        cone0, warps, g, cols = _cone_positions(ing, dim_p)
        P = cone0 + WARP * warps
        pos_s = np.concatenate([dim_p + np.arange(n_box), cols.ravel()])
        # kernel column of each entry of [z | s]
        self.pos = np.concatenate([np.arange(dim), pos_s])
        self.kernel_kw = dict(
            alpha=float(s["alpha"]) if symmetric else 1.0,
            symmetric=bool(symmetric), use_soc=use_soc, dim_p=dim_p,
            cone0=cone0, cone_g=g, tol_p=float(s["tol_p"]),
            tol_d=float(s["tol_d"]), k_max=int(s["k_max"]),
            tile_b=self.tile_b, check_every=int(s.get("check_every", 1)),
            exact_k=bool(s.get("exact_k", False)))

        npdt = {torch.float32: np.float32, torch.float64: np.float64}[dtype]
        M1P = np.zeros((P, P), npdt)
        M1P[np.ix_(self.pos, self.pos)] = np.asarray(M1_np).T
        rows = np.zeros((4, P), npdt)               # lb, ub, scale, iscale
        box_at = np.arange(ns) if ing["box_constraints"] else pos_s[:n_box]
        free = np.arange(ns if ing["box_constraints"] else 0, dim)
        rows[0, box_at] = np.maximum(ing["box_LB"], -1e30)
        rows[1, box_at] = np.minimum(ing["box_UB"], 1e30)
        rows[0, free] = -3.0e38                     # harmonic refs unclipped
        rows[1, free] = 3.0e38
        if not use_soc:
            _cone_bounds(rows, cols, ing["LBy"], ing["UBy"])
        rows[2, :dim_p] = self.sigma
        rows[2, dim_p:] = self.rho
        rows[3, :dim] = 1.0 / self.sigma
        rows[3, pos_s] = 1.0 / self.rho
        self.operator = tuple(
            torch.as_tensor(np.ascontiguousarray(a), device=device)
            for a in (M1P, rows[0:1], rows[1:2], rows[2:3], rows[3:4]))
        M2_np = np.asarray(M2_np, float)
        self.M1, self.M2_b0, self.aux_d, self.A = (
            torch.as_tensor(a, dtype=dtype, device=device)
            for a in (np.asarray(M1_np, float), M2_np[:, :n],
                      M2_np[:, ing["n_eq"]:] @ ing["d"], ing["A"]))
        self.n_s = n_s

    def prepare(self, x0, xr, ur, init=None):
        """Kernel inputs for one call: (aux1, zs0, lm0) in the kernel's
        padded layout [Bp, P], and the batch B. The call is the span
        `adapter.prepare` (diagnostics.spans)."""
        t0 = spans.begin()
        Bsz, dim = x0.shape[0], self.dim
        q = self.make_q(x0, xr, ur)
        aux_b = (-(x0 @ self.A.T)) @ self.M2_b0.T + self.aux_d
        dt = dict(dtype=self.dtype, device=x0.device)
        if init is None:
            z0 = torch.zeros((Bsz, dim), **dt)
            s0 = torch.zeros((Bsz, self.n_s), **dt)
            lam0, mu0 = torch.zeros_like(z0), torch.zeros_like(s0)
        else:
            z0, s0, lam0, mu0 = (torch.as_tensor(a, **dt) for a in init)
        # the peeled first KKT solve, a plain full-fp32 product
        q_hat0 = torch.cat([q - self.sigma * z0 + lam0,
                            mu0 - self.rho * s0], dim=-1)
        aux1 = q_hat0 @ self.M1.T + aux_b
        Bp = round_up(Bsz, self.tile_b)
        P = self.operator[0].shape[0]

        def scatter(x):
            out = torch.zeros((Bp, P), **dt)
            out[:Bsz, self.pos] = x
            return out

        out = (scatter(aux1), scatter(torch.cat([z0, s0], dim=-1)),
               scatter(torch.cat([lam0, mu0], dim=-1)), Bsz)
        spans.end("adapter.prepare", t0)
        return out

    def __call__(self, x0, xr, ur, init, fixed_iters):
        if fixed_iters is not None:
            raise ValueError("fixed_iters is not supported by the fused "
                             "split backend; use backend='dense'")
        *kin, Bsz = self.prepare(x0, xr, ur, init=init)
        zs, lm, aux, k, e_flag, r_p, r_d = fused_split_solve(
            *kin, *self.operator, **self.kernel_kw)
        pos = torch.as_tensor(self.pos, device=zs.device)
        zs, lm, aux = zs[:Bsz, pos], lm[:Bsz, pos], aux[:Bsz, pos]
        dim = self.dim
        return SolveResult(
            u=zs[:, :self.m], k=k[:Bsz], e_flag=e_flag[:Bsz],
            sol=dict(z=zs[:, :dim], s=zs[:, dim:], z_hat=aux[:, :dim],
                     s_hat=aux[:, dim:], lam=lm[:, :dim], mu=lm[:, dim:],
                     r_p=r_p[:Bsz], r_d=r_d[:Bsz]))


def build_fused_split_solve(ing, opt, dtype, device, M1_np, M2_np, *,
                            make_q, symmetric: bool):
    """Return a FusedSplitSolve for HMPC-ADMM-split or HMPC-SADMM-split."""
    _require_fp32(dtype)
    solve = FusedSplitSolve(ing, opt, device, M1_np, M2_np, make_q=make_q,
                            symmetric=symmetric)
    return _on_card(solve, device, fused_split.check_width,
                    solve.operator[0].shape[0])
