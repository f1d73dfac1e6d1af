"""Batched closed-loop rollout on the solver's device. Port of
spcies_tpu/runtime/rollout.py.

The reference's closed-loop demos step MATLAB <-> MEX once per control
period (examples/cl_in_C/main_cl_in_C.c:60-115 and
examples/t00_basic_tutorial.m:160-180). Here B independent closed loops
advance in lockstep: every step solves the whole batch once, applies each
lane's first input, propagates the plant and warm-starts the next solve from
each lane's previous solution. This is the serving pattern of Monte-Carlo
studies and controller fleets.

The JAX package runs the loop as one jitted lax.scan. The port runs it as a
host loop over steps whose state never leaves the device: the plant state,
the warm-start carry and the preallocated outputs are tensors on the
solver's device, written in place, and each step is one call of
`solver.raw_fn` (one kernel launch on a fused box-ADMM or dual-FISTA
solver), with no host synchronisation beyond what a request itself does.

The carry follows the first step's `res.sol`: (z, v, lam) where it holds
v (the ADMM families), else (lam, lam, lam) (the dual-FISTA families, which
read init[0]). Step 0, and every step of a cold rollout, passes init=None,
which every solver treats as zero iterates: the JAX package's zero `init0`
(the port's tests hold the two to the same bits). A warm start is refused
for the families whose warm start takes another shape (MPCT-EADMM's
(z1, z2, z3, lam), ellipMPC-ADMM-soc's (z, s, lam, mu), the HMPC families'
(z, s, lam[, mu])), where the JAX package's scan fails to unpack the
carry or passes it to the wrong slots.
"""

from __future__ import annotations

import torch

# the (formulation, method, submethod) triples whose warm start the rollout
# carries, and the init each takes: (z, v, lam) for the ADMM families,
# (lam,) for dual FISTA
_ADMM, _DUAL = ("z", "v", "lam"), ("lam",)
CARRIED = {
    ("laxMPC", "ADMM", ""): _ADMM,
    ("equMPC", "ADMM", ""): _ADMM,
    ("MPCT", "ADMM", "cs"): _ADMM,
    ("MPCT", "ADMM", "semiband"): _ADMM,
    ("ellipMPC", "ADMM", ""): _ADMM,
    ("laxMPC", "FISTA", ""): _DUAL,
    ("equMPC", "FISTA", ""): _DUAL,
}


def shift_stagewise(arr, n: int, m: int, N: int, *, terminal: bool,
                    tail_x=None):
    """Receding-horizon shift of a stagewise decision/multiplier vector
    [B, nz] with the laxMPC/equMPC layout
    (u_0 | x_1 u_1 | ... | x_{N-1} u_{N-1} [| x_N]):
    advance every stage by one (the next solve's predicted trajectory is
    the previous one shifted), duplicate the last input, and fill the new
    terminal state with tail_x (default: the previous terminal state for
    terminal=True; the previous last predicted state for terminal=False).

    The standard warm-start shift the reference computed matrices for but
    never used (compute_MPCT_EADMM_ingredients.m:157-193). Raises
    ValueError for N < 2, where the layout has no stage to advance (the JAX
    package's slices misalign there without a word).
    """
    if N < 2:
        raise ValueError(f"the stagewise shift needs a horizon of at least "
                         f"2 stages; got N={N}")
    u1 = arr[:, m + n:m + n + m]                     # next step's u_0
    mid = arr[:, m + (n + m):m + (N - 1) * (n + m)]  # stages 2..N-1 -> 1..N-2
    uNm1 = arr[:, m + (N - 2) * (n + m) + n:m + (N - 1) * (n + m)]
    if terminal:
        xN = arr[:, -n:]
        tail = xN if tail_x is None else torch.as_tensor(
            tail_x, dtype=arr.dtype, device=arr.device).expand(xN.shape)
        # new stage N-1 = (old x_N, old u_{N-1}); new terminal = tail
        return torch.cat([u1, mid, xN, uNm1, tail], dim=-1)
    # no terminal block: new stage N-1 = (fill state, old u_{N-1})
    xNm1 = arr[:, m + (N - 2) * (n + m):m + (N - 2) * (n + m) + n]
    fill = xNm1 if tail_x is None else torch.as_tensor(
        tail_x, dtype=arr.dtype, device=arr.device).expand(xNm1.shape)
    return torch.cat([u1, mid, fill, uNm1], dim=-1)


def shift_dual_stages(lam, n: int, N: int):
    """Shift a stage-blocked dual vector [B, N*n] (equality multipliers,
    the FISTA warm-start carry) by one stage, duplicating the last."""
    return torch.cat([lam[:, n:], lam[:, -n:]], dim=-1)


def _family(solver):
    o = solver.options
    return (o.formulation, o.method, o.submethod)


def closed_loop_rollout(solver, A, B, x0, xr, ur, *, n_steps: int,
                        warm_start=True, process_noise=None):
    """Simulate n_steps of closed-loop MPC for a batch of initial states.

    solver: a BatchedSolver over the plain (x0, xr, ur) signature.
    warm_start: False = cold start every solve (the reference C behavior,
        code_laxMPC_ADMM_C.c:58-71); True = carry the previous solution
        unshifted; "shift" = receding-horizon shift (advance all iterates
        one stage, duplicate the tail), which needs the stagewise layout
        of the laxMPC/equMPC builders (solver.stage_layout). A warm start
        takes the families of CARRIED.
    A, B: plant matrices used for propagation (may differ from the model
        the solver was built with: model-mismatch studies).
    x0 [Bz, n] initial states; xr [Bz, n], ur [Bz, m] references.
    process_noise: optional [n_steps, Bz, n] additive disturbance.

    Returns a dict of tensors on the solver's device: xs [n_steps+1, Bz,
    n], us [n_steps, Bz, m], ks [n_steps, Bz], e_flags [n_steps, Bz].
    """
    if warm_start not in (False, True, "shift"):
        raise ValueError(f"warm_start is False, True or 'shift'; got "
                         f"{warm_start!r}")
    if warm_start and _family(solver) not in CARRIED:
        carried = ", ".join(
            f"{'-'.join(p for p in t if p)} ({', '.join(init)}"
            f"{',' if len(init) == 1 else ''})"
            for t, init in CARRIED.items())
        raise ValueError(
            f"closed_loop_rollout carries the warm start of {carried}; "
            f"{'-'.join(p for p in _family(solver) if p)} takes another "
            f"init: use warm_start=False")
    if tuple(solver.input_names) != ("x0", "xr", "ur"):
        raise ValueError(f"closed_loop_rollout drives solvers of the plain "
                         f"(x0, xr, ur) signature; this one takes "
                         f"{solver.input_names}")
    if warm_start == "shift":
        layout = getattr(solver, "stage_layout", None)
        if layout is None:
            raise ValueError(
                "warm_start='shift' needs a solver with a stagewise "
                "decision layout (laxMPC/equMPC families); this solver "
                "does not expose stage_layout; use warm_start=True "
                "(unshifted carry) instead")
        if CARRIED[_family(solver)] == _ADMM:
            # the stagewise shift's own N >= 2 guard, before any solve
            shift_stagewise(torch.zeros((1, solver.nz)), solver.n, solver.m,
                            solver.N, terminal=layout[1])

    dt, dev = solver.dtype, solver.device

    def as_dev(a):
        return torch.as_tensor(a, dtype=dt, device=dev)

    A, B = as_dev(A), as_dev(B)
    n, m = A.shape[0], B.shape[1]
    x0 = torch.atleast_2d(as_dev(x0))
    Bz = x0.shape[0]
    xr = torch.broadcast_to(torch.atleast_2d(as_dev(xr)), (Bz, n)).contiguous()
    ur = torch.broadcast_to(torch.atleast_2d(as_dev(ur)), (Bz, m)).contiguous()
    noise = None if process_noise is None else as_dev(process_noise)

    xs = torch.empty((n_steps + 1, Bz, n), dtype=dt, device=dev)
    us = torch.empty((n_steps, Bz, m), dtype=dt, device=dev)
    ks = torch.empty((n_steps, Bz), dtype=torch.int32, device=dev)
    es = torch.empty((n_steps, Bz), dtype=torch.int32, device=dev)
    xs[0] = x0

    def carry(res):
        if "v" in res.sol:
            keys = ("z", "v", "lam")
        else:
            keys = ("lam", "lam", "lam")
        if warm_start != "shift":
            return tuple(res.sol[k] for k in keys)
        if "v" in res.sol:
            return tuple(shift_stagewise(res.sol[k], solver.n, solver.m,
                                         solver.N,
                                         terminal=solver.stage_layout[1])
                         for k in keys)
        lam_s = shift_dual_stages(res.sol["lam"], solver.n, solver.N)
        return (lam_s, lam_s, lam_s)

    # full-fp32 products for the whole loop, as BatchedSolver.__call__ pins
    # them for a request (raw_fn is called directly here); the setting is
    # process-wide, so it is restored afterwards
    prec = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        x, init = x0, None
        for t in range(n_steps):
            res = solver.raw_fn(x, xr, ur, init, None)
            u = res.u
            x = x @ A.T + u @ B.T
            if noise is not None:
                x = x + noise[t]
            xs[t + 1] = x
            us[t] = u
            ks[t] = res.k
            es[t] = res.e_flag
            if warm_start:
                init = carry(res)
    finally:
        torch.set_float32_matmul_precision(prec)
    return dict(xs=xs, us=us, ks=ks, e_flags=es)
