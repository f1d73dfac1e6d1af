"""Public entry point: make_solver — the analogue of the reference's
spcies_gen_controller.m "generate a solver" flow, except the product is a
batched PyTorch solve function on a chosen device instead of a C file.

The (formulation, method, submethod) -> builder dispatch mirrors the
reference's name-mangled `cons_*` eval dispatch
(spcies_gen_controller.m:111-130) via an explicit registry
(formulations.base.BUILDERS). Port of spcies_tpu/api.py.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from spcies_tpu_torch.config import Options, default_options


def broadcast_inputs(dtype, device, *arrays, core_ndims=None):
    """Promote per-call inputs to batched [B, ...] tensors on `device`;
    single problems (core-rank inputs) get a singleton batch dim. All
    inputs must agree on B.

    core_ndims: per-input rank of one problem's data (default 1, vectors;
    matrix inputs like the time-varying solvers' A are rank 2)."""
    if core_ndims is None:
        core_ndims = (1,) * len(arrays)
    out = []
    B = None
    for a, cnd in zip(arrays, core_ndims):
        a = torch.as_tensor(a, dtype=dtype, device=device)
        if a.ndim == cnd:
            a = a[None]
        elif a.ndim != cnd + 1:
            raise ValueError(
                f"input must have rank {cnd} (one problem) or {cnd + 1} "
                f"(batched); got rank {a.ndim}")
        if B is None:
            B = a.shape[0]
        elif a.shape[0] == 1 and B > 1:
            a = a.expand((B,) + tuple(a.shape[1:]))
        elif a.shape[0] != B:
            if B == 1:
                B = a.shape[0]
                out = [o.expand((B,) + tuple(o.shape[1:])) for o in out]
            else:
                raise ValueError("inconsistent batch sizes in solver inputs")
        out.append(a)
    return out


# per-input unit kind for the in_engineering scaling: 'x' and 'u' take
# the scaling and the operating point (code_laxMPC_ADMM_C.c:82-115); 'xa'
# and 'ua' are sinusoid AMPLITUDES (ellipHMPC's harmonic sine and cosine
# components), which take the scaling alone: for x_eng(t) = xre + xrs sin +
# xrc cos the incremental signal is Nx (xre - opx) + (Nx xrs) sin +
# (Nx xrc) cos; 'xu' is a stacked single-stage bound [x; u] (the
# time-varying solvers' LB and UB), scaled by [Nx; Nu] around [opx; opu]
# (code_laxMPC_ADMM_C.c:93-97)
_INPUT_KINDS = {"x0": "x", "xr": "x", "ur": "u", "xre": "x", "ure": "u",
                "xrs": "xa", "xrc": "xa", "urs": "ua", "urc": "ua",
                "LB": "xu", "UB": "xu"}


class BatchedSolver:
    """A generated batched solver: callable with (x0, xr, ur[, warm start]).

    Plays the role of the reference's generated MEX/C solver function
    `<formulation>_<method>(x0, xr, ur, ...) -> (u_opt, k, e_flag, sol)`
    (header_laxMPC_ADMM_C.h:24-28), but batched: inputs may be [n] (single
    problem) or [B, n]. Every tensor of the solve lives on `device`.
    """

    def __init__(self, solve_fn, ingredients: dict, options: Options,
                 *, n: int, m: int, N: int, nz: int, dtype, device,
                 input_names=("x0", "xr", "ur"), default_inputs=(),
                 input_core_ndims=None, input_kinds=None):
        self.ingredients = ingredients
        self.options = options
        self.n, self.m, self.N, self.nz = n, m, N, nz
        self.dtype = dtype
        self.device = torch.device(device)
        self.input_names = tuple(input_names)
        # trailing optional inputs (e.g. the soc solver's runtime radius,
        # code_ellipMPC_ADMM_soc_C.c:20 r_ellip) with their default values
        self.default_inputs = tuple(default_inputs)
        # per-input rank of one problem's data (1: vectors; the
        # time-varying solvers' A and B are matrices)
        self.input_core_ndims = (tuple(input_core_ndims)
                                 if input_core_ndims is not None
                                 else (1,) * len(self.input_names))
        # per-input unit kind for the in_engineering scaling (_INPUT_KINDS;
        # None: unscaled), from the input's name unless given
        if input_kinds is None:
            input_kinds = (_INPUT_KINDS.get(name)
                           for name in self.input_names)
        self.input_kinds = tuple(input_kinds)
        self.n_inputs = len(self.input_names)
        # solve_fn(*inputs, init, fixed_iters)
        self.raw_fn = solve_fn

        # engineering-units scaling; populated by make_solver from sys
        # (reference Nx/Nu/x0/u0 fields, +sp_utils/scale_ss.m)
        self._Nx = np.ones(n)
        self._Nu = np.ones(m)
        self._opx = np.zeros(n)
        self._opu = np.zeros(m)

    def set_engineering(self, sys: dict):
        """Install scaling vectors / operating point for in_engineering mode
        (sys fields Nx, Nu, x0, u0; spcies_gen_controller sys conventions)."""
        n, m = self.n, self.m
        self._Nx = np.asarray(sys.get("Nx", np.ones(n)), float).ravel()
        self._Nu = np.asarray(sys.get("Nu", np.ones(m)), float).ravel()
        self._opx = np.asarray(sys.get("x0", np.zeros(n)), float).ravel()
        self._opu = np.asarray(sys.get("u0", np.zeros(m)), float).ravel()

    def _to_incremental(self, inputs):
        """Engineering -> incremental units: x = Nx*(x_eng - opx) etc.
        (code_laxMPC_ADMM_C.c:82-99; time-varying bounds :93-97),
        computed in fp64 on the host."""
        out = []
        for a, kind in zip(inputs, self.input_kinds):
            if torch.is_tensor(a):
                a = a.detach().cpu().numpy()
            if kind == "x":
                a = self._Nx * (np.asarray(a, float) - self._opx)
            elif kind == "u":
                a = self._Nu * (np.asarray(a, float) - self._opu)
            elif kind == "xa":
                a = self._Nx * np.asarray(a, float)
            elif kind == "ua":
                a = self._Nu * np.asarray(a, float)
            elif kind == "xu":
                a = (np.concatenate([self._Nx, self._Nu])
                     * (np.asarray(a, float)
                        - np.concatenate([self._opx, self._opu])))
            out.append(a)
        return tuple(out)

    def __call__(self, *inputs, init=None, fixed_iters=None):
        # Phase timing (Options.timing, the reference's MEASURE_TIME
        # contract: update/solve/polish/run ms stamps around the solve —
        # snippets/get_elapsed_time.c:12-15, docs/timing.md). On CUDA each
        # mark synchronises the device first.
        timer = None
        if self.options.timing:
            from spcies_tpu_torch.diagnostics.timing import PhaseTimer
            timer = PhaseTimer(self.device)
        missing = self.n_inputs - len(inputs)
        if missing < 0 or missing > len(self.default_inputs):
            raise TypeError(
                f"solver expects inputs {self.input_names}, got {len(inputs)}")
        if missing:
            inputs = inputs + self.default_inputs[-missing:]
        if self.options.in_engineering:
            inputs = self._to_incremental(inputs)
        inputs = broadcast_inputs(self.dtype, self.device, *inputs,
                                  core_ndims=self.input_core_ndims)
        if timer is not None:
            timer.mark("update")
        # Full-fp32 matrix products for the whole solve: TF32 keeps about
        # three decimal digits, and any solver product with O(1) operands
        # then floors the residual far above tol. The explicit bf16 paths
        # (bf16_delta) round their operands themselves and are unaffected.
        # "highest" also turns torch.backends.cuda.matmul.allow_tf32 off
        # (PyTorch derives one from the other; setting both through their
        # two APIs makes newer releases refuse to read the precision). The
        # setting is process-wide, so it is restored afterwards.
        prec = torch.get_float32_matmul_precision()
        torch.set_float32_matmul_precision("highest")
        try:
            res = self.raw_fn(*inputs, init, fixed_iters)
        finally:
            torch.set_float32_matmul_precision(prec)
        if timer is not None:
            timer.mark("solve")
        if self.options.in_engineering:
            # de-scale the control move (code_laxMPC_ADMM_C.c:642-651);
            # sol iterates stay in incremental units like the C DEBUG output
            Nu = torch.as_tensor(self._Nu, dtype=self.dtype,
                                 device=self.device)
            opu = torch.as_tensor(self._opu, dtype=self.dtype,
                                  device=self.device)
            res = dataclasses.replace(res, u=res.u / Nu + opu)
        if timer is not None:
            timer.mark("polish")
            res.sol["times_ms"] = timer.finish()
        return res

    def solve(self, *inputs, **kw):
        return self(*inputs, **kw)


def resolve_device(device="cuda") -> torch.device:
    """The device a solver runs on: the card unless the caller names
    another. Raises where a CUDA device is asked for and there is none,
    rather than solving on the CPU unasked."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: spcies_tpu_torch solvers run on the card "
            "unless the caller asks for the CPU; pass device=\"cpu\"")
    return device


def make_solver(sys: dict, param: dict, *, formulation: str = "",
                method: str = "", submethod: str = "",
                options: Options | dict | None = None,
                backend: str = "dense", device="cuda", ingredients=None,
                **solver_overrides) -> BatchedSolver:
    """Build a batched solver for the given system + MPC parameters.

    sys:   dict with A, B, LBx, UBx, LBu, UBu (reference `sys` struct)
    param: dict with the formulation's ingredients (Q, R, N, ...; reference
           `param` struct). If formulation is omitted it is auto-detected
           from the param fields (+sp_utils/determine_formulation.m).
    device: where the solve runs: the CUDA card by default, 'cpu' on
           request (without a card the default raises RuntimeError).
    ingredients: an ingredient dict to build from instead of computing one
           (for example convert.ingredients_from_jax of a JAX solver's).
    """
    if not formulation and (options is None
                            or isinstance(options, dict)
                            or not options.formulation):
        from spcies_tpu_torch.config import determine_formulation
        formulation = determine_formulation(param)
    if options is None:
        opt = default_options(formulation, method, submethod,
                              **solver_overrides)
    elif isinstance(options, dict):
        opt = Options(formulation=formulation, method=method,
                      submethod=submethod,
                      solver={**options, **solver_overrides})
    else:
        opt = options
        opt.formulation = opt.formulation or formulation
        if method:
            opt.method = method
        if submethod:
            opt.submethod = submethod
        opt.solver.update(solver_overrides)
        opt.resolve()

    if backend == "auto":
        raise NotImplementedError(
            "backend='auto' is not ported to spcies_tpu_torch yet "
            "(ROADMAP queue 1 item 12); choose 'dense' or 'fused'")
    if backend == "fused" and opt.debug:
        # genHist-style traces (debug=1/2) are recorded by the masked loop
        # (solvers/loop.py); the fused kernel runs the whole iteration and
        # returns only the exit state
        raise ValueError(
            "debug traces (genHist) are not available on backend='fused' "
            "— the fused kernel returns only the exit state; use "
            "backend='dense' for debug=1/2 runs")
    from spcies_tpu_torch.formulations.base import get_builder
    builder = get_builder(opt.formulation, opt.method, opt.submethod)
    device = resolve_device(device)
    solver = builder(sys, param, opt, backend=backend, device=device,
                     ingredients=ingredients)
    if opt.in_engineering:
        solver.set_engineering(sys)
    return solver
