"""Public entry point: make_solver — the analogue of the reference's
spcies_gen_controller.m "generate a solver" flow, except the product is a
batched PyTorch solve function on a chosen device instead of a C file.

The (formulation, method, submethod) -> builder dispatch mirrors the
reference's name-mangled `cons_*` eval dispatch
(spcies_gen_controller.m:111-130) via an explicit registry
(formulations.base.BUILDERS). Port of spcies_tpu/api.py.
"""

from __future__ import annotations

import contextvars
import copy
import dataclasses
import functools
import hashlib
import inspect
import json
import os
import time

import numpy as np
import torch

from spcies_tpu_torch.config import Options, default_options


# the numpy dtype a host input is cast to before it is placed
_NUMPY_DTYPES = {torch.float32: np.float32, torch.float64: np.float64}


def broadcast_inputs(dtype, device, *arrays, core_ndims=None):
    """Promote per-call inputs to batched [B, ...] tensors on `device`;
    single problems (core-rank inputs) get a singleton batch dim. All
    inputs must agree on B.

    core_ndims: per-input rank of one problem's data (default 1, vectors;
    matrix inputs like the time-varying solvers' A are rank 2)."""
    if core_ndims is None:
        core_ndims = (1,) * len(arrays)
    np_dtype = _NUMPY_DTYPES.get(dtype)
    out = []
    B = None
    for a, cnd in zip(arrays, core_ndims):
        if np_dtype is not None and not torch.is_tensor(a):
            # host data is cast by numpy, then copied: the same bits as
            # torch's cast inside the copy, which took 5-20 ms a call on
            # a card's first few requests (PERF.md, section 6);
            # silent on overflow to inf, as torch's cast is
            with np.errstate(over="ignore"):
                a = np.asarray(a, dtype=np_dtype)
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


# the device make_solver resolved, while it runs a builder: a
# BatchedSolver made there without a device (a builder of the JAX
# package's plugin signature, which takes no device=) runs on it
_BUILD_DEVICE = contextvars.ContextVar("spcies_build_device", default=None)


def _torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch, numpy or numpy-named one (torch.float64,
    np.float64 and "float64" all give torch.float64)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, dtype=np.dtype(dtype))).dtype


class BatchedSolver:
    """A generated batched solver: callable with (x0, xr, ur[, warm start]).

    Plays the role of the reference's generated MEX/C solver function
    `<formulation>_<method>(x0, xr, ur, ...) -> (u_opt, k, e_flag, sol)`
    (header_laxMPC_ADMM_C.h:24-28), but batched: inputs may be [n] (single
    problem) or [B, n]. Every tensor of the solve lives on `device`.
    Without one it is the device make_solver resolved, where make_solver
    runs the builder, and else the card: RuntimeError without one, as at
    every entry point.
    """

    def __init__(self, solve_fn, ingredients: dict, options: Options,
                 *, n: int, m: int, N: int, nz: int, dtype, device=None,
                 input_names=("x0", "xr", "ur"), default_inputs=(),
                 input_core_ndims=None, input_kinds=None):
        self.ingredients = ingredients
        self.options = options
        self.n, self.m, self.N, self.nz = n, m, N, nz
        self.dtype = _torch_dtype(dtype)
        if device is None:
            device = _BUILD_DEVICE.get() or resolve_device()
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
        # snippets/get_elapsed_time.c:12-15, docs_torch/timing.md). On CUDA
        # each mark records an event on the current stream, and finish()
        # waits once, so a timed request returns finished work.
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

    def aot_memory_analysis(self, *inputs, init=None, fixed_iters=None):
        """The solve's device memory at the given inputs, as a dict of
        byte counts with the JAX package's keys (argument, output, temp,
        alias, code and peak bytes; peak = argument + output + temp -
        alias).

        The JAX package's figure is XLA's, from the compiled executable
        before it runs. This one is MEASURED, not compile-time: on a CUDA
        device it places the inputs and runs the solve once between
        torch.cuda.reset_peak_memory_stats() and
        torch.cuda.max_memory_allocated(), counting from the allocation
        before the inputs were placed (the solver's own operators, placed
        when it was built, are not counted). argument_bytes is what the
        placed inputs allocated, output_bytes what the result holds after
        the solve, temp_bytes the rest of the peak. alias_bytes and
        code_bytes are 0: no buffer is donated, and the kernels' code is
        not device memory the allocator counts. Returns None on the CPU, as
        the JAX package does where a backend has no memory analysis."""
        if self.device.type != "cuda":
            return None
        missing = self.n_inputs - len(inputs)
        if missing > 0:
            inputs = inputs + self.default_inputs[-missing:]
        torch.cuda.synchronize(self.device)
        base = torch.cuda.memory_allocated(self.device)
        torch.cuda.reset_peak_memory_stats(self.device)
        placed = broadcast_inputs(self.dtype, self.device, *inputs,
                                  core_ndims=self.input_core_ndims)
        argument = torch.cuda.memory_allocated(self.device) - base
        res = self(*placed, init=init, fixed_iters=fixed_iters)
        torch.cuda.synchronize(self.device)
        output = torch.cuda.memory_allocated(self.device) - base - argument
        peak = torch.cuda.max_memory_allocated(self.device) - base
        return dict(argument_bytes=argument, output_bytes=output,
                    temp_bytes=peak - argument - output, alias_bytes=0,
                    code_bytes=0, peak_bytes=peak)


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
    backend: 'dense', 'fused', 'banded' (where the triple has them) or
           'auto', which builds the candidates and keeps the fastest
           (`_auto_backend`).
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
    if backend == "auto":
        if ingredients is not None:
            raise ValueError(
                "backend='auto' takes no ingredients=: each backend reads "
                "its own layout (convert.BUILDER_KEYS, BANDED_KEYS); name "
                "the backend the ingredients were made for")
        solver = _auto_backend(builder, sys, param, opt, device)
    else:
        if ingredients is not None and "ingredients" not in _takes(builder):
            raise TypeError(
                f"the builder of {opt.formulation}/{opt.method}"
                f"/{opt.submethod} takes no ingredients=")
        solver = _build(builder, sys, param, opt, backend, device,
                        ingredients)
    if opt.in_engineering:
        solver.set_engineering(sys)
    # what _replica rebuilds the solver from on another device: copies of
    # sys, param and the resolved options as they are now, which later
    # edits of the caller's objects do not reach
    solver._recipe = (builder, copy.deepcopy(dict(sys)),
                      copy.deepcopy(dict(param)), copy.deepcopy(opt),
                      getattr(solver, "backend_choice", backend))
    return solver


@functools.lru_cache(maxsize=None)
def _takes(builder) -> frozenset:
    """The keywords of ("device", "ingredients") that `builder` takes,
    read from its signature once. The port's builders take both; a
    builder of the JAX package's plugin signature, build(sys, param, opt,
    backend="dense"), takes neither."""
    return frozenset(inspect.signature(builder).parameters) & {
        "device", "ingredients"}


def _build(builder, sys, param, opt, backend, device, ingredients=None):
    """builder(sys, param, opt, backend=backend), with device= and
    ingredients= where its signature takes them (`_takes`; ingredients
    is dropped where it does not). While it runs, a BatchedSolver made
    without a device is made on `device`."""
    takes = _takes(builder)
    kw = {}
    if "device" in takes:
        kw["device"] = device
    if "ingredients" in takes:
        kw["ingredients"] = ingredients
    token = _BUILD_DEVICE.set(device)
    try:
        return builder(sys, param, opt, backend=backend, **kw)
    finally:
        _BUILD_DEVICE.reset(token)


def _canonical_device(device) -> torch.device:
    """`device` with its index made explicit: a bare 'cuda' is the
    current card; a CPU device has no index."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    elif device.type == "cpu":
        device = torch.device("cpu")
    return device


def _rebuild(solver: BatchedSolver, device) -> BatchedSolver:
    """`solver` built anew on `device` from the recipe make_solver kept:
    the same builder, sys, param, resolved options (copies taken when
    the solver was built) and backend (for backend='auto' the chosen one,
    probing nothing), from the solver's own
    numpy ingredients (the time-varying solvers, which compute theirs per
    call, from sys and param), with the same engineering-unit scaling.
    JAX places a solver's operators on another device with device_put; a
    torch solver's operators are placed when it is built."""
    recipe = getattr(solver, "_recipe", None)
    if recipe is None:
        raise ValueError("only a solver built by make_solver can be "
                         "replicated to another device")
    builder, sys, param, opt, backend = recipe
    replica = _build(builder, sys, param, copy.deepcopy(opt), backend,
                     resolve_device(device),
                     None if opt.time_varying else solver.ingredients)
    replica._recipe = recipe
    replica._Nx, replica._Nu = solver._Nx, solver._Nu
    replica._opx, replica._opu = solver._opx, solver._opu
    for attr in ("backend_choice", "backend_probe_s",
                 "backend_probe_cached"):
        if hasattr(solver, attr):
            setattr(replica, attr, getattr(solver, attr))
    return replica


def _replica(solver: BatchedSolver, device) -> BatchedSolver:
    """The solver on `device`: itself where it already lives there, else
    `_rebuild`. The scale-out wrappers (parallel/) call each shard's
    replica, so every shard goes through BatchedSolver.__call__."""
    device = _canonical_device(resolve_device(device))
    if device == _canonical_device(solver.device):
        return solver
    return _rebuild(solver, device)


# ---------------------------------------------------------------------------
# backend='auto': a short probe of every backend, its choice kept on disk
# ---------------------------------------------------------------------------

AUTO_BACKENDS = ("dense", "fused", "banded")


def _auto_cache_path():
    """$SPCIES_AUTO_CACHE_DIR/spcies_auto_backend.json, else under
    ~/.cache/spcies_tpu_torch."""
    root = os.environ.get("SPCIES_AUTO_CACHE_DIR") or os.path.expanduser(
        "~/.cache/spcies_tpu_torch")
    return os.path.join(root, "spcies_auto_backend.json")


def _auto_cache_load() -> dict:
    """The cached choices; an absent or unreadable file holds none."""
    try:
        with open(_auto_cache_path()) as f:
            cache = json.load(f)
    except (OSError, ValueError):
        return {}
    return cache if isinstance(cache, dict) else {}


def _auto_cache_store(key: str, backend: str):
    """Add one choice to the cache, atomically (a temporary file and
    os.replace). The cache saves a later probe; a directory that cannot be
    written costs that and fails no build."""
    path = _auto_cache_path()
    cache = _auto_cache_load()
    cache[key] = backend
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.tmp{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(cache, f, indent=0, sort_keys=True)
        os.replace(tmp, path)
    except OSError:
        pass


def _digest_value(h, value):
    """Feed one option or model entry into the hash h: arrays by dtype,
    shape and bytes, containers entry by entry, the rest by repr."""
    if isinstance(value, dict):
        for k in sorted(value):
            h.update(f"<{k}>".encode())
            _digest_value(h, value[k])
        return
    if isinstance(value, (np.ndarray, list, tuple)):
        arr = np.asarray(value)
        if arr.dtype != object:
            h.update(f"{arr.dtype.str}{arr.shape}".encode())
            h.update(np.ascontiguousarray(arr).tobytes())
            return
    h.update(repr(value).encode())


def auto_cache_key(sys: dict, param: dict, opt: Options, device,
                   probe: tuple) -> str:
    """The auto cache's key: the JAX package's fields (the triple, n, m,
    N, precision, time_varying, debug, the probe's batch, iterations and
    repetitions), the device's type and, on a card, its name, and a sha256
    digest of the resolved options (the solver dict but its auto_probe_*
    knobs, and the toolbox options) and of every entry of sys and param.
    The JAX package's key leaves the digest out, so a second build with
    another rho or another plant is served the first one's choice; this
    key does not."""
    device = torch.device(device)
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else device.type)
    h = hashlib.sha256()
    general = {f.name: getattr(opt, f.name)
               for f in dataclasses.fields(opt) if f.name != "solver"}
    for part in (general,
                 {k: v for k, v in opt.solver.items()
                  if not k.startswith("auto_probe")}, sys, param):
        h.update(b"|")
        _digest_value(h, part)
    n = np.asarray(sys["A"]).shape[0]
    m = np.asarray(sys.get("B", sys.get("Bu"))).shape[1]
    return "|".join(map(str, (
        opt.formulation, opt.method, opt.submethod, n, m,
        int(param.get("N", 0)), opt.precision, int(opt.time_varying),
        int(bool(opt.debug)), device.type, kind, *probe, h.hexdigest())))


def _probe_inputs(solver, batch):
    """Zero inputs of `batch` lanes for each input with a unit kind, and
    the registered defaults of the trailing ones without (the JAX
    package's probe inputs), on the solver's device."""
    dims = {"x": solver.n, "xa": solver.n, "u": solver.m, "ua": solver.m,
            "xu": solver.n + solver.m}
    inputs = []
    for kind in solver.input_kinds:
        if kind not in dims:
            break
        inputs.append(torch.zeros((batch, dims[kind]), dtype=solver.dtype,
                                  device=solver.device))
    missing = solver.n_inputs - len(inputs)
    if missing > len(solver.default_inputs):
        raise ValueError(
            f"backend='auto' cannot make probe inputs for the input "
            f"{solver.input_names[len(inputs)]!r}; choose a backend")
    if missing:
        inputs += [torch.as_tensor(d, dtype=solver.dtype,
                                   device=solver.device).expand(
                                       (batch,) + tuple(np.shape(d)))
                   for d in solver.default_inputs[-missing:]]
    return inputs


def _probe_s(solver, batch, iters, reps):
    """Median wall of `reps` solves of exactly `iters` iterations at
    `batch` lanes, after one warm-up, each synchronised on a card. A fused
    solver whose kernel has no fixed_iters mode (`takes_fixed_iters`
    False) runs through fused_backend.for_iterations: its kernel with
    k_max = iters and a tolerance no residual meets, the same work. Any
    error propagates, and so does a non-finite result."""
    run = solver
    fixed = iters
    if not getattr(solver.raw_fn, "takes_fixed_iters", True):
        from spcies_tpu_torch.solvers.fused_backend import for_iterations
        run = copy.copy(solver)
        run.raw_fn = for_iterations(solver.raw_fn, iters)
        fixed = None
    inputs = _probe_inputs(solver, batch)
    cuda = solver.device.type == "cuda"

    def once():
        if cuda:
            torch.cuda.synchronize(solver.device)
        t0 = time.perf_counter()
        res = run(*inputs, fixed_iters=fixed)
        if cuda:
            torch.cuda.synchronize(solver.device)
        return time.perf_counter() - t0, res

    _, res = once()
    if not bool(torch.isfinite(res.u).all()):
        raise FloatingPointError(
            "backend='auto': the probe solve gave a non-finite u")
    times = sorted(once()[0] for _ in range(reps))
    return times[len(times) // 2]


def _auto_backend(builder, sys, param, opt, device) -> BatchedSolver:
    """backend='auto': build every backend of the triple on `device` and
    keep the fastest by a short probe (a fixed-iteration solve of zero
    inputs, one warm-up, the median of auto_probe_reps), as the JAX
    package's `_auto_backend` does; no static rule wins everywhere (the
    fused kernels at the N=30 families, dense at small widths, banded past
    the kernels' 1024 columns only in memory). Probe knobs (solver
    options): auto_probe_batch (2048), auto_probe_iters (50),
    auto_probe_reps (3), auto_probe_refresh (False: a cached choice is
    served). The solver carries backend_choice, backend_probe_s (seconds
    per candidate; empty where nothing was probed) and
    backend_probe_cached.

    A candidate is skipped only where its builder refuses it: a
    ValueError or NotImplementedError raised while it is built (the fused
    backends' fp64 refusal and each kernel's width cap, banded's box-only
    and N >= 3 rules, a triple without the backend); under debug the
    fused backend is not a candidate (its kernels keep no traces). Every
    other error propagates, a kernel's build or launch failure, a CUDA
    error or a non-finite probe result among them: the JAX package's
    probe gives such a candidate an infinite time instead, which would
    hide a broken kernel behind a slower backend.

    The choice is kept on disk (`_auto_cache_path`) under
    `auto_cache_key`, and a later build under the same key, in this
    process or another, builds only the cached backend and probes
    nothing (a cached 'fused' is not served to a debug build)."""
    s = opt.solver
    probe = (int(s.get("auto_probe_batch", 2048)),
             int(s.get("auto_probe_iters", 50)),
             int(s.get("auto_probe_reps", 3)))
    key = auto_cache_key(sys, param, opt, device, probe)

    def mark(solver, backend, times, cached):
        solver.backend_choice = backend
        solver.backend_probe_s = times
        solver.backend_probe_cached = cached
        return solver

    if not s.get("auto_probe_refresh", False):
        cached = _auto_cache_load().get(key)
        if cached == "fused" and opt.debug:
            cached = None
        if cached in AUTO_BACKENDS:
            try:
                solver = _build(builder, sys, param, opt, cached, device)
            except (ValueError, NotImplementedError):
                solver = None
            if solver is not None:
                return mark(solver, cached, {}, True)

    candidates, refusals = {}, {}
    for backend in AUTO_BACKENDS:
        if backend == "fused" and opt.debug:
            continue
        try:
            candidates[backend] = _build(builder, sys, param, opt, backend,
                                         device)
        except (ValueError, NotImplementedError) as exc:
            refusals[backend] = exc
    if not candidates:
        first = next(iter(refusals.values()))
        raise ValueError(
            "no backend could be built for this triple: " + "; ".join(
                f"{be}: {exc}" for be, exc in refusals.items())) from first
    if len(candidates) == 1:
        (backend, solver), = candidates.items()
        _auto_cache_store(key, backend)
        return mark(solver, backend, {}, False)
    times = {backend: _probe_s(solver, *probe)
             for backend, solver in candidates.items()}
    best = min(times, key=times.get)
    _auto_cache_store(key, best)
    return mark(candidates[best], best, times, False)
