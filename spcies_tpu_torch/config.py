"""Options and solver-compatibility registry.

Mirrors the reference's central config object `classes/Spcies_options.m`:
  - validated formulation/method/submethod enums and their compatibility
    matrix (Spcies_options.m:63-86),
  - per-(formulation, method, submethod) solver defaults resolved by name
    (Spcies_options.m:477-516 -> def_options_* files),
  - general toolbox options (Spcies_options.m:24-38).

The PyTorch counterpart of spcies_tpu/config.py, with the same option
names, registry and defaults. Options that the reference lowers to C
`#define`s (DEBUG, TIME_VARYING, SCALAR_RHO, ...) are plain Python values
that the builders branch on when the solver is built.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

# ---------------------------------------------------------------------------
# Compatibility registry (reference: classes/Spcies_options.m:69-106)
# ---------------------------------------------------------------------------

# formulation -> tuple of accepted methods
METHODS_BY_FORMULATION: dict[str, tuple[str, ...]] = {
    "laxMPC": ("ADMM", "FISTA"),
    "equMPC": ("ADMM", "FISTA"),
    "ellipMPC": ("ADMM",),
    "MPCT": ("EADMM", "ADMM"),
    "HMPC": ("ADMM", "SADMM"),
    "ellipHMPC": ("ADMM",),
    "personal": (),  # user plugin escape hatch: any method accepted
}

# (formulation, method) -> tuple of accepted submethods ('' = none)
SUBMETHODS: dict[tuple[str, str], tuple[str, ...]] = {
    ("laxMPC", "ADMM"): ("",),
    ("laxMPC", "FISTA"): ("",),
    ("equMPC", "ADMM"): ("",),
    ("equMPC", "FISTA"): ("",),
    ("ellipMPC", "ADMM"): ("", "soc"),
    ("MPCT", "EADMM"): ("",),
    ("MPCT", "ADMM"): ("cs", "semiband"),
    ("HMPC", "ADMM"): ("", "split"),
    ("HMPC", "SADMM"): ("split",),
    ("ellipHMPC", "ADMM"): ("",),
}

# default (method, submethod) per formulation (Spcies_options.m:89-106)
DEFAULT_METHOD: dict[str, tuple[str, str]] = {
    "laxMPC": ("ADMM", ""),
    "equMPC": ("ADMM", ""),
    "ellipMPC": ("ADMM", ""),
    "MPCT": ("EADMM", ""),
    "HMPC": ("ADMM", ""),
    "ellipHMPC": ("ADMM", ""),
}

# The 11 shipped solver triples + their default solver-option dicts.
# Values mirror the def_options_* files cited per entry.
SOLVER_REGISTRY: dict[tuple[str, str, str], dict[str, Any]] = {
    # formulations/+laxMPC/def_options_laxMPC_ADMM.m:82-89
    ("laxMPC", "ADMM", ""): dict(rho=1e-2, tol=1e-4, k_max=1000,
                                 force_vector_rho=False),
    # formulations/+laxMPC/def_options_laxMPC_FISTA.m:107-112
    ("laxMPC", "FISTA", ""): dict(tol=1e-4, k_max=1000),
    # formulations/+equMPC/def_options_equMPC_ADMM.m
    ("equMPC", "ADMM", ""): dict(rho=1e-2, tol=1e-4, k_max=1000,
                                 force_vector_rho=False),
    # formulations/+equMPC/def_options_equMPC_FISTA.m
    ("equMPC", "FISTA", ""): dict(tol=1e-4, k_max=1000),
    # formulations/+ellipMPC/def_options_ellipMPC_ADMM.m:20-25
    ("ellipMPC", "ADMM", ""): dict(rho=1e-2, tol=1e-4, tol_p=1e-4,
                                   tol_d=1e-4, k_max=1000,
                                   force_vector_rho=False),
    # formulations/+ellipMPC/def_options_ellipMPC_ADMM_soc.m:23-27
    ("ellipMPC", "ADMM", "soc"): dict(rho=5.0, sigma=5.0, tol_p=1e-4,
                                      tol_d=1e-4, k_max=1000),
    # formulations/+MPCT/def_options_MPCT_EADMM.m:21-26
    ("MPCT", "EADMM", ""): dict(rho_base=3.0, rho_mult=20.0, epsilon_x=1e-6,
                                epsilon_u=1e-6, tol=1e-4, k_max=1000),
    # formulations/+MPCT/def_options_MPCT_ADMM_cs.m:14-25
    ("MPCT", "ADMM", "cs"): dict(rho=1e-2, tol=1e-4, k_max=1000,
                                 epsilon_x=1e-6, epsilon_u=1e-6,
                                 force_vector_rho=False),
    # formulations/+MPCT/def_options_MPCT_ADMM_semiband.m:24-37
    ("MPCT", "ADMM", "semiband"): dict(rho=1e-2, epsilon_x=1e-6,
                                       epsilon_u=1e-6, epsilon_y=1e-6,
                                       tol_p=1e-4, tol_d=1e-4, k_max=1000,
                                       force_vector_rho=False,
                                       soft_constraints=False,
                                       constrained_output=False, beta=1.0),
    # formulations/+HMPC/def_options_HMPC_ADMM.m:25-37
    # box_constraints=None means auto-detect from whether sys has an E
    # field (cons_HMPC_ADMM_C.m:57-63; reference default is [])
    ("HMPC", "ADMM", ""): dict(rho=1e-2, sigma=1e-2, tol_p=1e-4, tol_d=1e-4,
                               k_max=1000, box_constraints=None,
                               sparse=False, use_soc=False, alpha=0.95),
    ("HMPC", "ADMM", "split"): dict(rho=1e-2, sigma=1e-2, tol_p=1e-4,
                                    tol_d=1e-4, k_max=1000,
                                    box_constraints=None, sparse=False,
                                    use_soc=False, alpha=0.95),
    # formulations/+HMPC/def_options_HMPC_SADMM.m (delegates to ADMM)
    ("HMPC", "SADMM", "split"): dict(rho=1e-2, sigma=1e-2, tol_p=1e-4,
                                     tol_d=1e-4, k_max=1000,
                                     box_constraints=None, sparse=False,
                                     use_soc=False, alpha=0.95),
    # formulations/+HMPC/def_options_ellipHMPC_ADMM.m:18-31
    ("ellipHMPC", "ADMM", ""): dict(rho=1e-2, sigma=0.0, tol_p=1e-4,
                                    tol_d=1e-4, k_max=1000, use_soc=False),
}


@dataclasses.dataclass
class Options:
    """Toolbox-level options (reference: Spcies_options.m:24-38) plus the
    open per-method `solver` dict (reference `options.solver` struct)."""

    formulation: str = ""
    method: str = ""
    submethod: str = ""
    # general options, same names as the reference
    precision: str = "double"      # {'double','float'} -> fp64 / fp32
    inf_value: float = 1e30        # reference clamps inf to 1e20 in codegen
    debug: int = 0                 # 0 off; 1 residual traces (genHist 1);
                                   # 2 full iterate traces (genHist 2 /
                                   # the C DEBUG define). bool accepted.
    timing: bool = True            # collect phase timings (MEASURE_TIME)
    in_engineering: bool = False   # engineering-units scaling (scale_ss)
    time_varying: bool = False     # per-call (A,B,Q,R,LB,UB) data
    force_diagonal: bool = False
    override: bool = True          # overwrite generated files; False picks
                                   # an unused _vN name (find_unused_file_name.m)
    const_are_static: bool = True  # emit `static const` vs plain `const`
                                   # (dec_var.m 'static' option)
    verbose: int = 1
    # solver-specific knobs (rho, tol, k_max, ...)
    solver: dict[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.formulation:
            self.resolve()

    def resolve(self) -> "Options":
        """Validate the triple and fill solver defaults (mirrors
        Spcies_options.to_default_from_selection, Spcies_options.m:477-516)."""
        f, m, s = self.formulation, self.method, self.submethod
        if f != "personal":
            if f not in METHODS_BY_FORMULATION:
                raise ValueError(
                    f"Unknown formulation {f!r}; must be one of "
                    f"{sorted(METHODS_BY_FORMULATION)}")
            if not m:
                m, s = DEFAULT_METHOD[f]
                self.method, self.submethod = m, s
            if m not in METHODS_BY_FORMULATION[f]:
                raise ValueError(
                    f"Method {m!r} not available for formulation {f!r}; "
                    f"accepted: {METHODS_BY_FORMULATION[f]}")
            if (f, m) in SUBMETHODS and s not in SUBMETHODS[(f, m)]:
                raise ValueError(
                    f"Submethod {s!r} not available for ({f}, {m}); "
                    f"accepted: {SUBMETHODS[(f, m)]}")
            defaults = SOLVER_REGISTRY.get((f, m, s), {})
            for key, val in defaults.items():
                self.solver.setdefault(key, val)
        else:
            # reference semantics (Spcies_options.m:506-509): when no
            # def_options_* exists for the selection, warn (gated on
            # verbose > 0) and proceed with the user-provided options
            if self.verbose > 0:
                import warnings
                warnings.warn(
                    "no registered default solver options for the "
                    "'personal' formulation; using the provided solver "
                    "dict as-is (set verbose=0 to silence)",
                    stacklevel=2)
        if self.precision not in ("double", "float"):
            raise ValueError("precision must be 'double' or 'float'")
        self.debug = int(self.debug)   # bool -> level (True == 1)
        return self

    @property
    def np_dtype(self):
        return np.float64 if self.precision == "double" else np.float32


def default_options(formulation: str, method: str = "",
                    submethod: str = "", **solver_overrides) -> Options:
    """Build a resolved Options for a solver triple, with solver-level
    overrides (rho=, tol=, k_max=, ...) applied on top of the registered
    defaults."""
    opts = Options(formulation=formulation, method=method,
                   submethod=submethod, solver=dict(solver_overrides))
    return opts


def determine_formulation(param: dict) -> str:
    """Auto-detect the MPC formulation from the param fields
    (+sp_utils/determine_formulation.m:33-42): S -> MPCT, c -> ellipMPC,
    P -> laxMPC; w (harmonic base frequency) additionally -> HMPC (new —
    the reference has no harmonic auto-detect)."""
    if "S" in param:
        return "MPCT"
    if "w" in param:
        return "HMPC"
    if "c" in param:
        return "ellipMPC"
    if "P" in param:
        return "laxMPC"
    if "T" in param:
        return "laxMPC"
    raise ValueError(
        "MPC formulation not recognized from the given param fields; "
        "specify formulation= explicitly "
        "(+sp_utils/determine_formulation.m:46-48)")


@dataclasses.dataclass
class Problem:
    """The 'recipe' object bundling a plant, problem parameters and options
    (reference classes/Spcies_problem.m:13-33). make_solver accepts the
    same pieces directly; this class exists for workflows that build and
    pass recipes around (e.g. generating several platforms from one
    definition)."""

    sys: dict
    param: dict
    options: Options = dataclasses.field(default_factory=Options)

    def copy(self) -> "Problem":
        """Deep-ish copy (Spcies_problem.copy): fresh dicts and a fresh
        Options so mutations don't leak between recipes."""
        return Problem(sys=dict(self.sys), param=dict(self.param),
                       options=dataclasses.replace(
                           self.options, solver=dict(self.options.solver)))

    def solver(self, **kw):
        """Build the batched solver for this recipe (make_solver arm)."""
        from spcies_tpu_torch.api import make_solver
        return make_solver(self.sys, self.param,
                           formulation=self.options.formulation,
                           method=self.options.method,
                           submethod=self.options.submethod,
                           options=self.options, **kw)

    def generate_c(self, **kw):
        """Generate the embedded plain-C solver for this recipe
        (spcies_gen_controller C-platform arm); returns the .c path."""
        from spcies_tpu_torch.codegen import generate_embedded_solver
        return generate_embedded_solver(
            self.sys, self.param, formulation=self.options.formulation,
            method=self.options.method, submethod=self.options.submethod,
            options=self.options, **kw)
