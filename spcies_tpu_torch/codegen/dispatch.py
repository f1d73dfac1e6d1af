"""Unified embedded-C generation entry — the analogue of the reference's
spcies_gen_controller (spcies_gen_controller.m:111-130), which resolves
cons_<formulation>[_<method>][_<submethod>]_<platform> by name.  Here the
(formulation, method, submethod) triple resolves through an explicit
registry to the per-family generator, covering all 11 reference
generated-solver triples. The port of spcies_tpu/codegen/dispatch.py.
"""

from __future__ import annotations

from spcies_tpu_torch.codegen.emit_c import (
    GENERATED_DIR, generate_c_solver, generate_c_fista_solver,
    generate_c_mpct_eadmm_solver, generate_c_hmpc_solver,
    generate_c_tv_solver, generate_c_tv_fista_solver)
from spcies_tpu_torch.codegen.emit_c_ext import (
    generate_c_mpct_cs_solver, generate_c_mpct_semiband_solver,
    generate_c_ellipmpc_soc_solver, generate_c_hmpc_split_solver,
    generate_c_elliphmpc_solver)
from spcies_tpu_torch.config import Options


def _lax_equ_admm(sys, param, formulation, **kw):
    return generate_c_solver(sys, param, formulation=formulation, **kw)


def _fista(sys, param, formulation, **kw):
    return generate_c_fista_solver(sys, param, formulation=formulation, **kw)


_GENERATORS = {
    ("laxMPC", "ADMM", ""): _lax_equ_admm,
    ("laxMPC", "FISTA", ""): _fista,
    ("equMPC", "ADMM", ""): _lax_equ_admm,
    ("equMPC", "FISTA", ""): _fista,
    ("ellipMPC", "ADMM", ""): _lax_equ_admm,
    ("ellipMPC", "ADMM", "soc"):
        lambda sys, param, formulation, **kw:
            generate_c_ellipmpc_soc_solver(sys, param, **kw),
    ("MPCT", "EADMM", ""):
        lambda sys, param, formulation, **kw:
            generate_c_mpct_eadmm_solver(sys, param, **kw),
    ("MPCT", "ADMM", "cs"):
        lambda sys, param, formulation, **kw:
            generate_c_mpct_cs_solver(sys, param, **kw),
    ("MPCT", "ADMM", "semiband"):
        lambda sys, param, formulation, **kw:
            generate_c_mpct_semiband_solver(sys, param, **kw),
    ("HMPC", "ADMM", ""):
        lambda sys, param, formulation, **kw:
            generate_c_hmpc_solver(sys, param, **kw),
    ("HMPC", "ADMM", "split"):
        lambda sys, param, formulation, **kw:
            generate_c_hmpc_split_solver(sys, param, symmetric=False, **kw),
    ("HMPC", "SADMM", "split"):
        lambda sys, param, formulation, **kw:
            generate_c_hmpc_split_solver(sys, param, symmetric=True, **kw),
    ("ellipHMPC", "ADMM", ""):
        lambda sys, param, formulation, **kw:
            generate_c_elliphmpc_solver(sys, param, **kw),
}


def generate_embedded_solver(sys: dict, param: dict, *,
                             formulation: str, method: str = "",
                             submethod: str = "",
                             save_name: str | None = None,
                             directory: str = GENERATED_DIR,
                             compile: bool = True,
                             time_varying: bool = False,
                             options=None, **solver_overrides) -> str:
    """Generate (and by default compile) a standalone plain-C solver for
    any supported (formulation, method, submethod) triple.  Returns the
    path to the generated .c file; lib<name>.so lands next to it.

    time_varying=True (laxMPC/equMPC ADMM only) emits the reference's
    TIME_VARYING=1 solver: 9-input signature with online Alpha/Beta
    recomputation (examples/t01_time_varying_MPC.m workflow).

    This is the C-platform arm of the reference's spcies('gen', ...) flow;
    make_solver is the batched arm, on the card or the CPU.
    """
    sel = Options(formulation=formulation, method=method,
                  submethod=submethod)
    key = (sel.formulation, sel.method, sel.submethod)
    if time_varying or (options is not None and options.time_varying):
        if (key[0] not in ("laxMPC", "equMPC") or key[2] != ""
                or key[1] not in ("ADMM", "FISTA")):
            raise NotImplementedError(
                "TIME_VARYING C generation supports laxMPC/equMPC "
                "ADMM/FISTA (examples/t01_time_varying_MPC.m:17-19)")
        gen_tv = (generate_c_tv_solver if key[1] == "ADMM"
                  else generate_c_tv_fista_solver)
        return gen_tv(
            sys, param, formulation=key[0], save_name=save_name,
            directory=directory, compile=compile, options=options,
            **solver_overrides)
    gen = _GENERATORS.get(key)
    if gen is None:
        raise NotImplementedError(
            f"no embedded-C generator for {key}; available: "
            f"{sorted(_GENERATORS)}")
    return gen(sys, param, formulation, save_name=save_name,
               directory=directory, compile=compile, options=options,
               **solver_overrides)
