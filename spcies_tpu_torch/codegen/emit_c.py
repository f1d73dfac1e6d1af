"""Plain-C solver generation — the package's embedded-deployment
backend, covering the reference's core product (tailored, allocation-free,
library-free C solvers with the problem data baked in as static const
arrays; spcies_gen_controller.m -> Spcies_constructor.construct flow).

Currently emits laxMPC-ADMM, equMPC-ADMM and ellipMPC-ADMM (plus the FISTA
pair below). The generated C implements the same banded ADMM iteration as the
batched solvers but in this framework's representation: full upper-triangular
BetaInv block inverses (kernels/band_chol.py design) instead of the
reference's inverted-diagonal Beta with in-place substitutions — the
per-stage solves become plain matrix-vector products, and the C is
differential-tested against the dense fp64 solver to round-trip accuracy
(tests/test_torch_codegen_c.py). The port of spcies_tpu/codegen/emit_c.py:
from the same sys, param and options it writes the same bytes (the
emitted banner names the project, spcies_tpu, as that module's does).

Layout of the output directory (default ./generated_solvers, the
reference's output convention):
    <name>.c      self-contained solver (static const data + hot loop)
    <name>.h      defines + prototype
    lib<name>.so  compiled shared library (cc -O3 -shared), the analogue of
                  the reference's MEX compile step
                  (+sp_utils/get_generic_mex_exec.m)
"""

from __future__ import annotations

import os
import shutil
import subprocess

import numpy as np

from spcies_tpu_torch.codegen.c_emitter import c_array, c_define, fmt
from spcies_tpu_torch.config import Options, default_options


GENERATED_DIR = "generated_solvers"



def _unused_name(name: str, directory: str, opt) -> str:
    """override=False picks an unused <name>_vN like the reference's
    +sp_utils/find_unused_file_name.m:21-39."""
    if getattr(opt, "override", True):
        return name
    if not os.path.exists(os.path.join(directory, f"{name}.c")):
        return name
    v = 2
    while os.path.exists(os.path.join(directory, f"{name}_v{v}.c")):
        v += 1
    return f"{name}_v{v}"


def _finalize_src(src: str, opt) -> str:
    """const_are_static=False emits plain `const` declarations
    (platforms/+C_code/dec_var.m 'static' option)."""
    if not getattr(opt, "const_are_static", True):
        src = src.replace("static const ", "const ")
    return src


def clear_generated(directory: str = GENERATED_DIR) -> None:
    """Delete generated solver artifacts (the spcies_clear analogue,
    spcies_clear.m:8-26)."""
    if os.path.isdir(directory):
        shutil.rmtree(directory)


_SOLVER_TEMPLATE = r"""
/* {name} — generated by spcies_tpu (laxMPC/equMPC family, banded ADMM).
 * Self-contained, allocation-free; problem data baked below.
 * Iteration (matches the spcies_tpu ADMM engine, direct form):
 *   q_hat = q + lam - rho v
 *   z     = argmin 0.5 z'Hhat z + q_hat'z  s.t. G z = beq   (band solve)
 *   v     = clip(z + rho^-1 lam, LB, UB)
 *   lam  += rho (z - v)
 *   stop when ||z - v||_inf <= TOL and ||v - v_prev||_inf <= TOL
 */
#include "{name}.h"
#include <math.h>
#include <string.h>
#include <time.h>

{data}

int {name}_solve(const double *x0_in, const double *xr_in, const double *ur_in,
                 double *u_opt, int *k_out, double *z_out, double *v_out,
                 double *lam_out, double *times_ms)
{{
    struct timespec ts0, ts1, ts2, ts3;
    clock_gettime(CLOCK_MONOTONIC_RAW, &ts0);
{eng_in}
    double q[NZ];
    double b0[NS];
    double z[NZ];
    double v[NZ];
    double v1[NZ];
    double lam[NZ];
    double q_hat[NZ];
    double h0[MS];
    double hm[HORIZ - 1][NM];
    double rhs[HORIZ][NS];
    double yfw[HORIZ][NS];
    double mu[HORIZ][NS];
{terminal_decls}
    memset(v, 0, sizeof(v));
    memset(lam, 0, sizeof(lam));
    memset(v1, 0, sizeof(v1));

    /* ---- linear cost from the references ---- */
    for (int j = 0; j < MS; j++) q[j] = -RD[j] * ur[j];
    for (int l = 0; l < HORIZ - 1; l++) {{
        for (int j = 0; j < NS; j++)
            q[MS + l * NM + j] = -QD[j] * xr[j];
        for (int j = 0; j < MS; j++)
            q[MS + l * NM + NS + j] = -RD[j] * ur[j];
    }}
{terminal_q}
    /* ---- equality RHS pieces ---- */
    for (int i = 0; i < NS; i++) {{
        b0[i] = 0.0;
        for (int j = 0; j < NS; j++) b0[i] -= AMAT[i][j] * x0[j];
    }}

    clock_gettime(CLOCK_MONOTONIC_RAW, &ts1);

    int k = 0;
    int e_flag = 0;
    while (e_flag == 0) {{
        k++;

        /* q_hat and the diagonal Hinv products */
{qhat_code}
        for (int j = 0; j < MS; j++) h0[j] = HI0[j] * q_hat[j];
        for (int l = 0; l < HORIZ - 1; l++)
            for (int j = 0; j < NM; j++)
                hm[l][j] = HIM[l][j] * q_hat[MS + l * NM + j];
{terminal_hn}
        /* rhs = -G Hinv q_hat - beq, blockwise */
        for (int i = 0; i < NS; i++) {{
            double acc = hm[0][i] - b0[i];
            for (int j = 0; j < MS; j++) acc -= BMAT[i][j] * h0[j];
            rhs[0][i] = acc;
        }}
        for (int l = 1; l < HORIZ - 1; l++)
            for (int i = 0; i < NS; i++) {{
                double acc = hm[l][i];
                for (int j = 0; j < NM; j++) acc -= ABMAT[i][j] * hm[l - 1][j];
                rhs[l][i] = acc;
            }}
{terminal_rhs}
        /* forward substitution: y_l = (rhs_l - y_(l-1) Alpha_(l-1)) BetaInv_l
         * (row-vector convention; BetaInv = inverse of chol(W) diag block) */
        for (int i = 0; i < NS; i++) {{
            double acc = 0.0;
            for (int j = 0; j < NS; j++) acc += rhs[0][j] * BETAINV[0][j][i];
            yfw[0][i] = acc;
        }}
        for (int l = 1; l < HORIZ; l++) {{
            double tmp[NS];
            for (int i = 0; i < NS; i++) {{
                double acc = rhs[l][i];
                for (int j = 0; j < NS; j++)
                    acc -= yfw[l - 1][j] * ALPHA[l - 1][j][i];
                tmp[i] = acc;
            }}
            for (int i = 0; i < NS; i++) {{
                double acc = 0.0;
                for (int j = 0; j < NS; j++) acc += tmp[j] * BETAINV[l][j][i];
                yfw[l][i] = acc;
            }}
        }}

        /* backward substitution: mu_l = (y_l - mu_(l+1) Alpha_l^T) BetaInv_l^T */
        for (int i = 0; i < NS; i++) {{
            double acc = 0.0;
            for (int j = 0; j < NS; j++)
                acc += yfw[HORIZ - 1][j] * BETAINV[HORIZ - 1][i][j];
            mu[HORIZ - 1][i] = acc;
        }}
        for (int l = HORIZ - 2; l >= 0; l--) {{
            double tmp[NS];
            for (int i = 0; i < NS; i++) {{
                double acc = yfw[l][i];
                for (int j = 0; j < NS; j++)
                    acc -= mu[l + 1][j] * ALPHA[l][i][j];
                tmp[i] = acc;
            }}
            for (int i = 0; i < NS; i++) {{
                double acc = 0.0;
                for (int j = 0; j < NS; j++) acc += tmp[j] * BETAINV[l][i][j];
                mu[l][i] = acc;
            }}
        }}

        /* z = -Hinv (q_hat + G' mu) */
        for (int j = 0; j < MS; j++) {{
            double acc = q_hat[j];
            for (int i = 0; i < NS; i++) acc += BMAT[i][j] * mu[0][i];
            z[j] = -HI0[j] * acc;
        }}
        /* stage block l holds (x_(l+1), u_(l+1)): G' adds [A B]^T mu_(l+1)
         * and -mu_l on the x part */
        for (int l = 0; l < HORIZ - 1; l++) {{
            for (int j = 0; j < NM; j++) {{
                double acc = q_hat[MS + l * NM + j];
                if (j < NS) acc -= mu[l][j];
                for (int i = 0; i < NS; i++)
                    acc += ABMAT[i][j] * mu[l + 1][i];
                z[MS + l * NM + j] = -HIM[l][j] * acc;
            }}
        }}
{terminal_z}
        /* v-update (projection) + dual + residuals */
        double r_p = 0.0, r_d = 0.0;
{proj_code}
        if (r_p <= TOL && r_d <= TOL) e_flag = 1;
        else if (k >= KMAX) e_flag = -1;
        memcpy(v1, v, sizeof(v));
    }}

    clock_gettime(CLOCK_MONOTONIC_RAW, &ts2);
{u_out}    *k_out = k;
    if (z_out) memcpy(z_out, z, sizeof(z));
    if (v_out) memcpy(v_out, v, sizeof(v));
    if (lam_out) memcpy(lam_out, lam, sizeof(lam));
    clock_gettime(CLOCK_MONOTONIC_RAW, &ts3);
    if (times_ms) {{
        times_ms[0] = 1e3 * (ts1.tv_sec - ts0.tv_sec)
                      + 1e-6 * (ts1.tv_nsec - ts0.tv_nsec);  /* update */
        times_ms[1] = 1e3 * (ts2.tv_sec - ts1.tv_sec)
                      + 1e-6 * (ts2.tv_nsec - ts1.tv_nsec);  /* solve */
        times_ms[2] = 1e3 * (ts3.tv_sec - ts2.tv_sec)
                      + 1e-6 * (ts3.tv_nsec - ts2.tv_nsec);  /* polish */
        times_ms[3] = 1e3 * (ts3.tv_sec - ts0.tv_sec)
                      + 1e-6 * (ts3.tv_nsec - ts0.tv_nsec);  /* run */
    }}
    return e_flag;
}}
"""


# default iteration slots: q_hat = q + lam - rho v and a box projection over
# the whole decision vector (laxMPC/equMPC; code_laxMPC_ADMM_C.c:313-568)
_QHAT_BOX = ("        for (int i = 0; i < NZ; i++) "
             "q_hat[i] = q[i] + lam[i] - RHO * v[i];\n")

_PROJ_BOX = r"""        for (int i = 0; i < NZ; i++) {
            double y = z[i] + RHO_I * lam[i];
            double vi = y < LBZ[i] ? LBZ[i] : (y > UBZ[i] ? UBZ[i] : y);
            double dp = z[i] - vi;
            double dd = vi - v1[i];
            if (fabs(dp) > r_p) r_p = fabs(dp);
            if (fabs(dd) > r_d) r_d = fabs(dd);
            lam[i] += RHO * dp;
            v[i] = vi;
        }
"""

# vector-rho variants (the reference's non-SCALAR_RHO path,
# cons_laxMPC_ADMM_C.m:119-130): RHOV/RHOIV baked per-entry vectors
_QHAT_BOX_VEC = ("        for (int i = 0; i < NZ; i++) "
                 "q_hat[i] = q[i] + lam[i] - RHOV[i] * v[i];\n")

_PROJ_BOX_VEC = r"""        for (int i = 0; i < NZ; i++) {
            double y = z[i] + RHOIV[i] * lam[i];
            double vi = y < LBZ[i] ? LBZ[i] : (y > UBZ[i] ? UBZ[i] : y);
            double dp = z[i] - vi;
            double dd = vi - v1[i];
            if (fabs(dp) > r_p) r_p = fabs(dp);
            if (fabs(dd) > r_d) r_d = fabs(dd);
            lam[i] += RHOV[i] * dp;
            v[i] = vi;
        }
"""

# engineering-units slots (code_laxMPC_ADMM_C.c:82-115, :642-651):
# inputs arrive in engineering units, scaled to incremental before the
# solve; the control move is de-scaled on output
_ENG_IN_OFF = ("    const double *x0 = x0_in;\n"
               "    const double *xr = xr_in;\n"
               "    const double *ur = ur_in;\n")

_ENG_IN_ON = r"""    double x0b[NS], xrb[NS], urb[MS];
    for (int j = 0; j < NS; j++) {
        x0b[j] = NXV[j] * (x0_in[j] - OPX[j]);
        xrb[j] = NXV[j] * (xr_in[j] - OPX[j]);
    }
    for (int j = 0; j < MS; j++)
        urb[j] = NUV[j] * (ur_in[j] - OPU[j]);
    const double *x0 = x0b;
    const double *xr = xrb;
    const double *ur = urb;
"""

_U_OUT_OFF = "    for (int j = 0; j < MS; j++) u_opt[j] = v[j];\n"
_U_OUT_ON = ("    for (int j = 0; j < MS; j++) "
             "u_opt[j] = v[j] / NUV[j] + OPU[j];\n")


def _eng_c_arrays(sys, n, m):
    """Engineering-units constants (reference Nx/Nu/x0/u0 sys fields,
    +sp_utils/scale_ss.m): the scaling vectors and operating point baked
    into every generated solver when in_engineering is on (the reference
    does this in every formulation, e.g. cons_MPCT_EADMM_C.m:109,
    code_HMPC_ADMM_C.c scaling blocks)."""
    return [
        c_array("NXV", np.asarray(sys.get("Nx", np.ones(n)), float).ravel()),
        c_array("NUV", np.asarray(sys.get("Nu", np.ones(m)), float).ravel()),
        c_array("OPX", np.asarray(sys.get("x0", np.zeros(n)), float).ravel()),
        c_array("OPU", np.asarray(sys.get("u0", np.zeros(m)), float).ravel()),
    ]


def _apply_engineering(src: str,
                       inputs=(("x0", "x"), ("xr", "x"), ("ur", "u"))):
    """Post-process a generated solver source for in_engineering mode:
    rename the reference-unit inputs to *_in in the signature, insert the
    scale-to-incremental prologue (code_laxMPC_ADMM_C.c:82-99 pattern),
    and de-scale the control move on output (:642-651). Works on any of
    the family templates because they all share the `const double *<nm>`
    parameter style and a single `u_opt[j] = <expr>;` write."""
    import re
    for nm, _kind in inputs:
        src = src.replace(f"const double *{nm},", f"const double *{nm}_in,", 1)
        src = src.replace(f"const double *{nm})", f"const double *{nm}_in)", 1)
    lines = []
    for nm, kind in inputs:
        # 'xa'/'ua' = sinusoid amplitudes: scale, no operating-point
        # offset (see BatchedSolver input_kinds)
        dim = "NS" if kind in ("x", "xa") else "MS"
        vec, op = (("NXV", "OPX") if kind in ("x", "xa")
                   else ("NUV", "OPU"))
        expr = (f"{vec}[j] * ({nm}_in[j] - {op}[j])"
                if kind in ("x", "u") else f"{vec}[j] * {nm}_in[j]")
        lines.append(
            f"    double {nm}b[{dim}];\n"
            f"    for (int j = 0; j < {dim}; j++) "
            f"{nm}b[j] = {expr};\n"
            f"    const double *{nm} = {nm}b;\n")
    prologue = "".join(lines)
    src, nsub = re.subn(r"(int \w+_solve\([^)]*\)\n\{\n)",
                        lambda mo: mo.group(1) + prologue, src, count=1)
    assert nsub == 1, "engineering prologue insertion point not found"
    src, nsub = re.subn(r"u_opt\[j\] = ([^;]+);",
                        r"u_opt[j] = (\1) / NUV[j] + OPU[j];", src, count=1)
    assert nsub == 1, "u_opt de-scale point not found"
    return src

# ellipMPC slots: the terminal block's penalty is rho*P, so q_hat mixes
# P_half/P into the last n rows (code_ellipMPC_ADMM_C.c:150-152), the
# v-update is an exact P-norm ellipsoid projection (:321-351), and the
# terminal dual step is scaled by P_half (spcies_ellipMPC_ADMM_solver.m).
_QHAT_ELLIP = r"""        for (int i = 0; i < NZ - NS; i++)
            q_hat[i] = q[i] + lam[i] - RHO * v[i];
        for (int j = 0; j < NS; j++) {
            double acc = q[NZ - NS + j];
            for (int i = 0; i < NS; i++)
                acc += PHALF[j][i] * lam[NZ - NS + i]
                       - RHO * PMAT[j][i] * v[NZ - NS + i];
            q_hat[NZ - NS + j] = acc;
        }
"""

_PROJ_ELLIP = r"""        for (int i = 0; i < NZ - NS; i++) {
            double y = z[i] + RHO_I * lam[i];
            double vi = y < LBZ[i] ? LBZ[i] : (y > UBZ[i] ? UBZ[i] : y);
            double dp = z[i] - vi;
            double dd = vi - v1[i];
            if (fabs(dp) > r_p) r_p = fabs(dp);
            if (fabs(dd) > r_d) r_d = fabs(dd);
            lam[i] += RHO * dp;
            v[i] = vi;
        }
        {
            double yT[NS], dT[NS], zmv[NS];
            double vPv = 0.0;
            for (int j = 0; j < NS; j++) {
                double acc = z[NZ - NS + j];
                for (int i = 0; i < NS; i++)
                    acc += RHO_I * PINVHALF[j][i] * lam[NZ - NS + i];
                yT[j] = acc;
                dT[j] = acc - CVEC[j];
            }
            for (int j = 0; j < NS; j++) {
                double acc = 0.0;
                for (int i = 0; i < NS; i++) acc += PMAT[j][i] * dT[i];
                vPv += dT[j] * acc;
            }
            double scale = vPv > RADIUS * RADIUS ? RADIUS / sqrt(vPv) : 1.0;
            for (int j = 0; j < NS; j++) {
                double vi = CVEC[j] + scale * dT[j];
                double dp = z[NZ - NS + j] - vi;
                double dd = vi - v1[NZ - NS + j];
                if (fabs(dp) > r_p) r_p = fabs(dp);
                if (fabs(dd) > r_d) r_d = fabs(dd);
                v[NZ - NS + j] = vi;
                zmv[j] = dp;
            }
            for (int j = 0; j < NS; j++) {
                double acc = 0.0;
                for (int i = 0; i < NS; i++) acc += PHALF[j][i] * zmv[i];
                lam[NZ - NS + j] += RHO * acc;
            }
        }
"""


# vector-rho ellipMPC variants (reference non-SCALAR_RHO path,
# cons_ellipMPC_ADMM_C.m SCALAR_RHO block): per-entry RHOV on the stage
# rows, scalar RHO_T on the P-weighted terminal block (the ingredient
# well-formedness rule: the last n rho entries must be equal, see
# ellipmpc_admm_ingredients)
_QHAT_ELLIP_VEC = (_QHAT_ELLIP
                   .replace("q_hat[i] = q[i] + lam[i] - RHO * v[i];",
                            "q_hat[i] = q[i] + lam[i] - RHOV[i] * v[i];")
                   .replace("RHO * PMAT", "RHO_T * PMAT"))
_PROJ_ELLIP_VEC = (_PROJ_ELLIP
                   .replace("RHO_I * lam[i]", "RHOIV[i] * lam[i]")
                   .replace("lam[i] += RHO * dp;",
                            "lam[i] += RHOV[i] * dp;")
                   .replace("RHO_I * PINVHALF", "RHO_TI * PINVHALF")
                   .replace("lam[NZ - NS + j] += RHO * acc;",
                            "lam[NZ - NS + j] += RHO_T * acc;"))


def _laxmpc_terminal_parts(name):
    decls = "    double hN[NS];\n"
    q = ("    for (int j = 0; j < NS; j++) {\n"
         "        double acc = 0.0;\n"
         "        for (int i = 0; i < NS; i++) acc += TMAT[j][i] * xr[i];\n"
         "        q[NZ - NS + j] = -acc;\n    }\n")
    hn = ("        for (int i = 0; i < NS; i++) {\n"
          "            double acc = 0.0;\n"
          "            for (int j = 0; j < NS; j++)\n"
          "                acc += HIN[i][j] * q_hat[NZ - NS + j];\n"
          "            hN[i] = acc;\n        }\n")
    rhs = ("        for (int i = 0; i < NS; i++) {\n"
           "            double acc = hN[i];\n"
           "            for (int j = 0; j < NM; j++)\n"
           "                acc -= ABMAT[i][j] * hm[HORIZ - 2][j];\n"
           "            rhs[HORIZ - 1][i] = acc;\n        }\n")
    z = ("        for (int i = 0; i < NS; i++) {\n"
         "            double acc = 0.0;\n"
         "            for (int j = 0; j < NS; j++)\n"
         "                acc += HIN[i][j] * (q_hat[NZ - NS + j]"
         " - mu[HORIZ - 1][j]);\n"
         "            z[NZ - NS + i] = -acc;\n        }\n")
    return decls, q, hn, rhs, z


def _equmpc_terminal_parts(name):
    decls = ""
    q = ""
    hn = ""
    rhs = ("        for (int i = 0; i < NS; i++) {\n"
           "            double acc = -xr[i];\n"
           "            for (int j = 0; j < NM; j++)\n"
           "                acc -= ABMAT[i][j] * hm[HORIZ - 2][j];\n"
           "            rhs[HORIZ - 1][i] = acc;\n        }\n")
    z = ""
    return decls, q, hn, rhs, z


def generate_c_solver(sys: dict, param: dict, *, formulation: str,
                      options: Options | None = None,
                      save_name: str | None = None,
                      directory: str = GENERATED_DIR,
                      compile: bool = True,
                      **solver_overrides) -> str:
    """Generate (and by default compile) a standalone C solver.

    Supported: laxMPC/ADMM, equMPC/ADMM and ellipMPC/ADMM, each with
    scalar or vector rho and optional in_engineering scaling (the
    reference's SCALAR_RHO and in_engineering axes,
    cons_laxMPC_ADMM_C.m:90-130, cons_ellipMPC_ADMM_C.m).
    Returns the path to the generated .c file; the shared library lands
    next to it.
    """
    ellip = False
    if formulation == "laxMPC":
        from spcies_tpu_torch.formulations.laxmpc import (
            laxmpc_admm_ingredients)
        ingredients_fn = laxmpc_admm_ingredients
        terminal = True
    elif formulation == "equMPC":
        from spcies_tpu_torch.formulations.equmpc import (
            equmpc_admm_ingredients)
        ingredients_fn = equmpc_admm_ingredients
        terminal = False
    elif formulation == "ellipMPC":
        from spcies_tpu_torch.formulations.ellipmpc import (
            ellipmpc_admm_ingredients)
        ingredients_fn = ellipmpc_admm_ingredients
        terminal = True
        ellip = True
    else:
        raise NotImplementedError(
            f"C generation currently supports laxMPC/equMPC/ellipMPC ADMM, "
            f"not {formulation!r}")
    opt = options or default_options(formulation, "ADMM",
                                     **solver_overrides)
    ing = ingredients_fn(sys, param, opt)
    rho_is_scalar = ing.get("rho_is_scalar", True)
    in_eng = bool(opt.in_engineering)

    from spcies_tpu_torch.kernels.band_chol import beta_inverses
    Alpha, BetaInv = beta_inverses(ing["Alpha"], ing["Beta"])

    n, m, N, nz = ing["n"], ing["m"], ing["N"], ing["nz"]
    name = save_name or f"{formulation.lower()}_admm"
    name = _unused_name(name, directory, opt)

    defs = {
        "HORIZ": N, "NS": n, "MS": m, "NM": n + m, "NZ": nz,
        "KMAX": int(opt.solver["k_max"]),
        "HAS_TERMINAL": 1 if terminal else 0,
    }
    data = []
    data.append("".join(c_define(k, v) for k, v in defs.items()))
    data.append(c_define("TOL", float(opt.solver["tol"])))
    if rho_is_scalar:
        rho_scalar = float(ing["rho_scalar"] if "rho_scalar" in ing
                           else ing["rho"])
        data.append(c_define("RHO", rho_scalar))
        data.append(c_define("RHO_I", 1.0 / rho_scalar))
    elif ellip:
        # stage rows per-entry, terminal block scalar (rho_T): the
        # vector-rho split the dense engine uses (build_ellipmpc_admm)
        rho_s = np.asarray(ing["rho_s"], float)
        data.append(c_array("RHOV", rho_s))
        data.append(c_array("RHOIV", 1.0 / rho_s))
        data.append(c_define("RHO_T", float(ing["rho_T"])))
        data.append(c_define("RHO_TI", 1.0 / float(ing["rho_T"])))
    else:
        data.append(c_array("RHOV", ing["rho_vec"]))
        data.append(c_array("RHOIV", ing["rho_inv_vec"]))
    if in_eng:
        data += _eng_c_arrays(sys, n, m)
    data.append(c_array("AMAT", ing["A"]))
    data.append(c_array("BMAT", ing["B"]))
    data.append(c_array("ABMAT", ing["AB"]))
    data.append(c_array("QD", ing["Qd"]))
    data.append(c_array("RD", ing["Rd"]))
    data.append(c_array("HI0", ing["Hi_0"]))
    data.append(c_array("HIM", ing["Hi_mid"]))
    if terminal:
        data.append(c_array("TMAT", ing["T"]))
        data.append(c_array("HIN", ing["Hi_N"]))
    data.append(c_array("ALPHA", Alpha))
    data.append(c_array("BETAINV", BetaInv))
    data.append(c_array("LBZ", ing["LB_z"] if "LB_z" in ing else ing["LB"]))
    data.append(c_array("UBZ", ing["UB_z"] if "UB_z" in ing else ing["UB"]))
    if ellip:
        data.append(c_define("RADIUS", float(ing["r"])))
        data.append(c_array("PMAT", ing["P"]))
        data.append(c_array("PHALF", ing["P_half"]))
        data.append(c_array("PINVHALF", ing["Pinv_half"]))
        data.append(c_array("CVEC", ing["c"]))

    parts = (_laxmpc_terminal_parts(name) if terminal
             else _equmpc_terminal_parts(name))
    decls, term_q, term_hn, term_rhs, term_z = parts

    if ellip:
        qhat, proj = ((_QHAT_ELLIP, _PROJ_ELLIP) if rho_is_scalar
                      else (_QHAT_ELLIP_VEC, _PROJ_ELLIP_VEC))
    elif rho_is_scalar:
        qhat, proj = _QHAT_BOX, _PROJ_BOX
    else:
        qhat, proj = _QHAT_BOX_VEC, _PROJ_BOX_VEC
    src = _SOLVER_TEMPLATE.format(
        name=name, data="\n".join(data), terminal_decls=decls,
        terminal_q=term_q, terminal_hn=term_hn, terminal_rhs=term_rhs,
        terminal_z=term_z, qhat_code=qhat, proj_code=proj,
        eng_in=_ENG_IN_ON if in_eng else _ENG_IN_OFF,
        u_out=_U_OUT_ON if in_eng else _U_OUT_OFF)
    header = (f"#ifndef {name.upper()}_H\n#define {name.upper()}_H\n"
              f"int {name}_solve(const double *x0, const double *xr, "
              f"const double *ur,\n"
              f"                 double *u_opt, int *k_out, double *z_out, "
              f"double *v_out,\n"
              f"                 double *lam_out, double *times_ms);\n"
              f"#endif\n")
    src = _finalize_src(src, opt)
    if opt.precision == "float":
        # single-precision build (Spcies_options.m:66 precision map)
        src = src.replace("double", "float")
        header = header.replace("double", "float")
    os.makedirs(directory, exist_ok=True)
    c_path = os.path.join(directory, f"{name}.c")
    with open(c_path, "w") as f:
        f.write(src)
    with open(os.path.join(directory, f"{name}.h"), "w") as f:
        f.write(header)

    if compile:
        lib = os.path.join(directory, f"lib{name}.so")
        # the MEX-compile analogue (+sp_utils/get_generic_mex_exec.m)
        cmd = ["cc", "-O3", "-shared", "-fPIC", f"-I{directory}",
               "-o", lib, c_path, "-lm"]
        subprocess.run(cmd, check=True, capture_output=True)
    return c_path


_FISTA_TEMPLATE = r"""
/* {name} — generated by spcies_tpu (laxMPC/equMPC family, dual FISTA).
 * Self-contained, allocation-free; problem data baked below.
 * Iteration (matches the spcies_tpu FISTA engine):
 *   warm start: z = clip(-Hinv q); y = W^-1 (b - G z); lam = y; t = 1
 *   loop: z = clip(-Hinv (q - G' y)); r = b - G z
 *         exit if ||r||_inf <= TOL
 *         lam' = y + W^-1 r; t' = (1+sqrt(1+4t^2))/2
 *         y = lam' + ((t-1)/t') (lam' - lam)
 */
#include "{name}.h"
#include <math.h>
#include <string.h>
#include <time.h>

{data}

static void band_solve(const double rhs[HORIZ][NS], double mu[HORIZ][NS])
{{
    double yfw[HORIZ][NS];
    double tmp[NS];
    for (int i = 0; i < NS; i++) {{
        double acc = 0.0;
        for (int j = 0; j < NS; j++) acc += rhs[0][j] * BETAINV[0][j][i];
        yfw[0][i] = acc;
    }}
    for (int l = 1; l < HORIZ; l++) {{
        for (int i = 0; i < NS; i++) {{
            double acc = rhs[l][i];
            for (int j = 0; j < NS; j++)
                acc -= yfw[l - 1][j] * ALPHA[l - 1][j][i];
            tmp[i] = acc;
        }}
        for (int i = 0; i < NS; i++) {{
            double acc = 0.0;
            for (int j = 0; j < NS; j++) acc += tmp[j] * BETAINV[l][j][i];
            yfw[l][i] = acc;
        }}
    }}
    for (int i = 0; i < NS; i++) {{
        double acc = 0.0;
        for (int j = 0; j < NS; j++)
            acc += yfw[HORIZ - 1][j] * BETAINV[HORIZ - 1][i][j];
        mu[HORIZ - 1][i] = acc;
    }}
    for (int l = HORIZ - 2; l >= 0; l--) {{
        for (int i = 0; i < NS; i++) {{
            double acc = yfw[l][i];
            for (int j = 0; j < NS; j++)
                acc -= mu[l + 1][j] * ALPHA[l][i][j];
            tmp[i] = acc;
        }}
        for (int i = 0; i < NS; i++) {{
            double acc = 0.0;
            for (int j = 0; j < NS; j++) acc += tmp[j] * BETAINV[l][i][j];
            mu[l][i] = acc;
        }}
    }}
}}

/* z = clip(-Hinv (q - G' y)) */
static void z_from_y(const double q[NZ], const double y[HORIZ][NS],
                     double z[NZ])
{{
    for (int j = 0; j < MS; j++) {{
        double acc = q[j];
        for (int i = 0; i < NS; i++) acc -= BMAT[i][j] * y[0][i];
        z[j] = -HINV[j] * acc;
    }}
    for (int l = 0; l < HORIZ - 1; l++)
        for (int j = 0; j < NM; j++) {{
            double acc = q[MS + l * NM + j];
            if (j < NS) acc += y[l][j];
            for (int i = 0; i < NS; i++) acc -= ABMAT[i][j] * y[l + 1][i];
            z[MS + l * NM + j] = -HINV[MS + l * NM + j] * acc;
        }}
{terminal_z}
    for (int i = 0; i < NZ; i++) {{
        if (z[i] < LBZ[i]) z[i] = LBZ[i];
        if (z[i] > UBZ[i]) z[i] = UBZ[i];
    }}
}}

/* r = b - G z */
static void resid(const double z[NZ], const double b[HORIZ][NS],
                  double r[HORIZ][NS])
{{
    for (int i = 0; i < NS; i++) {{
        double acc = b[0][i] + z[MS + i];
        for (int j = 0; j < MS; j++) acc -= BMAT[i][j] * z[j];
        r[0][i] = acc;
    }}
    for (int l = 1; l < HORIZ - 1; l++)
        for (int i = 0; i < NS; i++) {{
            double acc = b[l][i] + z[MS + l * NM + i];
            for (int j = 0; j < NM; j++)
                acc -= ABMAT[i][j] * z[MS + (l - 1) * NM + j];
            r[l][i] = acc;
        }}
{terminal_r}
}}

int {name}_solve(const double *x0, const double *xr, const double *ur,
                 double *u_opt, int *k_out, double *z_out, double *lam_out,
                 double *times_ms)
{{
    struct timespec ts0, ts1, ts2, ts3;
    clock_gettime(CLOCK_MONOTONIC_RAW, &ts0);

    double q[NZ];
    double b[HORIZ][NS];
    double z[NZ];
    double y[HORIZ][NS];
    double lam[HORIZ][NS];
    double lam_new[HORIZ][NS];
    double r[HORIZ][NS];
    double dlam[HORIZ][NS];
    double t = 1.0;

    for (int j = 0; j < MS; j++) q[j] = -RD[j] * ur[j];
    for (int l = 0; l < HORIZ - 1; l++) {{
        for (int j = 0; j < NS; j++)
            q[MS + l * NM + j] = -QD[j] * xr[j];
        for (int j = 0; j < MS; j++)
            q[MS + l * NM + NS + j] = -RD[j] * ur[j];
    }}
{terminal_q}
    memset(b, 0, sizeof(b));
    for (int i = 0; i < NS; i++)
        for (int j = 0; j < NS; j++) b[0][i] -= AMAT[i][j] * x0[j];
{terminal_b}
    clock_gettime(CLOCK_MONOTONIC_RAW, &ts1);

    /* warm-start gradient step (k = 0) */
    memset(lam, 0, sizeof(lam));
    z_from_y(q, lam, z);
    resid(z, b, r);
    band_solve(r, dlam);
    for (int l = 0; l < HORIZ; l++)
        for (int i = 0; i < NS; i++) {{
            y[l][i] = dlam[l][i];
            lam[l][i] = y[l][i];
        }}

    int k = 0;
    int e_flag = 0;
    while (e_flag == 0) {{
        k++;
        z_from_y(q, y, z);
        resid(z, b, r);
        double res = 0.0;
        for (int l = 0; l < HORIZ; l++)
            for (int i = 0; i < NS; i++)
                if (fabs(r[l][i]) > res) res = fabs(r[l][i]);
        if (res <= TOL) {{ e_flag = 1; break; }}
        if (k >= KMAX) {{ e_flag = -1; break; }}
        band_solve(r, dlam);
        double t_new = 0.5 * (1.0 + sqrt(1.0 + 4.0 * t * t));
        double coef = (t - 1.0) / t_new;
        for (int l = 0; l < HORIZ; l++)
            for (int i = 0; i < NS; i++) {{
                lam_new[l][i] = y[l][i] + dlam[l][i];
                y[l][i] = lam_new[l][i] + coef * (lam_new[l][i] - lam[l][i]);
                lam[l][i] = lam_new[l][i];
            }}
        t = t_new;
    }}

    clock_gettime(CLOCK_MONOTONIC_RAW, &ts2);
    for (int j = 0; j < MS; j++) u_opt[j] = z[j];
    *k_out = k;
    if (z_out) memcpy(z_out, z, sizeof(z));
    if (lam_out) memcpy(lam_out, y, sizeof(y));
    clock_gettime(CLOCK_MONOTONIC_RAW, &ts3);
    if (times_ms) {{
        times_ms[0] = 1e3 * (ts1.tv_sec - ts0.tv_sec)
                      + 1e-6 * (ts1.tv_nsec - ts0.tv_nsec);  /* update */
        times_ms[1] = 1e3 * (ts2.tv_sec - ts1.tv_sec)
                      + 1e-6 * (ts2.tv_nsec - ts1.tv_nsec);  /* solve */
        times_ms[2] = 1e3 * (ts3.tv_sec - ts2.tv_sec)
                      + 1e-6 * (ts3.tv_nsec - ts2.tv_nsec);  /* polish */
        times_ms[3] = 1e3 * (ts3.tv_sec - ts0.tv_sec)
                      + 1e-6 * (ts3.tv_nsec - ts0.tv_nsec);  /* run */
    }}
    return e_flag;
}}
"""


def generate_c_fista_solver(sys: dict, param: dict, *, formulation: str,
                            options: Options | None = None,
                            save_name: str | None = None,
                            directory: str = GENERATED_DIR,
                            compile: bool = True,
                            **solver_overrides) -> str:
    """Generate (and compile) a standalone dual-FISTA C solver for
    laxMPC (terminal cost, diagonal T) or equMPC (terminal equality)."""
    if formulation == "laxMPC":
        from spcies_tpu_torch.formulations.laxmpc import (
            laxmpc_fista_ingredients)
        ing = laxmpc_fista_ingredients(
            sys, param, options or default_options(formulation, "FISTA",
                                                   **solver_overrides))
        terminal = True
    elif formulation == "equMPC":
        from spcies_tpu_torch.formulations.equmpc import (
            equmpc_fista_ingredients)
        ing = equmpc_fista_ingredients(
            sys, param, options or default_options(formulation, "FISTA",
                                                   **solver_overrides))
        terminal = False
    else:
        raise NotImplementedError(
            "FISTA C generation supports laxMPC/equMPC")
    opt = options or default_options(formulation, "FISTA",
                                     **solver_overrides)

    from spcies_tpu_torch.kernels.band_chol import beta_inverses
    Alpha, BetaInv = beta_inverses(ing["Alpha"], ing["Beta"])
    n, m, N, nz = ing["n"], ing["m"], ing["N"], ing["nz"]
    name = save_name or f"{formulation.lower()}_fista"
    name = _unused_name(name, directory, opt)

    data = []
    data.append("".join(c_define(k, v) for k, v in {
        "HORIZ": N, "NS": n, "MS": m, "NM": n + m, "NZ": nz,
        "KMAX": int(opt.solver["k_max"])}.items()))
    data.append(c_define("TOL", float(opt.solver["tol"])))
    data.append(c_array("AMAT", ing["A"]))
    data.append(c_array("BMAT", ing["B"]))
    data.append(c_array("ABMAT", ing["AB"]))
    data.append(c_array("QD", ing["Qd"]))
    data.append(c_array("RD", ing["Rd"]))
    data.append(c_array("HINV", ing["hinv_diag"]))
    if terminal:
        import numpy as _np
        data.append(c_array("TD", _np.diag(ing["T"])))
    data.append(c_array("ALPHA", Alpha))
    data.append(c_array("BETAINV", BetaInv))
    data.append(c_array("LBZ", ing["LB_z"]))
    data.append(c_array("UBZ", ing["UB_z"]))

    if terminal:
        term_z = ("    for (int i = 0; i < NS; i++)\n"
                  "        z[NZ - NS + i] = -HINV[NZ - NS + i]"
                  " * (q[NZ - NS + i] + y[HORIZ - 1][i]);\n")
        term_r = ("    for (int i = 0; i < NS; i++) {\n"
                  "        double acc = b[HORIZ - 1][i] + z[NZ - NS + i];\n"
                  "        for (int j = 0; j < NM; j++)\n"
                  "            acc -= ABMAT[i][j]"
                  " * z[MS + (HORIZ - 2) * NM + j];\n"
                  "        r[HORIZ - 1][i] = acc;\n    }\n")
        term_q = ("    for (int j = 0; j < NS; j++)\n"
                  "        q[NZ - NS + j] = -TD[j] * xr[j];\n")
        term_b = ""
    else:
        term_z = ""
        term_r = ("    for (int i = 0; i < NS; i++) {\n"
                  "        double acc = b[HORIZ - 1][i];\n"
                  "        for (int j = 0; j < NM; j++)\n"
                  "            acc -= ABMAT[i][j]"
                  " * z[MS + (HORIZ - 2) * NM + j];\n"
                  "        r[HORIZ - 1][i] = acc;\n    }\n")
        term_q = ""
        term_b = ("    for (int i = 0; i < NS; i++)"
                  " b[HORIZ - 1][i] = xr[i];\n")

    if opt.in_engineering:
        data += _eng_c_arrays(sys, n, m)
    src = _FISTA_TEMPLATE.format(name=name, data="\n".join(data),
                                 terminal_z=term_z, terminal_r=term_r,
                                 terminal_q=term_q, terminal_b=term_b)
    if opt.in_engineering:
        src = _apply_engineering(src)
    header = (f"#ifndef {name.upper()}_H\n#define {name.upper()}_H\n"
              f"int {name}_solve(const double *x0, const double *xr, "
              f"const double *ur,\n"
              f"                 double *u_opt, int *k_out, double *z_out, "
              f"double *lam_out,\n"
              f"                 double *times_ms);\n#endif\n")

    src = _finalize_src(src, opt)
    if opt.precision == "float":
        # single-precision build (Spcies_options.m:66 precision map)
        src = src.replace("double", "float")
        header = header.replace("double", "float")
    os.makedirs(directory, exist_ok=True)
    c_path = os.path.join(directory, f"{name}.c")
    with open(c_path, "w") as f:
        f.write(src)
    with open(os.path.join(directory, f"{name}.h"), "w") as f:
        f.write(header)
    if compile:
        lib = os.path.join(directory, f"lib{name}.so")
        cmd = ["cc", "-O3", "-shared", "-fPIC", f"-I{directory}",
               "-o", lib, c_path, "-lm"]
        subprocess.run(cmd, check=True, capture_output=True)
    return c_path


_MPCT_EADMM_TEMPLATE = r"""
/* {name} — generated by spcies_tpu (MPCT tracking MPC, 3-block EADMM).
 * Self-contained, allocation-free; problem data baked below.
 * Iteration (matches the spcies_tpu EADMM engine / the reference's
 * code_MPCT_EADMM_C.c:85-459 structure, in this framework's dense-M3
 * representation):
 *   P1: z1 = clip(-H1inv * A1'(rho.*rows + lam))   rows with z1 = 0
 *   P2: z2 = W2 * (q2ref + A2'(rho.*rows + lam))   rows with z2 = 0
 *   P3: z3 = M3 * A3'(rho.*rows + lam)             rows with z3 = 0
 *   lam += rho .* (A1 z1 + A2 z2 + A3 z3 - b)
 *   stop when ||residual||_inf, ||z2-z2_old||_inf, ||z3-z3_old||_inf <= TOL
 * Constraint rows: head n (x_0 = x), middle (N+1)(n+m) coupling
 * (-z1 + z2 + z3 = 0), tail n+m (z2 = (x_N, u_N)).
 */
#include "{name}.h"
#include <math.h>
#include <string.h>
#include <time.h>

{data}

int {name}_solve(const double *x0, const double *xr, const double *ur,
                 double *u_opt, int *k_out, double *z1_out, double *z2_out,
                 double *z3_out, double *lam_out, double *times_ms)
{{
    struct timespec ts0, ts1, ts2, ts3;
    clock_gettime(CLOCK_MONOTONIC_RAW, &ts0);

    double z1[NZ1], z2[NMS], z3[NZ1], lam[NROW];
    double z2n[NMS], z3n[NZ1];
    double q1[NZ1], q2[NMS], q3[NZ1];
    double q2ref[NMS];
    double rows[NROW];

    memset(z1, 0, sizeof(z1));
    memset(z2, 0, sizeof(z2));
    memset(z3, 0, sizeof(z3));
    memset(lam, 0, sizeof(lam));

    for (int i = 0; i < NS; i++) {{
        double acc = 0.0;
        for (int j = 0; j < NS; j++) acc += TMAT[i][j] * xr[j];
        q2ref[i] = -acc;
    }}
    for (int i = 0; i < MS; i++) {{
        double acc = 0.0;
        for (int j = 0; j < MS; j++) acc += SMAT[i][j] * ur[j];
        q2ref[NS + i] = -acc;
    }}

    clock_gettime(CLOCK_MONOTONIC_RAW, &ts1);

    int k = 0;
    int e_flag = 0;
    while (e_flag == 0) {{
        k++;

        /* ---- P1: rows evaluated at z1 = 0 ---- */
        for (int i = 0; i < NS; i++) rows[i] = -x0[i];
        for (int l = 0; l <= HORIZ; l++)
            for (int j = 0; j < NM; j++)
                rows[NS + l * NM + j] = z2[j] + z3[l * NM + j];
        for (int j = 0; j < NM; j++) rows[NS + NZ1 + j] = z2[j];
        /* q1 = A1'(rho.*rows + lam): -mid, +head on block0 x, -tail on
         * block N */
        for (int i = 0; i < NZ1; i++)
            q1[i] = -(RHOV[NS + i] * rows[NS + i] + lam[NS + i]);
        for (int i = 0; i < NS; i++)
            q1[i] += RHOV[i] * rows[i] + lam[i];
        for (int j = 0; j < NM; j++)
            q1[HORIZ * NM + j] -= RHOV[NS + NZ1 + j] * rows[NS + NZ1 + j]
                                  + lam[NS + NZ1 + j];
        for (int i = 0; i < NZ1; i++) {{
            double y = -q1[i] * H1I[i];
            z1[i] = y < LBZ[i] ? LBZ[i] : (y > UBZ[i] ? UBZ[i] : y);
        }}

        /* ---- P2: rows at z2 = 0, b = 0 (A2 has no head support) ---- */
        for (int j = 0; j < NM; j++) {{
            double acc = q2ref[j];
            for (int l = 0; l <= HORIZ; l++) {{
                double mid = z3[l * NM + j] - z1[l * NM + j];
                acc += RHOV[NS + l * NM + j] * mid + lam[NS + l * NM + j];
            }}
            double tail = -z1[HORIZ * NM + j];
            acc += RHOV[NS + NZ1 + j] * tail + lam[NS + NZ1 + j];
            q2[j] = acc;
        }}
        for (int j = 0; j < NM; j++) {{
            double acc = 0.0;
            for (int i = 0; i < NM; i++) acc += W2[j][i] * q2[i];
            z2n[j] = acc;
        }}

        /* ---- P3: rows at z3 = 0, b = 0; A3' = mid rows ---- */
        for (int l = 0; l <= HORIZ; l++)
            for (int j = 0; j < NM; j++) {{
                int i = l * NM + j;
                double mid = z2n[j] - z1[i];
                q3[i] = RHOV[NS + i] * mid + lam[NS + i];
            }}
        for (int i = 0; i < NZ1; i++) {{
            double acc = 0.0;
            for (int j = 0; j < NZ1; j++) acc += M3[i][j] * q3[j];
            z3n[i] = acc;
        }}

        /* ---- residual rows + dual update ---- */
        double r_pf = 0.0, r_z2 = 0.0, r_z3 = 0.0;
        for (int i = 0; i < NS; i++) rows[i] = z1[i] - x0[i];
        for (int l = 0; l <= HORIZ; l++)
            for (int j = 0; j < NM; j++)
                rows[NS + l * NM + j] = -z1[l * NM + j] + z2n[j]
                                        + z3n[l * NM + j];
        for (int j = 0; j < NM; j++)
            rows[NS + NZ1 + j] = z2n[j] - z1[HORIZ * NM + j];
        for (int i = 0; i < NROW; i++) {{
            if (fabs(rows[i]) > r_pf) r_pf = fabs(rows[i]);
            lam[i] += RHOV[i] * rows[i];
        }}
        for (int j = 0; j < NM; j++)
            if (fabs(z2n[j] - z2[j]) > r_z2) r_z2 = fabs(z2n[j] - z2[j]);
        for (int i = 0; i < NZ1; i++)
            if (fabs(z3n[i] - z3[i]) > r_z3) r_z3 = fabs(z3n[i] - z3[i]);
        memcpy(z2, z2n, sizeof(z2));
        memcpy(z3, z3n, sizeof(z3));

        if (r_pf <= TOL && r_z2 <= TOL && r_z3 <= TOL) e_flag = 1;
        else if (k >= KMAX) e_flag = -1;
    }}

    clock_gettime(CLOCK_MONOTONIC_RAW, &ts2);
    for (int j = 0; j < MS; j++) u_opt[j] = z1[NS + j];
    *k_out = k;
    if (z1_out) memcpy(z1_out, z1, sizeof(z1));
    if (z2_out) memcpy(z2_out, z2, sizeof(z2));
    if (z3_out) memcpy(z3_out, z3, sizeof(z3));
    if (lam_out) memcpy(lam_out, lam, sizeof(lam));
    clock_gettime(CLOCK_MONOTONIC_RAW, &ts3);
    if (times_ms) {{
        times_ms[0] = 1e3 * (ts1.tv_sec - ts0.tv_sec)
                      + 1e-6 * (ts1.tv_nsec - ts0.tv_nsec);  /* update */
        times_ms[1] = 1e3 * (ts2.tv_sec - ts1.tv_sec)
                      + 1e-6 * (ts2.tv_nsec - ts1.tv_nsec);  /* solve */
        times_ms[2] = 1e3 * (ts3.tv_sec - ts2.tv_sec)
                      + 1e-6 * (ts3.tv_nsec - ts2.tv_nsec);  /* polish */
        times_ms[3] = 1e3 * (ts3.tv_sec - ts0.tv_sec)
                      + 1e-6 * (ts3.tv_nsec - ts0.tv_nsec);  /* run */
    }}
    return e_flag;
}}
"""


def generate_c_mpct_eadmm_solver(sys: dict, param: dict, *,
                                 options: Options | None = None,
                                 save_name: str | None = None,
                                 directory: str = GENERATED_DIR,
                                 compile: bool = True,
                                 **solver_overrides) -> str:
    """Generate (and compile) a standalone MPCT-EADMM C solver — the
    tracking-MPC analogue of the reference's code_MPCT_EADMM_C.c product,
    in this framework's dense W2/M3 representation (differential-tested
    against the dense engine, tests/test_torch_codegen_c.py)."""
    from spcies_tpu_torch.formulations.mpct import mpct_eadmm_ingredients
    opt = options or default_options("MPCT", "EADMM", **solver_overrides)
    ing = mpct_eadmm_ingredients(sys, param, opt)
    n, m, N = ing["n"], ing["m"], ing["N"]
    nm, nz1, nrow = ing["nm"], ing["nz1"], ing["nrow"]
    name = save_name or "mpct_eadmm"
    name = _unused_name(name, directory, opt)

    data = []
    data.append("".join(c_define(k, v) for k, v in {
        "HORIZ": N, "NS": n, "MS": m, "NM": nm, "NZ1": nz1,
        "NMS": nm, "NROW": nrow,
        "KMAX": int(opt.solver["k_max"])}.items()))
    data.append(c_define("TOL", float(opt.solver["tol"])))
    data.append(c_array("RHOV", ing["rho"]))
    data.append(c_array("H1I", ing["H1i"]))
    data.append(c_array("W2", ing["W2"]))
    data.append(c_array("M3", ing["M3"]))
    data.append(c_array("TMAT", ing["T"]))
    data.append(c_array("SMAT", ing["S"]))
    data.append(c_array("LBZ", ing["LB"]))
    data.append(c_array("UBZ", ing["UB"]))

    if opt.in_engineering:
        data += _eng_c_arrays(sys, n, m)
    src = _MPCT_EADMM_TEMPLATE.format(name=name, data="\n".join(data))
    if opt.in_engineering:
        src = _apply_engineering(src)
    header = (f"#ifndef {name.upper()}_H\n#define {name.upper()}_H\n"
              f"int {name}_solve(const double *x0, const double *xr, "
              f"const double *ur,\n"
              f"                 double *u_opt, int *k_out, double *z1_out, "
              f"double *z2_out,\n"
              f"                 double *z3_out, double *lam_out, "
              f"double *times_ms);\n#endif\n")

    src = _finalize_src(src, opt)
    if opt.precision == "float":
        # single-precision build (Spcies_options.m:66 precision map)
        src = src.replace("double", "float")
        header = header.replace("double", "float")
    os.makedirs(directory, exist_ok=True)
    c_path = os.path.join(directory, f"{name}.c")
    with open(c_path, "w") as f:
        f.write(src)
    with open(os.path.join(directory, f"{name}.h"), "w") as f:
        f.write(header)
    if compile:
        lib = os.path.join(directory, f"lib{name}.so")
        cmd = ["cc", "-O3", "-shared", "-fPIC", f"-I{directory}",
               "-o", lib, c_path, "-lm"]
        subprocess.run(cmd, check=True, capture_output=True)
    return c_path


_HMPC_TEMPLATE = r"""
/* {name} — generated by spcies_tpu (harmonic MPC, single-split ADMM).
 * Self-contained, allocation-free; problem data baked below.
 * Iteration (matches the spcies_tpu HMPC engine / reference
 * code_HMPC_ADMM_C.c, dense M1/M2 representation — the reference's own
 * NON_SPARSE path, compute_HMPC_ADMM_ingredients.m:252-257):
 *   z   = M1 (q + C'(rho (s - d) + lam)) + M2 b0
 *   y   = -(C z - d) - rho^-1 lam
 *   s   = proj(y): box on stage rows, SOC3 / diamond on harmonic cones
 *   lam += rho (C z - d + s)
 *   stop when ||C z - d + s||_inf <= TOLP and ||s - s_prev||_inf <= TOLD
 */
#include "{name}.h"
#include <math.h>
#include <string.h>
#include <time.h>

{data}

/* shifted-SOC projection of a 3-vector onto ||y1|| <= alpha*(y0 - d)
 * (snippets/proj_SOC3.c three-case form) */
static void proj_ssoc3(double *y, double alpha, double d)
{{
    double ny1 = sqrt(y[1] * y[1] + y[2] * y[2]);
    double corr = alpha * (y[0] - d);
    if (ny1 <= corr) return;
    if (ny1 <= -corr) {{ y[0] = d; y[1] = 0.0; y[2] = 0.0; return; }}
    double step = (corr + ny1) / (2.0 * ny1);
    y[0] = step * ny1 * alpha + d;
    y[1] *= step;
    y[2] *= step;
}}

int {name}_solve(const double *x0, const double *xr, const double *ur,
                 double *u_opt, int *k_out, double *z_out, double *s_out,
                 double *lam_out, double *times_ms)
{{
    struct timespec ts0, ts1, ts2, ts3;
    clock_gettime(CLOCK_MONOTONIC_RAW, &ts0);

    double q[DIM], q_hat[DIM], z[DIM], aux_b[DIM];
    double s[NSROWS], s1[NSROWS], lam[NSROWS], czd[NSROWS];
    double b0[NS];

    memset(s, 0, sizeof(s));
    memset(s1, 0, sizeof(s1));
    memset(lam, 0, sizeof(lam));

    /* q = -[0_ns; Te xr + Q x0; 0_n; Q x0; Se ur; 0_2m]
     * (code_HMPC_ADMM_C.c:92-101 linear cost incl. the fixed j=0 stage) */
    memset(q, 0, sizeof(q));
    for (int i = 0; i < NS; i++) {{
        double qte = 0.0, qx = 0.0;
        for (int j = 0; j < NS; j++) {{
            qte += TEMAT[i][j] * xr[j];
            qx += QMAT[i][j] * x0[j];
        }}
        q[NSTAGE + i] = -qte - qx;
        q[NSTAGE + 2 * NS + i] = -qx;
    }}
    for (int i = 0; i < MS; i++) {{
        double acc = 0.0;
        for (int j = 0; j < MS; j++) acc += SEMAT[i][j] * ur[j];
        q[NSTAGE + 3 * NS + i] = -acc;
    }}
    for (int i = 0; i < NS; i++) {{
        b0[i] = 0.0;
        for (int j = 0; j < NS; j++) b0[i] -= AMAT[i][j] * x0[j];
    }}
    for (int i = 0; i < DIM; i++) {{
        double acc = 0.0;
        for (int j = 0; j < NS; j++) acc += M2[i][j] * b0[j];
        aux_b[i] = acc;
    }}

    clock_gettime(CLOCK_MONOTONIC_RAW, &ts1);

    int k = 0;
    int e_flag = 0;
    while (e_flag == 0) {{
        k++;

        /* q_hat = q + C'(rho (s - d) + lam); z = M1 q_hat + aux_b */
        for (int i = 0; i < DIM; i++) {{
            double acc = q[i];
            for (int r = 0; r < NSROWS; r++)
                acc += CMAT[r][i] * (RHO * (s[r] - DVEC[r]) + lam[r]);
            q_hat[i] = acc;
        }}
        for (int i = 0; i < DIM; i++) {{
            double acc = aux_b[i];
            for (int j = 0; j < DIM; j++) acc += M1[i][j] * q_hat[j];
            z[i] = acc;
        }}

        /* s-update: project y = -(C z - d) - rho^-1 lam */
        for (int r = 0; r < NSROWS; r++) {{
            double acc = -DVEC[r];
            for (int i = 0; i < DIM; i++) acc += CMAT[r][i] * z[i];
            czd[r] = acc;
            s[r] = -acc - RHO_I * lam[r];
        }}
        for (int r = 0; r < NBOX; r++) {{
            if (s[r] < LBB[r]) s[r] = LBB[r];
            if (s[r] > UBB[r]) s[r] = UBB[r];
        }}
        for (int c = 0; c < NCONES; c++) {{
            double *y = &s[NBOX + 3 * c];
#if USE_SOC
            proj_ssoc3(y, 1.0, 0.0);
#else
            proj_ssoc3(y, 1.0, LBY[c]);
            proj_ssoc3(y, -1.0, UBY[c]);
#endif
        }}

        /* dual + residuals */
        double r_p = 0.0, r_d = 0.0;
        for (int r = 0; r < NSROWS; r++) {{
            double resid = czd[r] + s[r];
            lam[r] += RHO * resid;
            if (fabs(resid) > r_p) r_p = fabs(resid);
            double dd = s[r] - s1[r];
            if (fabs(dd) > r_d) r_d = fabs(dd);
        }}
        if (r_p <= TOLP && r_d <= TOLD) e_flag = 1;
        else if (k >= KMAX) e_flag = -1;
        memcpy(s1, s, sizeof(s));
    }}

    clock_gettime(CLOCK_MONOTONIC_RAW, &ts2);
    for (int j = 0; j < MS; j++) u_opt[j] = z[j];
    *k_out = k;
    if (z_out) memcpy(z_out, z, sizeof(z));
    if (s_out) memcpy(s_out, s, sizeof(s));
    if (lam_out) memcpy(lam_out, lam, sizeof(lam));
    clock_gettime(CLOCK_MONOTONIC_RAW, &ts3);
    if (times_ms) {{
        times_ms[0] = 1e3 * (ts1.tv_sec - ts0.tv_sec)
                      + 1e-6 * (ts1.tv_nsec - ts0.tv_nsec);  /* update */
        times_ms[1] = 1e3 * (ts2.tv_sec - ts1.tv_sec)
                      + 1e-6 * (ts2.tv_nsec - ts1.tv_nsec);  /* solve */
        times_ms[2] = 1e3 * (ts3.tv_sec - ts2.tv_sec)
                      + 1e-6 * (ts3.tv_nsec - ts2.tv_nsec);  /* polish */
        times_ms[3] = 1e3 * (ts3.tv_sec - ts0.tv_sec)
                      + 1e-6 * (ts3.tv_nsec - ts0.tv_nsec);  /* run */
    }}
    return e_flag;
}}
"""


def generate_c_hmpc_solver(sys: dict, param: dict, *,
                           options: Options | None = None,
                           save_name: str | None = None,
                           directory: str = GENERATED_DIR,
                           compile: bool = True,
                           **solver_overrides) -> str:
    """Generate (and compile) a standalone HMPC single-split ADMM C solver
    with diamond or shifted-SOC harmonic constraint sets — the harmonic-MPC
    analogue of the reference's code_HMPC_ADMM_C.c product."""
    from spcies_tpu_torch.formulations.hmpc import hmpc_common_ingredients
    opt = options or default_options("HMPC", "ADMM", **solver_overrides)
    ing = hmpc_common_ingredients(sys, param, opt, split=False)
    n, m, N = ing["n"], ing["m"], ing["N"]
    dim, n_s, n_box = ing["dim"], ing["n_s"], ing["n_box"]
    use_soc = ing["use_soc"]
    n_cones = ing["n_soc"] if use_soc else ing["n_y"]
    rho = float(opt.solver["rho"])
    name = save_name or "hmpc_admm"
    name = _unused_name(name, directory, opt)

    # dense KKT maps, identical numpy pipeline to build_hmpc_admm so the C
    # constants match the dense solver's bit-for-bit
    Hh = ing["H"] + rho * (ing["C"].T @ ing["C"])
    Hhi = np.linalg.inv(Hh)
    G = ing["G"]
    W = G @ Hhi @ G.T
    Winv = np.linalg.inv(W)
    M1 = Hhi @ G.T @ Winv @ G @ Hhi - Hhi
    M2 = (Hhi @ G.T @ Winv)[:, :n]

    data = []
    data.append("".join(c_define(k, v) for k, v in {
        "HORIZ": N, "NS": n, "MS": m, "NSTAGE": ing["ns"],
        "DIM": dim, "NSROWS": n_s, "NBOX": n_box, "NCONES": n_cones,
        "USE_SOC": 1 if use_soc else 0,
        "KMAX": int(opt.solver["k_max"])}.items()))
    data.append(c_define("TOLP", float(opt.solver["tol_p"])))
    data.append(c_define("TOLD", float(opt.solver["tol_d"])))
    data.append(c_define("RHO", rho))
    data.append(c_define("RHO_I", 1.0 / rho))
    data.append(c_array("AMAT", ing["A"]))
    data.append(c_array("QMAT", ing["Q"]))
    data.append(c_array("TEMAT", ing["Te"]))
    data.append(c_array("SEMAT", ing["Se"]))
    data.append(c_array("M1", M1))
    data.append(c_array("M2", M2))
    data.append(c_array("CMAT", ing["C"]))
    data.append(c_array("DVEC", ing["d"]))
    if n_box:
        data.append(c_array("LBB", ing["box_LB"]))
        data.append(c_array("UBB", ing["box_UB"]))
    else:
        data.append("static const double LBB[1] = {0.0};\n")
        data.append("static const double UBB[1] = {0.0};\n")
    if not use_soc:
        data.append(c_array("LBY", ing["LBy"]))
        data.append(c_array("UBY", ing["UBy"]))

    if opt.in_engineering:
        data += _eng_c_arrays(sys, n, m)
    src = _HMPC_TEMPLATE.format(name=name, data="\n".join(data))
    if opt.in_engineering:
        src = _apply_engineering(src)
    header = (f"#ifndef {name.upper()}_H\n#define {name.upper()}_H\n"
              f"int {name}_solve(const double *x0, const double *xr, "
              f"const double *ur,\n"
              f"                 double *u_opt, int *k_out, double *z_out, "
              f"double *s_out,\n"
              f"                 double *lam_out, double *times_ms);\n"
              f"#endif\n")

    src = _finalize_src(src, opt)
    if opt.precision == "float":
        # single-precision build (Spcies_options.m:66 precision map)
        src = src.replace("double", "float")
        header = header.replace("double", "float")
    os.makedirs(directory, exist_ok=True)
    c_path = os.path.join(directory, f"{name}.c")
    with open(c_path, "w") as f:
        f.write(src)
    with open(os.path.join(directory, f"{name}.h"), "w") as f:
        f.write(header)
    if compile:
        lib = os.path.join(directory, f"lib{name}.so")
        cmd = ["cc", "-O3", "-shared", "-fPIC", f"-I{directory}",
               "-o", lib, c_path, "-lm"]
        subprocess.run(cmd, check=True, capture_output=True)
    return c_path


# ---------------------------------------------------------------------------
# TIME_VARYING variant — per-call (A, B, Qdiag, Rdiag, LB, UB) with online
# Alpha/Beta blocked Cholesky (code_laxMPC_ADMM_C.c:150-279, the reference's
# 9-input TIME_VARYING=1 signature, struct_laxMPC_ADMM_C_Matlab.c:29-88).
# Built by surgery on _SOLVER_TEMPLATE so the iteration body stays the
# SAME text as the static solver (differential alignment by construction).
# ---------------------------------------------------------------------------

_TV_SIG_OLD = """int {name}_solve(const double *x0_in, const double *xr_in, const double *ur_in,
                 double *u_opt, int *k_out, double *z_out, double *v_out,
                 double *lam_out, double *times_ms)"""

_TV_SIG_NEW = """int {name}_solve(const double *x0_in, const double *xr_in, const double *ur_in,
                 const double *A_in, const double *B_in,
                 const double *Qd_in, const double *Rd_in,
                 const double *LB_in, const double *UB_in,
                 double *u_opt, int *k_out, double *z_out, double *v_out,
                 double *lam_out, double *times_ms)"""

_TV_HELPERS = r"""
static void chol_lower(const double D[NS][NS], double L[NS][NS])
{{
    for (int i = 0; i < NS; i++) {{
        for (int j = 0; j <= i; j++) {{
            double acc = D[i][j];
            for (int p = 0; p < j; p++) acc -= L[i][p] * L[j][p];
            L[i][j] = (i == j) ? sqrt(acc) : acc / L[j][j];
        }}
        for (int j = i + 1; j < NS; j++) L[i][j] = 0.0;
    }}
}}

static void lower_inv(const double L[NS][NS], double LI[NS][NS])
{{
    for (int c = 0; c < NS; c++)
        for (int r = 0; r < NS; r++) {{
            if (r < c) {{ LI[r][c] = 0.0; continue; }}
            double acc = (r == c) ? 1.0 : 0.0;
            for (int p = c; p < r; p++) acc -= L[r][p] * LI[p][c];
            LI[r][c] = acc / L[r][r];
        }}
}}
"""

_TV_UPDATE = r"""
    /* ---- TIME_VARYING update: unpack the runtime model and rebuild the
     * Alpha/Beta band factors online (code_laxMPC_ADMM_C.c:150-279; this
     * framework's blocked form: BetaInv = U^-1, Alpha = U^-T Woff,
     * kernels/online_band_chol.py) ---- */
    double AMAT[NS][NS], BMAT[NS][MS], ABMAT[NS][NM];
    double QD[NS], RD[MS], QHI[NS], RHI[MS];
    double HI0[MS], HIM[HORIZ - 1][NM];
    double LBZ[NZ], UBZ[NZ];
    double ALPHA[HORIZ - 1][NS][NS], BETAINV[HORIZ][NS][NS];
    for (int i = 0; i < NS; i++) {{
        for (int j = 0; j < NS; j++) {{
            AMAT[i][j] = A_in[i * NS + j];
            ABMAT[i][j] = A_in[i * NS + j];
        }}
        for (int j = 0; j < MS; j++) {{
            BMAT[i][j] = B_in[i * MS + j];
            ABMAT[i][NS + j] = B_in[i * MS + j];
        }}
    }}
    for (int j = 0; j < NS; j++) {{
        QD[j] = Qd_in[j];
        QHI[j] = 1.0 / (QD[j] + RHO);
    }}
    for (int j = 0; j < MS; j++) {{
        RD[j] = Rd_in[j];
        RHI[j] = 1.0 / (RD[j] + RHO);
        HI0[j] = RHI[j];
    }}
    for (int l = 0; l < HORIZ - 1; l++) {{
        for (int j = 0; j < NS; j++) HIM[l][j] = QHI[j];
        for (int j = 0; j < MS; j++) HIM[l][NS + j] = RHI[j];
    }}
    /* stacked bounds (u_0, (x,u) x N-1[, x_N]) from the single-stage
     * [LBx; LBu] inputs (horizon-constant, cons_laxMPC_ADMM_C.m:47-52) */
    for (int j = 0; j < MS; j++) {{
        LBZ[j] = LB_in[NS + j];
        UBZ[j] = UB_in[NS + j];
    }}
    for (int l = 0; l < HORIZ - 1; l++)
        for (int j = 0; j < NM; j++) {{
            LBZ[MS + l * NM + j] = LB_in[j];
            UBZ[MS + l * NM + j] = UB_in[j];
        }}
#if HAS_TERMINAL
    for (int j = 0; j < NS; j++) {{
        LBZ[NZ - NS + j] = LB_in[j];
        UBZ[NZ - NS + j] = UB_in[j];
    }}
#endif
    {{
        double AQIAT[NS][NS], BRIBT[NS][NS], WOFF[NS][NS];
        double D[NS][NS], L[NS][NS], LI[NS][NS];
        for (int i = 0; i < NS; i++)
            for (int j = 0; j < NS; j++) {{
                double a1 = 0.0, a2 = 0.0;
                for (int p = 0; p < NS; p++)
                    a1 += AMAT[i][p] * QHI[p] * AMAT[j][p];
                for (int p = 0; p < MS; p++)
                    a2 += BMAT[i][p] * RHI[p] * BMAT[j][p];
                AQIAT[i][j] = a1;
                BRIBT[i][j] = a2;
                WOFF[i][j] = -QHI[i] * AMAT[j][i];
            }}
        for (int l = 0; l < HORIZ; l++) {{
            for (int i = 0; i < NS; i++)
                for (int j = 0; j < NS; j++) {{
                    double d = BRIBT[i][j];
                    if (l > 0) d += AQIAT[i][j];
                    if (l < HORIZ - 1 && i == j) d += QHI[i];
                    if (l > 0)
                        for (int p = 0; p < NS; p++)
                            d -= ALPHA[l - 1][p][i] * ALPHA[l - 1][p][j];
                    D[i][j] = d;
                }}
#if HAS_TERMINAL
            if (l == HORIZ - 1)
                for (int i = 0; i < NS; i++)
                    for (int j = 0; j < NS; j++) D[i][j] += HIN[i][j];
#endif
            chol_lower(D, L);
            lower_inv(L, LI);
            for (int i = 0; i < NS; i++)
                for (int j = 0; j < NS; j++)
                    BETAINV[l][i][j] = LI[j][i];
            if (l < HORIZ - 1)
                for (int i = 0; i < NS; i++)
                    for (int j = 0; j < NS; j++) {{
                        double a = 0.0;
                        for (int p = 0; p < NS; p++)
                            a += LI[i][p] * WOFF[p][j];
                        ALPHA[l][i][j] = a;
                    }}
        }}
    }}
"""

_TV_SOLVER_TEMPLATE = (
    _SOLVER_TEMPLATE
    .replace(_TV_SIG_OLD, _TV_SIG_NEW)
    .replace("{data}\n", "{data}\n" + _TV_HELPERS)
    .replace("    memset(v1, 0, sizeof(v1));\n",
             "    memset(v1, 0, sizeof(v1));\n" + _TV_UPDATE))
assert _TV_SIG_NEW in _TV_SOLVER_TEMPLATE
assert "chol_lower" in _TV_SOLVER_TEMPLATE


def _apply_tv_engineering(src, data, sys, n, m, fista=False):
    """in_engineering for the TIME_VARYING solvers (the reference's TV
    scaling block, code_laxMPC_ADMM_C.c:82-115: signals AND the per-call
    single-stage [LBx; LBu] bounds are scaled, :93-97; the runtime model
    (A, B, Qdiag, Rdiag) stays in incremental units)."""
    data += _eng_c_arrays(sys, n, m)
    # rename the bound reads, then insert the scaling block right after
    # the signal prologue (which still reads the raw LB_in/UB_in)
    src = src.replace("LB_in[", "LBs[").replace("UB_in[", "UBs[")
    src = src.replace("const double *LBs,", "const double *LB_in,")
    src = src.replace("const double *UBs,", "const double *UB_in,")
    bounds = '    double LBs[NM], UBs[NM];\n    for (int j = 0; j < NS; j++) {\n        LBs[j] = NXV[j] * (LB_in[j] - OPX[j]);\n        UBs[j] = NXV[j] * (UB_in[j] - OPX[j]);\n    }\n    for (int j = 0; j < MS; j++) {\n        LBs[NS + j] = NUV[j] * (LB_in[NS + j] - OPU[j]);\n        UBs[NS + j] = NUV[j] * (UB_in[NS + j] - OPU[j]);\n    }\n'
    if fista:
        src = _apply_engineering(src)
        # _apply_engineering's prologue ends with the ur unpack
        anchor = "    const double *ur = urb;\n"
    else:
        anchor = "    const double *ur = urb;\n"
    assert anchor in src
    src = src.replace(anchor, anchor + bounds, 1)
    return src


def generate_c_tv_solver(sys: dict, param: dict, *, formulation: str,
                         options: Options | None = None,
                         save_name: str | None = None,
                         directory: str = GENERATED_DIR,
                         compile: bool = True,
                         **solver_overrides) -> str:
    """Generate (and compile) a TIME_VARYING laxMPC/equMPC ADMM C solver:
    the reference's 9-input signature (x0, xr, ur, A, B, Qdiag, Rdiag,
    LB, UB) with the band factors rebuilt online each call. Scalar rho
    only, horizon-constant bounds (cons_laxMPC_ADMM_C.m:47-52)."""
    if formulation not in ("laxMPC", "equMPC"):
        raise NotImplementedError(
            "TIME_VARYING C generation supports laxMPC/equMPC ADMM "
            "(examples/t01_time_varying_MPC.m:17-19)")
    terminal = formulation == "laxMPC"
    opt = options or default_options(formulation, "ADMM",
                                     **solver_overrides)
    rho = opt.solver["rho"]
    if not np.isscalar(rho):
        raise NotImplementedError("TIME_VARYING requires scalar rho")
    rho = float(rho)

    from spcies_tpu_torch.formulations.base import get_sys_matrices
    A, B, n, m = get_sys_matrices(sys)
    N = int(param["N"])
    nz = N * (n + m) - (0 if terminal else n)
    name = save_name or f"{formulation.lower()}_admm_tv"
    name = _unused_name(name, directory, opt)

    defs = {
        "HORIZ": N, "NS": n, "MS": m, "NM": n + m, "NZ": nz,
        "KMAX": int(opt.solver["k_max"]),
        "HAS_TERMINAL": 1 if terminal else 0,
    }
    data = []
    data.append("".join(c_define(k, v) for k, v in defs.items()))
    data.append(c_define("TOL", float(opt.solver["tol"])))
    data.append(c_define("RHO", rho))
    data.append(c_define("RHO_I", 1.0 / rho))
    if terminal:
        # T is NOT time-varying; (T + rho I)^-1 is computed offline
        # (compute_laxMPC_ADMM_ingredients.m:109-118)
        T = np.asarray(param["T"], dtype=float)
        data.append(c_array("TMAT", T))
        data.append(c_array("HIN", np.linalg.inv(T + rho * np.eye(n))))

    parts = (_laxmpc_terminal_parts(name) if terminal
             else _equmpc_terminal_parts(name))
    decls, term_q, term_hn, term_rhs, term_z = parts

    in_eng = bool(opt.in_engineering)
    src = _TV_SOLVER_TEMPLATE.format(
        name=name, data="@DATA@", terminal_decls=decls,
        terminal_q=term_q, terminal_hn=term_hn, terminal_rhs=term_rhs,
        terminal_z=term_z, qhat_code=_QHAT_BOX, proj_code=_PROJ_BOX,
        eng_in=_ENG_IN_ON if in_eng else _ENG_IN_OFF,
        u_out=_U_OUT_ON if in_eng else _U_OUT_OFF)
    if in_eng:
        src = _apply_tv_engineering(src, data, sys, n, m)
    src = src.replace("@DATA@", "\n".join(data))

    header = (f"#ifndef {name.upper()}_H\n#define {name.upper()}_H\n"
              f"int {name}_solve(const double *x0, const double *xr, "
              f"const double *ur,\n"
              f"                 const double *A, const double *B,\n"
              f"                 const double *Qd, const double *Rd,\n"
              f"                 const double *LB, const double *UB,\n"
              f"                 double *u_opt, int *k_out, double *z_out, "
              f"double *v_out,\n"
              f"                 double *lam_out, double *times_ms);\n"
              f"#endif\n")

    src = _finalize_src(src, opt)
    if opt.precision == "float":
        # single-precision build (Spcies_options.m:66 precision map)
        src = src.replace("double", "float")
        header = header.replace("double", "float")
    os.makedirs(directory, exist_ok=True)
    c_path = os.path.join(directory, f"{name}.c")
    with open(c_path, "w") as f:
        f.write(src)
    with open(os.path.join(directory, f"{name}.h"), "w") as f:
        f.write(header)
    if compile:
        lib = os.path.join(directory, f"lib{name}.so")
        cmd = ["cc", "-O3", "-shared", "-fPIC", f"-I{directory}",
               "-o", lib, c_path, "-lm"]
        subprocess.run(cmd, check=True, capture_output=True)
    return c_path


# ---------------------------------------------------------------------------
# TIME_VARYING dual FISTA (laxMPC/equMPC) — same 9-input signature; W is
# factored online WITHOUT rho (code_laxMPC_FISTA_C.c TIME_VARYING path).
# The band factors live in file-scope mutable statics because the FISTA
# template's band_solve/z_from_y/resid helpers are file-scope functions.
# ---------------------------------------------------------------------------

_FISTA_TV_SIG_OLD = """int {name}_solve(const double *x0, const double *xr, const double *ur,
                 double *u_opt, int *k_out, double *z_out, double *lam_out,
                 double *times_ms)"""

_FISTA_TV_SIG_NEW = """int {name}_solve(const double *x0, const double *xr, const double *ur,
                 const double *A_in, const double *B_in,
                 const double *Qd_in, const double *Rd_in,
                 const double *LB_in, const double *UB_in,
                 double *u_opt, int *k_out, double *z_out, double *lam_out,
                 double *times_ms)"""

_FISTA_TV_DECLS = r"""
static double AMAT[NS][NS], BMAT[NS][MS], ABMAT[NS][NM];
static double QD[NS], RD[MS], HINV[NZ];
static double LBZ[NZ], UBZ[NZ];
static double ALPHA[HORIZ - 1][NS][NS], BETAINV[HORIZ][NS][NS];
"""

_FISTA_TV_UPDATE = r"""
    /* ---- TIME_VARYING update: unpack the runtime model and factor
     * W = G H^-1 G' online (no rho in H; code_laxMPC_FISTA_C.c TV path) */
    double QHI[NS], RHI[MS];
    for (int i = 0; i < NS; i++) {{
        for (int j = 0; j < NS; j++) {{
            AMAT[i][j] = A_in[i * NS + j];
            ABMAT[i][j] = A_in[i * NS + j];
        }}
        for (int j = 0; j < MS; j++) {{
            BMAT[i][j] = B_in[i * MS + j];
            ABMAT[i][NS + j] = B_in[i * MS + j];
        }}
    }}
    for (int j = 0; j < NS; j++) {{
        QD[j] = Qd_in[j];
        QHI[j] = 1.0 / QD[j];
    }}
    for (int j = 0; j < MS; j++) {{
        RD[j] = Rd_in[j];
        RHI[j] = 1.0 / RD[j];
        HINV[j] = RHI[j];
    }}
    for (int l = 0; l < HORIZ - 1; l++) {{
        for (int j = 0; j < NS; j++) HINV[MS + l * NM + j] = QHI[j];
        for (int j = 0; j < MS; j++) HINV[MS + l * NM + NS + j] = RHI[j];
    }}
#if HAS_TERMINAL
    for (int j = 0; j < NS; j++) HINV[NZ - NS + j] = 1.0 / TD[j];
#endif
    for (int j = 0; j < MS; j++) {{
        LBZ[j] = LB_in[NS + j];
        UBZ[j] = UB_in[NS + j];
    }}
    for (int l = 0; l < HORIZ - 1; l++)
        for (int j = 0; j < NM; j++) {{
            LBZ[MS + l * NM + j] = LB_in[j];
            UBZ[MS + l * NM + j] = UB_in[j];
        }}
#if HAS_TERMINAL
    for (int j = 0; j < NS; j++) {{
        LBZ[NZ - NS + j] = LB_in[j];
        UBZ[NZ - NS + j] = UB_in[j];
    }}
#endif
    {{
        double AQIAT[NS][NS], BRIBT[NS][NS], WOFF[NS][NS];
        double D[NS][NS], L[NS][NS], LI[NS][NS];
        for (int i = 0; i < NS; i++)
            for (int j = 0; j < NS; j++) {{
                double a1 = 0.0, a2 = 0.0;
                for (int p = 0; p < NS; p++)
                    a1 += AMAT[i][p] * QHI[p] * AMAT[j][p];
                for (int p = 0; p < MS; p++)
                    a2 += BMAT[i][p] * RHI[p] * BMAT[j][p];
                AQIAT[i][j] = a1;
                BRIBT[i][j] = a2;
                WOFF[i][j] = -QHI[i] * AMAT[j][i];
            }}
        for (int l = 0; l < HORIZ; l++) {{
            for (int i = 0; i < NS; i++)
                for (int j = 0; j < NS; j++) {{
                    double d = BRIBT[i][j];
                    if (l > 0) d += AQIAT[i][j];
                    if (l < HORIZ - 1 && i == j) d += QHI[i];
                    if (l > 0)
                        for (int p = 0; p < NS; p++)
                            d -= ALPHA[l - 1][p][i] * ALPHA[l - 1][p][j];
#if HAS_TERMINAL
                    if (l == HORIZ - 1 && i == j) d += 1.0 / TD[i];
#endif
                    D[i][j] = d;
                }}
            chol_lower(D, L);
            lower_inv(L, LI);
            for (int i = 0; i < NS; i++)
                for (int j = 0; j < NS; j++)
                    BETAINV[l][i][j] = LI[j][i];
            if (l < HORIZ - 1)
                for (int i = 0; i < NS; i++)
                    for (int j = 0; j < NS; j++) {{
                        double a = 0.0;
                        for (int p = 0; p < NS; p++)
                            a += LI[i][p] * WOFF[p][j];
                        ALPHA[l][i][j] = a;
                    }}
        }}
    }}
"""

_TV_FISTA_TEMPLATE = (
    _FISTA_TEMPLATE
    .replace(_FISTA_TV_SIG_OLD, _FISTA_TV_SIG_NEW)
    .replace("{data}\n", "{data}\n" + _FISTA_TV_DECLS + _TV_HELPERS)
    .replace("    double t = 1.0;\n",
             "    double t = 1.0;\n" + _FISTA_TV_UPDATE))
assert _FISTA_TV_SIG_NEW in _TV_FISTA_TEMPLATE
assert "chol_lower" in _TV_FISTA_TEMPLATE


def generate_c_tv_fista_solver(sys: dict, param: dict, *, formulation: str,
                               options: Options | None = None,
                               save_name: str | None = None,
                               directory: str = GENERATED_DIR,
                               compile: bool = True,
                               **solver_overrides) -> str:
    """Generate (and compile) a TIME_VARYING laxMPC/equMPC dual-FISTA C
    solver (9-input signature; W refactored online without rho)."""
    if formulation not in ("laxMPC", "equMPC"):
        raise NotImplementedError(
            "TIME_VARYING FISTA C generation supports laxMPC/equMPC")
    terminal = formulation == "laxMPC"
    opt = options or default_options(formulation, "FISTA",
                                     **solver_overrides)

    from spcies_tpu_torch.formulations.base import get_sys_matrices
    A, B, n, m = get_sys_matrices(sys)
    N = int(param["N"])
    nz = N * (n + m) - (0 if terminal else n)
    name = save_name or f"{formulation.lower()}_fista_tv"
    name = _unused_name(name, directory, opt)

    data = []
    data.append("".join(c_define(k, v) for k, v in {
        "HORIZ": N, "NS": n, "MS": m, "NM": n + m, "NZ": nz,
        "KMAX": int(opt.solver["k_max"]),
        "HAS_TERMINAL": 1 if terminal else 0}.items()))
    data.append(c_define("TOL", float(opt.solver["tol"])))
    if terminal:
        T = np.asarray(param["T"], dtype=float)
        if not np.allclose(T, np.diag(np.diag(T))):
            raise ValueError("laxMPC/FISTA requires diagonal T")
        data.append(c_array("TD", np.diag(T)))

    if terminal:
        term_z = ("    for (int i = 0; i < NS; i++)\n"
                  "        z[NZ - NS + i] = -HINV[NZ - NS + i]"
                  " * (q[NZ - NS + i] + y[HORIZ - 1][i]);\n")
        term_r = ("    for (int i = 0; i < NS; i++) {\n"
                  "        double acc = b[HORIZ - 1][i] + z[NZ - NS + i];\n"
                  "        for (int j = 0; j < NM; j++)\n"
                  "            acc -= ABMAT[i][j]"
                  " * z[MS + (HORIZ - 2) * NM + j];\n"
                  "        r[HORIZ - 1][i] = acc;\n    }\n")
        term_q = ("    for (int j = 0; j < NS; j++)\n"
                  "        q[NZ - NS + j] = -TD[j] * xr[j];\n")
        term_b = ""
    else:
        term_z = ""
        term_r = ("    for (int i = 0; i < NS; i++) {\n"
                  "        double acc = b[HORIZ - 1][i];\n"
                  "        for (int j = 0; j < NM; j++)\n"
                  "            acc -= ABMAT[i][j]"
                  " * z[MS + (HORIZ - 2) * NM + j];\n"
                  "        r[HORIZ - 1][i] = acc;\n    }\n")
        term_q = ""
        term_b = ("    for (int i = 0; i < NS; i++)"
                  " b[HORIZ - 1][i] = xr[i];\n")

    src = _TV_FISTA_TEMPLATE.format(name=name, data="@DATA@",
                                    terminal_z=term_z, terminal_r=term_r,
                                    terminal_q=term_q, terminal_b=term_b)
    if opt.in_engineering:
        src = _apply_tv_engineering(src, data, sys, n, m, fista=True)
    src = src.replace("@DATA@", "\n".join(data))
    header = (f"#ifndef {name.upper()}_H\n#define {name.upper()}_H\n"
              f"int {name}_solve(const double *x0, const double *xr, "
              f"const double *ur,\n"
              f"                 const double *A, const double *B,\n"
              f"                 const double *Qd, const double *Rd,\n"
              f"                 const double *LB, const double *UB,\n"
              f"                 double *u_opt, int *k_out, double *z_out, "
              f"double *lam_out,\n"
              f"                 double *times_ms);\n#endif\n")

    src = _finalize_src(src, opt)
    if opt.precision == "float":
        # single-precision build (Spcies_options.m:66 precision map)
        src = src.replace("double", "float")
        header = header.replace("double", "float")
    os.makedirs(directory, exist_ok=True)
    c_path = os.path.join(directory, f"{name}.c")
    with open(c_path, "w") as f:
        f.write(src)
    with open(os.path.join(directory, f"{name}.h"), "w") as f:
        f.write(header)
    if compile:
        lib = os.path.join(directory, f"lib{name}.so")
        cmd = ["cc", "-O3", "-shared", "-fPIC", f"-I{directory}",
               "-o", lib, c_path, "-lm"]
        subprocess.run(cmd, check=True, capture_output=True)
    return c_path


# ---------------------------------------------------------------------------
# Pure-C closed-loop demo harness — the analogue of the reference's
# examples/cl_in_C/main_cl_in_C.c: a standalone executable that simulates
# the plant in C and calls the generated solver every control period.
# ---------------------------------------------------------------------------

_CL_MAIN_TEMPLATE = r"""
/* main_cl_{name}.c — generated by spcies_tpu: plain-C closed-loop demo
 * (reference examples/cl_in_C/main_cl_in_C.c). Simulates x+ = A x + B u
 * with the embedded solver in the loop and prints the trajectory. */
#include "{name}.h"
#include <stdio.h>
#include <math.h>

#define CL_N {n}
#define CL_M {m}
#define CL_STEPS {steps}

{data}

int main(void)
{{
    double x[CL_N], xn[CL_N], u[CL_M], times[4];
    int k, e_flag;
    for (int i = 0; i < CL_N; i++) x[i] = XINIT[i];
    for (int t = 0; t < CL_STEPS; t++) {{
        e_flag = {name}_solve(x, XREF, UREF, u, &k, 0, 0, 0, times);
        if (e_flag < 0)
            printf("step %d: solver hit k_max\n", t);
        for (int i = 0; i < CL_N; i++) {{
            double acc = 0.0;
            for (int j = 0; j < CL_N; j++) acc += APLANT[i][j] * x[j];
            for (int j = 0; j < CL_M; j++) acc += BPLANT[i][j] * u[j];
            xn[i] = acc;
        }}
        for (int i = 0; i < CL_N; i++) x[i] = xn[i];
        printf("t=%3d  k=%4d  u0=% .6f  x0=% .6f\n", t, k, u[0], x[0]);
    }}
    double err = 0.0;
    for (int i = 0; i < CL_N; i++)
        err += (x[i] - XREF[i]) * (x[i] - XREF[i]);
    printf("final |x - xr| = %.9f\n", sqrt(err));
    return 0;
}}
"""


def generate_cl_demo(sys: dict, param: dict, *, formulation: str = "laxMPC",
                     x_init=None, steps: int = 20,
                     options: Options | None = None,
                     save_name: str | None = None,
                     directory: str = GENERATED_DIR,
                     compile: bool = True,
                     **solver_overrides) -> str:
    """Generate a standalone plain-C closed-loop demo: the solver .c plus
    a main_cl_<name>.c that simulates the plant and calls it every period,
    compiled into an executable cl_<name> (reference
    examples/cl_in_C/main_cl_in_C.c workflow). Returns the executable (or
    main .c if compile=False) path."""
    opt = options or default_options(formulation, "ADMM",
                                     **solver_overrides)
    if opt.precision != "double":
        raise NotImplementedError("the closed-loop demo drives the "
                                  "double-precision solver")
    name = save_name or f"{formulation.lower()}_admm"
    name = _unused_name(name, directory, opt)
    import dataclasses
    opt_inner = dataclasses.replace(opt, override=True,
                                    solver=dict(opt.solver))
    c_path = generate_c_solver(sys, param, formulation=formulation,
                               options=opt_inner, save_name=name,
                               directory=directory, compile=False)

    from spcies_tpu_torch.formulations.base import get_sys_matrices
    A, B, n, m = get_sys_matrices(sys)
    if x_init is None:
        x_init = np.zeros(n)
    # steady-state reference consistent with the plant (the tester
    # fixture's scenario, tests/spcies_tester.m:113-116)
    ur = 0.5 * np.ones(m)
    xr = np.linalg.solve(np.eye(n) - A, B @ ur)

    data = []
    data.append(c_array("APLANT", A))
    data.append(c_array("BPLANT", B))
    data.append(c_array("XINIT", np.asarray(x_init, float).ravel()))
    data.append(c_array("XREF", xr))
    data.append(c_array("UREF", ur))
    src = _CL_MAIN_TEMPLATE.format(name=name, n=n, m=m, steps=int(steps),
                                   data="\n".join(data))
    main_path = os.path.join(directory, f"main_cl_{name}.c")
    with open(main_path, "w") as f:
        f.write(src)
    if not compile:
        return main_path
    exe = os.path.join(directory, f"cl_{name}")
    cmd = ["cc", "-O3", f"-I{directory}", "-o", exe, main_path, c_path,
           "-lm"]
    subprocess.run(cmd, check=True, capture_output=True)
    return exe
