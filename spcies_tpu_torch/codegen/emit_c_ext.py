"""Plain-C generation for the remaining solver triples: MPCT/ADMM-cs,
MPCT/ADMM-semiband, ellipMPC/ADMM-soc, HMPC/{ADMM,SADMM}-split and
ellipHMPC/ADMM.  Together with emit_c.py this gives every one of the
reference's 11 generated-solver triples an embedded plain-C path
(reference inventory: code_MPCT_ADMM_cs_C.c, code_MPCT_ADMM_semiband_C.c,
code_ellipMPC_ADMM_soc_C.c, code_HMPC_ADMM_split_C.c [IS_SYMMETRIC],
code_ellipHMPC_ADMM_C.c).

Same design as emit_c.py: the C implements the same iteration as the
batched engines in this framework's representation — the reference's CSR SpMV +
sparse LDL pipelines (code_MPCT_ADMM_cs_C.c:112-149) and two-level Woodbury
(code_MPCT_ADMM_semiband_C.c:195-496) collapse into baked dense affine maps
z = M_q q_hat + M_b x0, exactly the matrices the dense solvers use, so the C
is differential-testable against them to fp64 accuracy.  The C runs the
direct-form recurrence (recompute q_hat each iteration) while the batched
engines run the algebraically-identical delta form; fp64 agreement stays at
the 1e-10 contract (tests/test_torch_codegen_c_ext.py). The port of
spcies_tpu/codegen/emit_c_ext.py, writing the same bytes.
"""

from __future__ import annotations

import os
import subprocess

import numpy as np

from spcies_tpu_torch.codegen.c_emitter import c_array, c_define
from spcies_tpu_torch.codegen.emit_c import (
    GENERATED_DIR, _unused_name, _finalize_src, _eng_c_arrays,
    _apply_engineering)
from spcies_tpu_torch.config import Options, default_options


def _write_and_compile(name: str, src: str, header: str, directory: str,
                       compile: bool, opt=None) -> str:
    if opt is not None:
        src = _finalize_src(src, opt)
        if opt.precision == "float":
            # single-precision build (reference precision option,
            # Spcies_options.m:66; dec_var.m type map float/double):
            # the emitted source is type-homogeneous, so retyping every
            # `double` retypes constants, state and the public signature
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


def _std_header(name: str, args: str) -> str:
    return (f"#ifndef {name.upper()}_H\n#define {name.upper()}_H\n"
            f"int {name}_solve({args});\n#endif\n")


# ---------------------------------------------------------------------------
# MPCT ADMM-cs — extended (x_i, x_s, u_i, u_s) state space
# ---------------------------------------------------------------------------

_MPCT_CS_TEMPLATE = r"""
/* {name} — generated by spcies_tpu (MPCT tracking MPC, ADMM on the
 * extended (x_i, x_s, u_i, u_s) state space; reference
 * code_MPCT_ADMM_cs_C.c:94-218 in this framework's dense M_q/M_b
 * representation — the CSR SpMV + sparse LDL solve collapse into one
 * affine map). Self-contained, allocation-free.
 *   q_hat = q + lam - rho .* v
 *   z     = M_q q_hat + M_b x0
 *   v     = clip(z + rho^-1 .* lam, LB, UB)   (eps-tightened artificials)
 *   lam  += rho .* (z - v)
 *   stop when ||z - v||_inf <= TOL and ||v - v_prev||_inf <= TOL
 */
#include "{name}.h"
#include <math.h>
#include <string.h>
#include <time.h>

{data}

int {name}_solve(const double *x0, const double *xr, const double *ur,
                 double *u_opt, int *k_out, double *z_out, double *v_out,
                 double *lam_out, double *times_ms)
{{
    struct timespec ts0, ts1, ts2, ts3;
    clock_gettime(CLOCK_MONOTONIC_RAW, &ts0);

    double q[NZ], q_hat[NZ], z[NZ], v[NZ], v1[NZ], lam[NZ], bx[NS];

    memset(v, 0, sizeof(v));
    memset(v1, 0, sizeof(v1));
    memset(lam, 0, sizeof(lam));

    /* per-stage linear cost [0; -(T/N) xr; 0; -(S/N) ur]
     * (spcies_MPCT_ADMM_cs_solver.m:172) */
    {{
        double qx[NS], qu[MS];
        for (int i = 0; i < NS; i++) {{
            double acc = 0.0;
            for (int j = 0; j < NS; j++) acc += TMAT[i][j] * xr[j];
            qx[i] = -acc / HORIZ;
        }}
        for (int i = 0; i < MS; i++) {{
            double acc = 0.0;
            for (int j = 0; j < MS; j++) acc += SMAT[i][j] * ur[j];
            qu[i] = -acc / HORIZ;
        }}
        for (int l = 0; l < HORIZ; l++) {{
            int c = l * SD;
            for (int i = 0; i < NS; i++) {{
                q[c + i] = 0.0;
                q[c + NS + i] = qx[i];
            }}
            for (int i = 0; i < MS; i++) {{
                q[c + 2 * NS + i] = 0.0;
                q[c + 2 * NS + MS + i] = qu[i];
            }}
        }}
    }}
    for (int i = 0; i < NS; i++) bx[i] = x0[i];

    clock_gettime(CLOCK_MONOTONIC_RAW, &ts1);

    int k = 0;
    int e_flag = 0;
    while (e_flag == 0) {{
        k++;
        for (int i = 0; i < NZ; i++)
            q_hat[i] = q[i] + lam[i] - RHOV[i] * v[i];
        for (int i = 0; i < NZ; i++) {{
            double acc = 0.0;
            for (int j = 0; j < NZ; j++) acc += MQ[i][j] * q_hat[j];
            for (int j = 0; j < NS; j++) acc += MB[i][j] * bx[j];
            z[i] = acc;
        }}
        double r_p = 0.0, r_d = 0.0;
        for (int i = 0; i < NZ; i++) {{
            double y = z[i] + RHOIV[i] * lam[i];
            double vi = y < LBZ[i] ? LBZ[i] : (y > UBZ[i] ? UBZ[i] : y);
            double dp = z[i] - vi;
            double dd = vi - v1[i];
            if (fabs(dp) > r_p) r_p = fabs(dp);
            if (fabs(dd) > r_d) r_d = fabs(dd);
            lam[i] += RHOV[i] * dp;
            v[i] = vi;
        }}
        if (r_p <= TOL && r_d <= TOL) e_flag = 1;
        else if (k >= KMAX) e_flag = -1;
        memcpy(v1, v, sizeof(v));
    }}

    clock_gettime(CLOCK_MONOTONIC_RAW, &ts2);
    for (int j = 0; j < MS; j++) u_opt[j] = v[2 * NS + j];
    *k_out = k;
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


def generate_c_mpct_cs_solver(sys: dict, param: dict, *,
                              options: Options | None = None,
                              save_name: str | None = None,
                              directory: str = GENERATED_DIR,
                              compile: bool = True,
                              **solver_overrides) -> str:
    """Generate (and compile) a standalone MPCT ADMM-cs C solver."""
    from spcies_tpu_torch.formulations.mpct import mpct_admm_cs_ingredients
    opt = options or default_options("MPCT", "ADMM", "cs",
                                     **solver_overrides)
    ing = mpct_admm_cs_ingredients(sys, param, opt)
    n, m, N, nz = ing["n"], ing["m"], ing["N"], ing["nz"]
    name = save_name or "mpct_admm_cs"
    name = _unused_name(name, directory, opt)

    data = []
    data.append("".join(c_define(k, v) for k, v in {
        "HORIZ": N, "NS": n, "MS": m, "SD": 2 * (n + m), "NZ": nz,
        "KMAX": int(opt.solver["k_max"])}.items()))
    data.append(c_define("TOL", float(opt.solver["tol"])))
    data.append(c_array("RHOV", ing["rho_vec"]))
    data.append(c_array("RHOIV", ing["rho_inv_vec"]))
    data.append(c_array("MQ", ing["M_q"]))
    data.append(c_array("MB", ing["M_b"]))
    data.append(c_array("TMAT", ing["T"]))
    data.append(c_array("SMAT", ing["S"]))
    data.append(c_array("LBZ", ing["LB"]))
    data.append(c_array("UBZ", ing["UB"]))

    if opt.in_engineering:
        data += _eng_c_arrays(sys, n, m)
    src = _MPCT_CS_TEMPLATE.format(name=name, data="\n".join(data))
    if opt.in_engineering:
        src = _apply_engineering(src)
    header = _std_header(
        name,
        "const double *x0, const double *xr, const double *ur,\n"
        "                 double *u_opt, int *k_out, double *z_out, "
        "double *v_out,\n"
        "                 double *lam_out, double *times_ms")
    return _write_and_compile(name, src, header, directory, compile,
                              opt)


# ---------------------------------------------------------------------------
# MPCT ADMM-semiband — (x_0..x_{N-1}, u_0..u_{N-1}, x_s, u_s) parameterization
# with optional soft constraints and constrained output
# ---------------------------------------------------------------------------

_MPCT_SEMIBAND_TEMPLATE = r"""
/* {name} — generated by spcies_tpu (MPCT tracking MPC, ADMM on the
 * semiband parameterization; reference code_MPCT_ADMM_semiband_C.c in this
 * framework's dense M_q/M_b representation — the two-level Woodbury
 * correction chain collapses into one affine map). Optional soft
 * constraints (SOFT) and constrained output (CON_OUT), matching the
 * reference's SOFT_CONSTRAINTS / CONSTRAINED_OUTPUT defines.
 *   p    = q + C~'(lam - rho v)          (C~ = identity unless CON_OUT)
 *   z    = M_q p + M_b x0
 *   v    = proj(C~ z + rho^-1 lam)       (hard box / soft five-case prox)
 *   lam += rho (C~ z - v)
 *   stop when ||C~z - v||_inf <= TOLP and ||v - v_prev||_inf <= TOLD
 */
#include "{name}.h"
#include <math.h>
#include <string.h>
#include <time.h>

{data}

int {name}_solve(const double *x0, const double *xr, const double *ur,
                 double *u_opt, int *k_out, double *z_out, double *v_out,
                 double *lam_out, double *times_ms)
{{
    struct timespec ts0, ts1, ts2, ts3;
    clock_gettime(CLOCK_MONOTONIC_RAW, &ts0);

    double q[NZ], p[NZ], z[NZ], zt[NV], v[NV], v1[NV], lam[NV];

    memset(v, 0, sizeof(v));
    memset(v1, 0, sizeof(v1));
    memset(lam, 0, sizeof(lam));

    /* q: zeros except the (x_s, u_s) tail = (-T xr, -S ur) */
    memset(q, 0, sizeof(q));
    for (int i = 0; i < NS; i++) {{
        double acc = 0.0;
        for (int j = 0; j < NS; j++) acc += TMAT[i][j] * xr[j];
        q[NZ - NS - MS + i] = -acc;
    }}
    for (int i = 0; i < MS; i++) {{
        double acc = 0.0;
        for (int j = 0; j < MS; j++) acc += SMAT[i][j] * ur[j];
        q[NZ - MS + i] = -acc;
    }}

    clock_gettime(CLOCK_MONOTONIC_RAW, &ts1);

    int k = 0;
    int e_flag = 0;
    while (e_flag == 0) {{
        k++;
        /* p = q + C~'(lam - rho v) */
#if CON_OUT
        for (int i = 0; i < NZ; i++) {{
            double acc = q[i];
            for (int r = 0; r < NV; r++)
                acc += CT[r][i] * (lam[r] - RHO * v[r]);
            p[i] = acc;
        }}
#else
        for (int i = 0; i < NZ; i++)
            p[i] = q[i] + lam[i] - RHO * v[i];
#endif
        for (int i = 0; i < NZ; i++) {{
            double acc = 0.0;
            for (int j = 0; j < NZ; j++) acc += MQ[i][j] * p[j];
            for (int j = 0; j < NS; j++) acc += MB[i][j] * x0[j];
            z[i] = acc;
        }}
#if CON_OUT
        for (int r = 0; r < NV; r++) {{
            double acc = 0.0;
            for (int i = 0; i < NZ; i++) acc += CT[r][i] * z[i];
            zt[r] = acc;
        }}
#else
        memcpy(zt, z, sizeof(z));
#endif
        double r_p = 0.0, r_d = 0.0;
        for (int r = 0; r < NV; r++) {{
            double y = zt[r] + RHO_I * lam[r];
            double vi;
#if SOFT
            if (SOFTMASK[r]) {{
                /* five-case soft-constraint prox
                 * (spcies_MPCT_ADMM_semiband_solver.m:407-430) */
                double ya = y + BR, yb = y - BR;
                if (ya <= LBV[r]) vi = ya;
                else if (y >= LBV[r] && y <= UBV[r]) vi = y;
                else if (yb >= UBV[r]) vi = yb;
                else vi = y < LBV[r] ? LBV[r]
                          : (y > UBV[r] ? UBV[r] : y);
            }} else
#endif
            vi = y < LBV[r] ? LBV[r] : (y > UBV[r] ? UBV[r] : y);
            double dp = zt[r] - vi;
            double dd = vi - v1[r];
            if (fabs(dp) > r_p) r_p = fabs(dp);
            if (fabs(dd) > r_d) r_d = fabs(dd);
            lam[r] += RHO * dp;
            v[r] = vi;
        }}
        if (r_p <= TOLP && r_d <= TOLD) e_flag = 1;
        else if (k >= KMAX) e_flag = -1;
        memcpy(v1, v, sizeof(v));
    }}

    clock_gettime(CLOCK_MONOTONIC_RAW, &ts2);
    for (int j = 0; j < MS; j++) u_opt[j] = v[NS + j];
    *k_out = k;
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


def generate_c_mpct_semiband_solver(sys: dict, param: dict, *,
                                    options: Options | None = None,
                                    save_name: str | None = None,
                                    directory: str = GENERATED_DIR,
                                    compile: bool = True,
                                    **solver_overrides) -> str:
    """Generate (and compile) a standalone MPCT ADMM-semiband C solver
    (soft constraints / constrained output as compile-time flags, the
    reference's SOFT_CONSTRAINTS / CONSTRAINED_OUTPUT defines)."""
    from spcies_tpu_torch.formulations.mpct import (
        mpct_admm_semiband_ingredients)
    opt = options or default_options("MPCT", "ADMM", "semiband",
                                     **solver_overrides)
    ing = mpct_admm_semiband_ingredients(sys, param, opt)
    n, m, N, nz, nv = ing["n"], ing["m"], ing["N"], ing["nz"], ing["nv"]
    rho_is_scalar = ing["rho_is_scalar"]
    name = save_name or "mpct_admm_semiband"
    name = _unused_name(name, directory, opt)

    data = []
    data.append("".join(c_define(k, v) for k, v in {
        "HORIZ": N, "NS": n, "MS": m, "NZ": nz, "NV": nv,
        "CON_OUT": 1 if ing["constrained_output"] else 0,
        "SOFT": 1 if ing["soft"] else 0,
        "KMAX": int(opt.solver["k_max"])}.items()))
    data.append(c_define("TOLP", float(opt.solver["tol_p"])))
    data.append(c_define("TOLD", float(opt.solver["tol_d"])))
    if rho_is_scalar:
        rho = float(ing["rho_scalar"])
        data.append(c_define("RHO", rho))
        data.append(c_define("RHO_I", 1.0 / rho))
        data.append(c_define("BR", ing["beta"] / rho))
    else:
        # non-SCALAR_RHO path (cons_MPCT_ADMM_semiband_C.m): per-row
        # penalties, incl. the soft-prox offset beta/rho[r]
        rho_vec = np.asarray(ing["rho_vec"], float)
        data.append(c_array("RHOV", rho_vec))
        data.append(c_array("RHOIV", 1.0 / rho_vec))
        data.append(c_array("BRV", ing["beta"] / rho_vec))
    data.append(c_array("MQ", ing["M_q"]))
    data.append(c_array("MB", ing["M_b"]))
    data.append(c_array("TMAT", ing["T"]))
    data.append(c_array("SMAT", ing["S"]))
    data.append(c_array("LBV", ing["LBv"]))
    data.append(c_array("UBV", ing["UBv"]))
    if ing["constrained_output"]:
        data.append(c_array("CT", ing["C_tilde"]))
    if ing["soft"]:
        mask = ", ".join(str(int(b)) for b in ing["soft_mask"])
        data.append(f"static const int SOFTMASK[NV] = {{{mask}}};\n")
    if opt.in_engineering:
        data += _eng_c_arrays(sys, n, m)

    template = _MPCT_SEMIBAND_TEMPLATE
    if not rho_is_scalar:
        template = (template
                    .replace("lam[r] - RHO * v[r]", "lam[r] - RHOV[r] * v[r]")
                    .replace("lam[i] - RHO * v[i]", "lam[i] - RHOV[i] * v[i]")
                    .replace("RHO_I * lam[r]", "RHOIV[r] * lam[r]")
                    .replace("lam[r] += RHO * dp", "lam[r] += RHOV[r] * dp")
                    .replace("y + BR, yb = y - BR",
                             "y + BRV[r], yb = y - BRV[r]"))
    src = template.format(name=name, data="\n".join(data))
    if opt.in_engineering:
        src = _apply_engineering(src)
    header = _std_header(
        name,
        "const double *x0, const double *xr, const double *ur,\n"
        "                 double *u_opt, int *k_out, double *z_out, "
        "double *v_out,\n"
        "                 double *lam_out, double *times_ms")
    return _write_and_compile(name, src, header, directory, compile,
                              opt)


# ---------------------------------------------------------------------------
# ellipMPC ADMM-soc — slack-augmented SOC terminal set, runtime radius
# ---------------------------------------------------------------------------

_ELLIP_SOC_TEMPLATE = r"""
/* {name} — generated by spcies_tpu (ellipMPC with SOC-reformulated
 * terminal set; reference code_ellipMPC_ADMM_soc_C.c in this framework's
 * dense M1/M2 representation — the offline LDL + CSR pipeline collapses
 * into one affine map). Runtime ellipsoid radius r_ellip input (the
 * reference MEX's 4th argument). Two-dual split: sigma on the z block,
 * rho on the (1+n) SOC slack block.
 *   q_hat = [q - sigma z + lam; mu - rho s]
 *   aux   = M1 q_hat + M2 bh,  bh = [-A x0; 0...; r; 0; -Phalf^-1 P xr]
 *   z     = box-clip(z_hat + sigma^-1 lam)  (x_N and slack unclipped)
 *   s     = proj_SOC(s_hat + rho^-1 mu)
 *   lam  += sigma (z_hat - z); mu += rho (s_hat - s)
 */
#include "{name}.h"
#include <math.h>
#include <string.h>
#include <time.h>

{data}

int {name}_solve(const double *x0, const double *xr, const double *ur,
                 double r_ellip, double *u_opt, int *k_out, double *z_out,
                 double *s_out, double *lam_out, double *mu_out,
                 double *times_ms)
{{
    struct timespec ts0, ts1, ts2, ts3;
    clock_gettime(CLOCK_MONOTONIC_RAW, &ts0);

    double q[DIM], q_hat[NT], aux[NT], aux_b[NT];
    double z[DIM], s[CS], lam[DIM], mu[CS];
    double b0[NS], pr[NS];

    memset(z, 0, sizeof(z));
    memset(s, 0, sizeof(s));
    memset(lam, 0, sizeof(lam));
    memset(mu, 0, sizeof(mu));

    /* linear cost: stages diagonal Q/R, terminal full T, slack 0 */
    for (int j = 0; j < MS; j++) q[j] = -RD[j] * ur[j];
    for (int l = 0; l < HORIZ - 1; l++) {{
        for (int j = 0; j < NS; j++)
            q[MS + l * NM + j] = -QD[j] * xr[j];
        for (int j = 0; j < MS; j++)
            q[MS + l * NM + NS + j] = -RD[j] * ur[j];
    }}
    for (int i = 0; i < NS; i++) {{
        double acc = 0.0;
        for (int j = 0; j < NS; j++) acc += TMAT[i][j] * xr[j];
        q[DIM - 1 - NS + i] = -acc;
    }}
    q[DIM - 1] = 0.0;

    /* aux_b = M2 bh with bh nonzero in the x0 rows, the slack-equality row
     * (= r_ellip) and the cone-shift rows (= -Phalf^-1 P xr) */
    for (int i = 0; i < NS; i++) {{
        b0[i] = 0.0;
        pr[i] = 0.0;
        for (int j = 0; j < NS; j++) {{
            b0[i] -= AMAT[i][j] * x0[j];
            pr[i] -= PHIP[i][j] * xr[j];
        }}
    }}
    for (int i = 0; i < NT; i++) {{
        double acc = r_ellip * M2R[i];
        for (int j = 0; j < NS; j++)
            acc += M2B0[i][j] * b0[j] + M2D[i][j] * pr[j];
        aux_b[i] = acc;
    }}

    clock_gettime(CLOCK_MONOTONIC_RAW, &ts1);

    int k = 0;
    int e_flag = 0;
    while (e_flag == 0) {{
        k++;
        for (int i = 0; i < DIM; i++)
            q_hat[i] = q[i] - SIGMA * z[i] + lam[i];
        for (int i = 0; i < CS; i++)
            q_hat[DIM + i] = mu[i] - RHO * s[i];
        for (int i = 0; i < NT; i++) {{
            double acc = aux_b[i];
            for (int j = 0; j < NT; j++) acc += M1[i][j] * q_hat[j];
            aux[i] = acc;
        }}

        double r_p = 0.0, r_d = 0.0;
        /* z-update: box on the stage vars, x_N and slack unclipped */
        for (int i = 0; i < DIM; i++) {{
            double y = aux[i] + SIGMA_I * lam[i];
            double vi = y;
            if (i < NBOX) {{
                if (vi < LBZ[i]) vi = LBZ[i];
                if (vi > UBZ[i]) vi = UBZ[i];
            }}
            double dp = aux[i] - vi;
            double dd = vi - z[i];           /* z[i] still holds z_old */
            if (fabs(dp) > r_p) r_p = fabs(dp);
            if (fabs(dd) > r_d) r_d = fabs(dd);
            lam[i] += SIGMA * dp;
            z[i] = vi;
        }}
        /* s-update: SOC projection of the (1+n) slack block */
        {{
            double y[CS];
            for (int i = 0; i < CS; i++)
                y[i] = aux[DIM + i] + RHO_I * mu[i];
            double ny1 = 0.0;
            for (int i = 1; i < CS; i++) ny1 += y[i] * y[i];
            ny1 = sqrt(ny1);
            double sv[CS];
            if (ny1 <= y[0]) {{
                memcpy(sv, y, sizeof(sv));
            }} else if (ny1 <= -y[0]) {{
                memset(sv, 0, sizeof(sv));
            }} else {{
                double step = (y[0] + ny1) / (2.0 * ny1);
                sv[0] = step * ny1;
                for (int i = 1; i < CS; i++) sv[i] = step * y[i];
            }}
            for (int i = 0; i < CS; i++) {{
                double dp = aux[DIM + i] - sv[i];
                double dd = sv[i] - s[i];    /* s[i] still holds s_old */
                if (fabs(dp) > r_p) r_p = fabs(dp);
                if (fabs(dd) > r_d) r_d = fabs(dd);
                mu[i] += RHO * dp;
                s[i] = sv[i];
            }}
        }}
        if (r_p <= TOLP && r_d <= TOLD) e_flag = 1;
        else if (k >= KMAX) e_flag = -1;
    }}

    clock_gettime(CLOCK_MONOTONIC_RAW, &ts2);
    for (int j = 0; j < MS; j++) u_opt[j] = z[j];
    *k_out = k;
    if (z_out) memcpy(z_out, z, sizeof(z));
    if (s_out) memcpy(s_out, s, sizeof(s));
    if (lam_out) memcpy(lam_out, lam, sizeof(lam));
    if (mu_out) memcpy(mu_out, mu, sizeof(mu));
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


def generate_c_ellipmpc_soc_solver(sys: dict, param: dict, *,
                                   options: Options | None = None,
                                   save_name: str | None = None,
                                   directory: str = GENERATED_DIR,
                                   compile: bool = True,
                                   **solver_overrides) -> str:
    """Generate (and compile) a standalone ellipMPC ADMM-soc C solver with
    runtime ellipsoid radius."""
    from spcies_tpu_torch.formulations.ellipmpc import (
        ellipmpc_admm_soc_ingredients)
    opt = options or default_options("ellipMPC", "ADMM", "soc",
                                     **solver_overrides)
    ing = ellipmpc_admm_soc_ingredients(sys, param, opt)
    n, m, N = ing["n"], ing["m"], ing["N"]
    dim, n_s = ing["dim"], ing["n_s"]
    nt = dim + n_s
    nbox = (N - 1) * (n + m) + m
    sigma, rho = float(ing["sigma"]), float(ing["rho"])
    name = save_name or "ellipmpc_admm_soc"
    name = _unused_name(name, directory, opt)

    data = []
    data.append("".join(c_define(k, v) for k, v in {
        "HORIZ": N, "NS": n, "MS": m, "NM": n + m,
        "DIM": dim, "CS": n_s, "NT": nt, "NBOX": nbox,
        "KMAX": int(opt.solver["k_max"])}.items()))
    data.append(c_define("TOLP", float(opt.solver["tol_p"])))
    data.append(c_define("TOLD", float(opt.solver["tol_d"])))
    data.append(c_define("SIGMA", sigma))
    data.append(c_define("SIGMA_I", 1.0 / sigma))
    data.append(c_define("RHO", rho))
    data.append(c_define("RHO_I", 1.0 / rho))
    data.append(c_array("AMAT", ing["A"]))
    data.append(c_array("QD", ing["Qd"]))
    data.append(c_array("RD", ing["Rd"]))
    data.append(c_array("TMAT", ing["T"]))
    data.append(c_array("PHIP", ing["PhiP"]))
    data.append(c_array("M1", ing["M1"]))
    data.append(c_array("M2B0", ing["M2_b0"]))
    data.append(c_array("M2R", ing["M2_r"]))
    data.append(c_array("M2D", ing["M2_d"]))
    data.append(c_array("LBZ", ing["LB"]))
    data.append(c_array("UBZ", ing["UB"]))

    if opt.in_engineering:
        data += _eng_c_arrays(sys, n, m)
    src = _ELLIP_SOC_TEMPLATE.format(name=name, data="\n".join(data))
    if opt.in_engineering:
        src = _apply_engineering(src)
    header = _std_header(
        name,
        "const double *x0, const double *xr, const double *ur,\n"
        "                 double r_ellip, double *u_opt, int *k_out, "
        "double *z_out,\n"
        "                 double *s_out, double *lam_out, double *mu_out,\n"
        "                 double *times_ms")
    return _write_and_compile(name, src, header, directory, compile,
                              opt)


# ---------------------------------------------------------------------------
# HMPC ADMM-split / SADMM-split — two-block split, IS_SYMMETRIC define
# ---------------------------------------------------------------------------

_HMPC_SPLIT_TEMPLATE = r"""
/* {name} — generated by spcies_tpu (harmonic MPC, two-block split
 * (S)ADMM; reference code_HMPC_ADMM_split_C.c in this framework's dense
 * M1/M2 representation — the reference's own NON_SPARSE path). SADMM =
 * IS_SYMMETRIC: a half-step dual update with the previous primals before
 * the projections, scaled by ALPHA (code_HMPC_ADMM_split_C.c:215-225).
 *   q_hat = [q - sigma z + lam; mu - rho s]
 *   aux   = M1 q_hat + M2 bh
 *   [SYM] lam += alpha sigma (z_hat - z); mu += alpha rho (s_hat - s)
 *   z     = box-clip stage rows of (z_hat + sigma^-1 lam) [box mode]
 *   s     = cone-project (s_hat + rho^-1 mu)
 *   lam  += alpha sigma (z_hat - z); mu += alpha rho (s_hat - s)
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
                 double *lam_out, double *mu_out, double *times_ms)
{{
    struct timespec ts0, ts1, ts2, ts3;
    clock_gettime(CLOCK_MONOTONIC_RAW, &ts0);

    double q[DIM], q_hat[NT], aux[NT], aux_b[NT];
    double z[DIM], zo[DIM], s[NSROWS], so[NSROWS];
    double lam[DIM], mu[NSROWS];
    double b0[NS];

    memset(z, 0, sizeof(z));
    memset(zo, 0, sizeof(zo));
    memset(s, 0, sizeof(s));
    memset(so, 0, sizeof(so));
    memset(lam, 0, sizeof(lam));
    memset(mu, 0, sizeof(mu));

    /* q = -[0_ns; Te xr + Q x0; 0_n; Q x0; Se ur; 0_2m]
     * (code_HMPC_ADMM_split_C.c:117-122) */
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
    for (int i = 0; i < NT; i++) {{
        double acc = AUXD[i];
        for (int j = 0; j < NS; j++) acc += M2B0[i][j] * b0[j];
        aux_b[i] = acc;
    }}

    clock_gettime(CLOCK_MONOTONIC_RAW, &ts1);

    int k = 0;
    int e_flag = 0;
    while (e_flag == 0) {{
        k++;
        for (int i = 0; i < DIM; i++)
            q_hat[i] = q[i] - SIGMA * z[i] + lam[i];
        for (int i = 0; i < NSROWS; i++)
            q_hat[DIM + i] = mu[i] - RHO * s[i];
        for (int i = 0; i < NT; i++) {{
            double acc = aux_b[i];
            for (int j = 0; j < NT; j++) acc += M1[i][j] * q_hat[j];
            aux[i] = acc;
        }}

#if IS_SYMMETRIC
        /* half-step duals with the previous primals */
        for (int i = 0; i < DIM; i++)
            lam[i] += ALPHA * SIGMA * (aux[i] - z[i]);
        for (int i = 0; i < NSROWS; i++)
            mu[i] += ALPHA * RHO * (aux[DIM + i] - s[i]);
#endif

        memcpy(zo, z, sizeof(z));
        memcpy(so, s, sizeof(s));

        double r_p = 0.0, r_d = 0.0;
        /* z-update */
        for (int i = 0; i < DIM; i++) {{
            double y = aux[i] + SIGMA_I * lam[i];
#if BOX_MODE
            if (i < NSTAGE) {{
                if (y < LBB[i]) y = LBB[i];
                if (y > UBB[i]) y = UBB[i];
            }}
#endif
            z[i] = y;
        }}
        /* s-update: [coupled mode] box rows then 3-vector cones */
        for (int i = 0; i < NSROWS; i++)
            s[i] = aux[DIM + i] + RHO_I * mu[i];
#if !BOX_MODE
        for (int r = 0; r < NBOXS; r++) {{
            if (s[r] < SLB[r]) s[r] = SLB[r];
            if (s[r] > SUB[r]) s[r] = SUB[r];
        }}
#endif
        for (int c = 0; c < NCONES; c++) {{
            double *y = &s[NBOXS + 3 * c];
#if USE_SOC
            proj_ssoc3(y, 1.0, 0.0);
#else
            proj_ssoc3(y, 1.0, LBY[c]);
            proj_ssoc3(y, -1.0, UBY[c]);
#endif
        }}

        /* full-step duals + residuals */
        for (int i = 0; i < DIM; i++) {{
            double dp = aux[i] - z[i];
            lam[i] += ALPHA * SIGMA * dp;
            if (fabs(dp) > r_p) r_p = fabs(dp);
            double dd = z[i] - zo[i];
            if (fabs(dd) > r_d) r_d = fabs(dd);
        }}
        for (int i = 0; i < NSROWS; i++) {{
            double dp = aux[DIM + i] - s[i];
            mu[i] += ALPHA * RHO * dp;
            if (fabs(dp) > r_p) r_p = fabs(dp);
            double dd = s[i] - so[i];
            if (fabs(dd) > r_d) r_d = fabs(dd);
        }}
        if (r_p <= TOLP && r_d <= TOLD) e_flag = 1;
        else if (k >= KMAX) e_flag = -1;
    }}

    clock_gettime(CLOCK_MONOTONIC_RAW, &ts2);
    for (int j = 0; j < MS; j++) u_opt[j] = z[j];
    *k_out = k;
    if (z_out) memcpy(z_out, z, sizeof(z));
    if (s_out) memcpy(s_out, s, sizeof(s));
    if (lam_out) memcpy(lam_out, lam, sizeof(lam));
    if (mu_out) memcpy(mu_out, mu, sizeof(mu));
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


def generate_c_hmpc_split_solver(sys: dict, param: dict, *,
                                 symmetric: bool = False,
                                 options: Options | None = None,
                                 save_name: str | None = None,
                                 directory: str = GENERATED_DIR,
                                 compile: bool = True,
                                 **solver_overrides) -> str:
    """Generate (and compile) a standalone HMPC ADMM-split (symmetric=False)
    or SADMM-split (symmetric=True) C solver."""
    from spcies_tpu_torch.formulations.hmpc import hmpc_common_ingredients
    from spcies_tpu_torch.utils import linalg
    method = "SADMM" if symmetric else "ADMM"
    opt = options or default_options("HMPC", method, "split",
                                     **solver_overrides)
    ing = hmpc_common_ingredients(sys, param, opt, split=True)
    n, m, N = ing["n"], ing["m"], ing["N"]
    dim, n_s, ns = ing["dim"], ing["n_s"], ing["ns"]
    nt = dim + n_s
    n_eq = ing["n_eq"]
    box_mode = ing["box_constraints"]
    use_soc = ing["use_soc"]
    n_cones = ing["n_soc"] if use_soc else ing["n_y"]
    rho = float(opt.solver["rho"])
    sigma = float(opt.solver["sigma"])
    alpha = float(opt.solver["alpha"]) if symmetric else 1.0
    name = save_name or ("hmpc_sadmm_split" if symmetric else
                         "hmpc_admm_split")
    name = _unused_name(name, directory, opt)

    # same numpy pipeline as _build_hmpc_split so the constants match
    Hh = linalg.blkdiag(ing["H"] + sigma * np.eye(dim),
                        rho * np.eye(n_s))
    Gh = np.block([[ing["G"], np.zeros((n_eq, n_s))],
                   [ing["C"], np.eye(n_s)]])
    Hhi = np.linalg.inv(Hh)
    W = Gh @ Hhi @ Gh.T
    Winv = np.linalg.inv(W)
    M1 = Hhi @ Gh.T @ Winv @ Gh @ Hhi - Hhi
    M2 = Hhi @ Gh.T @ Winv
    aux_d = M2[:, n_eq:] @ ing["d"]

    data = []
    data.append("".join(c_define(k, v) for k, v in {
        "HORIZ": N, "NS": n, "MS": m, "NSTAGE": ns,
        "DIM": dim, "NSROWS": n_s, "NT": nt,
        "NBOXS": 0 if box_mode else ing["n_box"],
        "NCONES": n_cones,
        "BOX_MODE": 1 if box_mode else 0,
        "USE_SOC": 1 if use_soc else 0,
        "IS_SYMMETRIC": 1 if symmetric else 0,
        "KMAX": int(opt.solver["k_max"])}.items()))
    data.append(c_define("TOLP", float(opt.solver["tol_p"])))
    data.append(c_define("TOLD", float(opt.solver["tol_d"])))
    data.append(c_define("RHO", rho))
    data.append(c_define("RHO_I", 1.0 / rho))
    data.append(c_define("SIGMA", sigma))
    data.append(c_define("SIGMA_I", 1.0 / sigma))
    data.append(c_define("ALPHA", alpha))
    data.append(c_array("AMAT", ing["A"]))
    data.append(c_array("QMAT", ing["Q"]))
    data.append(c_array("TEMAT", ing["Te"]))
    data.append(c_array("SEMAT", ing["Se"]))
    data.append(c_array("M1", M1))
    data.append(c_array("M2B0", M2[:, :n]))
    data.append(c_array("AUXD", aux_d))
    if box_mode:
        data.append(c_array("LBB", ing["box_LB"]))
        data.append(c_array("UBB", ing["box_UB"]))
    else:
        data.append(c_array("SLB", ing["box_LB"]))
        data.append(c_array("SUB", ing["box_UB"]))
    if not use_soc:
        data.append(c_array("LBY", ing["LBy"]))
        data.append(c_array("UBY", ing["UBy"]))

    if opt.in_engineering:
        data += _eng_c_arrays(sys, n, m)
    src = _HMPC_SPLIT_TEMPLATE.format(name=name, data="\n".join(data))
    if opt.in_engineering:
        src = _apply_engineering(src)
    header = _std_header(
        name,
        "const double *x0, const double *xr, const double *ur,\n"
        "                 double *u_opt, int *k_out, double *z_out, "
        "double *s_out,\n"
        "                 double *lam_out, double *mu_out, "
        "double *times_ms")
    return _write_and_compile(name, src, header, directory, compile,
                              opt)


# ---------------------------------------------------------------------------
# ellipHMPC — harmonic MPC with coupled-output constraints, decomposed refs
# ---------------------------------------------------------------------------

_ELLIPHMPC_TEMPLATE = r"""
/* {name} — generated by spcies_tpu (harmonic MPC with coupled-output
 * constraints; reference code_ellipHMPC_ADMM_C.c in this framework's dense
 * M1/M2 representation). The reference is given DECOMPOSED into harmonic
 * components: 7 inputs (x0, xre, xrs, xrc, ure, urs, urc), like the
 * generated MEX (struct_ellipHMPC_ADMM_C_Matlab.c:27). Single-split ADMM:
 *   z   = M1 (q + C'(rho (s - d) + lam)) + M2 b0
 *   s   = proj(-(C z - d) - rho^-1 lam): box on output rows,
 *         sigma-tightened D-set (or SOC) on the harmonic cones
 *   lam += rho (C z - d + s)
 */
#include "{name}.h"
#include <math.h>
#include <string.h>
#include <time.h>

{data}

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

int {name}_solve(const double *x0, const double *xre, const double *xrs,
                 const double *xrc, const double *ure, const double *urs,
                 const double *urc, double *u_opt, int *k_out,
                 double *z_out, double *s_out, double *lam_out,
                 double *times_ms)
{{
    struct timespec ts0, ts1, ts2, ts3;
    clock_gettime(CLOCK_MONOTONIC_RAW, &ts0);

    double q[DIM], q_hat[DIM], z[DIM], aux_b[DIM];
    double s[NSROWS], s1[NSROWS], lam[NSROWS], czd[NSROWS];
    double b0[NS];

    memset(s, 0, sizeof(s));
    memset(s1, 0, sizeof(s1));
    memset(lam, 0, sizeof(lam));

    /* q = -[0_ns; Te xre + Q x0; Th xrs; Th xrc + Q x0;
     *       Se ure; Sh urs; Sh urc]   (code_ellipHMPC_ADMM_C.c:100-130) */
    memset(q, 0, sizeof(q));
    for (int i = 0; i < NS; i++) {{
        double qx = 0.0, te = 0.0, ths = 0.0, thc = 0.0;
        for (int j = 0; j < NS; j++) {{
            qx += QMAT[i][j] * x0[j];
            te += TEMAT[i][j] * xre[j];
            ths += THMAT[i][j] * xrs[j];
            thc += THMAT[i][j] * xrc[j];
        }}
        q[NSTAGE + i] = -te - qx;
        q[NSTAGE + NS + i] = -ths;
        q[NSTAGE + 2 * NS + i] = -thc - qx;
    }}
    for (int i = 0; i < MS; i++) {{
        double se = 0.0, shs = 0.0, shc = 0.0;
        for (int j = 0; j < MS; j++) {{
            se += SEMAT[i][j] * ure[j];
            shs += SHMAT[i][j] * urs[j];
            shc += SHMAT[i][j] * urc[j];
        }}
        q[NSTAGE + 3 * NS + i] = -se;
        q[NSTAGE + 3 * NS + MS + i] = -shs;
        q[NSTAGE + 3 * NS + 2 * MS + i] = -shc;
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
            proj_ssoc3(y, 1.0, LBYT[c]);
            proj_ssoc3(y, -1.0, UBYT[c]);
#endif
        }}

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


def generate_c_elliphmpc_solver(sys: dict, param: dict, *,
                                options: Options | None = None,
                                save_name: str | None = None,
                                directory: str = GENERATED_DIR,
                                compile: bool = True,
                                **solver_overrides) -> str:
    """Generate (and compile) a standalone ellipHMPC ADMM C solver
    (coupled-output harmonic MPC, decomposed 7-input reference)."""
    from spcies_tpu_torch.formulations.hmpc import hmpc_common_ingredients
    opt = options or default_options("ellipHMPC", "ADMM",
                                     **solver_overrides)
    opt.solver["box_constraints"] = False
    ing = hmpc_common_ingredients(sys, param, opt, split=False)
    n, m, N = ing["n"], ing["m"], ing["N"]
    dim, n_s, n_box = ing["dim"], ing["n_s"], ing["n_box"]
    use_soc = ing["use_soc"]
    n_cones = ing["n_soc"] if use_soc else ing["n_y"]
    rho = float(opt.solver["rho"])
    sigma = float(opt.solver.get("sigma", 0.0))
    name = save_name or "elliphmpc_admm"
    name = _unused_name(name, directory, opt)

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
    data.append(c_array("THMAT", ing["Th"]))
    data.append(c_array("SEMAT", ing["Se"]))
    data.append(c_array("SHMAT", ing["Sh"]))
    data.append(c_array("M1", M1))
    data.append(c_array("M2", M2))
    data.append(c_array("CMAT", ing["C"]))
    data.append(c_array("DVEC", ing["d"]))
    data.append(c_array("LBB", ing["box_LB"]))
    data.append(c_array("UBB", ing["box_UB"]))
    if not use_soc:
        # sigma-tightened D-set bounds
        # (compute_ellipHMPC_ADMM_ingredients.m:230-231)
        data.append(c_array("LBYT", ing["LBy"] + sigma))
        data.append(c_array("UBYT", ing["UBy"] - sigma))

    if opt.in_engineering:
        data += _eng_c_arrays(sys, n, m)
    src = _ELLIPHMPC_TEMPLATE.format(name=name, data="\n".join(data))
    if opt.in_engineering:
        src = _apply_engineering(
            src, inputs=(("x0", "x"), ("xre", "x"), ("xrs", "xa"),
                         ("xrc", "xa"), ("ure", "u"), ("urs", "ua"),
                         ("urc", "ua")))
    header = _std_header(
        name,
        "const double *x0, const double *xre, const double *xrs,\n"
        "                 const double *xrc, const double *ure, "
        "const double *urs,\n"
        "                 const double *urc, double *u_opt, int *k_out,\n"
        "                 double *z_out, double *s_out, double *lam_out,\n"
        "                 double *times_ms")
    return _write_and_compile(name, src, header, directory, compile,
                              opt)
