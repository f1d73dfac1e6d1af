"""ctypes bridge to a generated C solver — the analogue of the reference's
MEX bridges (struct_laxMPC_ADMM_C_Matlab.c:8-170): argument validation +
output marshalling around the compiled native solve function. Numpy in
and numpy out, as in spcies_tpu/codegen/cbridge.py.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np


class CompiledCSolver:
    """Loads lib<name>.so produced by generate_c_solver and exposes the
    same (u, k, e_flag, sol) interface as the batched solvers (per problem,
    not batched — this is the embedded deployment path). precision must
    match the generation-time option ('double'/'float',
    Spcies_options.m:66)."""

    def __init__(self, name: str, n: int, m: int, nz: int,
                 directory: str = "generated_solvers",
                 precision: str = "double"):
        self.n, self.m, self.nz = n, m, nz
        self.dtype = np.float64 if precision == "double" else np.float32
        path = os.path.join(directory, f"lib{name}.so")
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"{path} not found; run generate_c_solver first")
        self._lib = ctypes.CDLL(os.path.abspath(path))
        self._fn = getattr(self._lib, f"{name}_solve")
        dptr = np.ctypeslib.ndpointer(dtype=self.dtype, flags="C")
        self._fn.argtypes = [dptr, dptr, dptr, dptr,
                             ctypes.POINTER(ctypes.c_int), dptr, dptr, dptr,
                             dptr]
        self._fn.restype = ctypes.c_int

    def __call__(self, x0, xr, ur):
        x0 = np.ascontiguousarray(x0, dtype=self.dtype).ravel()
        xr = np.ascontiguousarray(xr, dtype=self.dtype).ravel()
        ur = np.ascontiguousarray(ur, dtype=self.dtype).ravel()
        if x0.size != self.n or xr.size != self.n or ur.size != self.m:
            raise ValueError(
                f"expected x0/xr of dim {self.n} and ur of dim {self.m}")
        u = np.zeros(self.m, self.dtype)
        z = np.zeros(self.nz, self.dtype)
        v = np.zeros(self.nz, self.dtype)
        lam = np.zeros(self.nz, self.dtype)
        k = ctypes.c_int(0)
        tms = np.zeros(4, self.dtype)
        e_flag = self._fn(x0, xr, ur, u, ctypes.byref(k), z, v, lam,
                          tms)
        return u, int(k.value), int(e_flag), dict(
            z=z, v=v, lam=lam, update_time_ms=float(tms[0]),
            solve_time_ms=float(tms[1]), polish_time_ms=float(tms[2]),
            run_time_ms=float(tms[3]))


class CompiledCFistaSolver:
    """ctypes bridge for generated FISTA C solvers (z, lam outputs; no v)."""

    def __init__(self, name: str, n: int, m: int, N: int, nz: int,
                 directory: str = "generated_solvers",
                 precision: str = "double"):
        self.n, self.m, self.N, self.nz = n, m, N, nz
        self.dtype = np.float64 if precision == "double" else np.float32
        path = os.path.join(directory, f"lib{name}.so")
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"{path} not found; run generate_c_fista_solver first")
        self._lib = ctypes.CDLL(os.path.abspath(path))
        self._fn = getattr(self._lib, f"{name}_solve")
        dptr = np.ctypeslib.ndpointer(dtype=self.dtype, flags="C")
        self._fn.argtypes = [dptr, dptr, dptr, dptr,
                             ctypes.POINTER(ctypes.c_int), dptr, dptr,
                             dptr]
        self._fn.restype = ctypes.c_int

    def __call__(self, x0, xr, ur):
        x0 = np.ascontiguousarray(x0, dtype=self.dtype).ravel()
        xr = np.ascontiguousarray(xr, dtype=self.dtype).ravel()
        ur = np.ascontiguousarray(ur, dtype=self.dtype).ravel()
        u = np.zeros(self.m, self.dtype)
        z = np.zeros(self.nz, self.dtype)
        lam = np.zeros(self.N * self.n, self.dtype)
        k = ctypes.c_int(0)
        tms = np.zeros(4, self.dtype)
        e_flag = self._fn(x0, xr, ur, u, ctypes.byref(k), z, lam,
                          tms)
        return u, int(k.value), int(e_flag), dict(
            z=z, lam=lam, update_time_ms=float(tms[0]),
            solve_time_ms=float(tms[1]), polish_time_ms=float(tms[2]),
            run_time_ms=float(tms[3]))


class CompiledCMpctEadmmSolver:
    """ctypes bridge for generated MPCT-EADMM C solvers
    (z1, z2, z3, lam outputs — the 3-block iterate set)."""

    def __init__(self, name: str, n: int, m: int, N: int,
                 directory: str = "generated_solvers",
                 precision: str = "double"):
        self.n, self.m, self.N = n, m, N
        self.dtype = np.float64 if precision == "double" else np.float32
        self.nz1 = (N + 1) * (n + m)
        self.nrow = self.nz1 + n + (n + m)
        path = os.path.join(directory, f"lib{name}.so")
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"{path} not found; run generate_c_mpct_eadmm_solver first")
        self._lib = ctypes.CDLL(os.path.abspath(path))
        self._fn = getattr(self._lib, f"{name}_solve")
        dptr = np.ctypeslib.ndpointer(dtype=self.dtype, flags="C")
        self._fn.argtypes = [dptr, dptr, dptr, dptr,
                             ctypes.POINTER(ctypes.c_int), dptr, dptr, dptr,
                             dptr, dptr]
        self._fn.restype = ctypes.c_int

    def __call__(self, x0, xr, ur):
        x0 = np.ascontiguousarray(x0, dtype=self.dtype).ravel()
        xr = np.ascontiguousarray(xr, dtype=self.dtype).ravel()
        ur = np.ascontiguousarray(ur, dtype=self.dtype).ravel()
        if x0.size != self.n or xr.size != self.n or ur.size != self.m:
            raise ValueError(
                f"expected x0/xr of dim {self.n} and ur of dim {self.m}")
        u = np.zeros(self.m, self.dtype)
        z1 = np.zeros(self.nz1, self.dtype)
        z2 = np.zeros(self.n + self.m, self.dtype)
        z3 = np.zeros(self.nz1, self.dtype)
        lam = np.zeros(self.nrow, self.dtype)
        k = ctypes.c_int(0)
        tms = np.zeros(4, self.dtype)
        e_flag = self._fn(x0, xr, ur, u, ctypes.byref(k), z1, z2, z3, lam,
                          tms)
        return u, int(k.value), int(e_flag), dict(
            z1=z1, z2=z2, z3=z3, lam=lam, update_time_ms=float(tms[0]),
            solve_time_ms=float(tms[1]), polish_time_ms=float(tms[2]),
            run_time_ms=float(tms[3]))


class CompiledCHmpcSolver:
    """ctypes bridge for generated HMPC single-split ADMM C solvers
    (z [dim], s [n_s], lam [n_s] outputs)."""

    def __init__(self, name: str, n: int, m: int, dim: int, n_s: int,
                 directory: str = "generated_solvers",
                 precision: str = "double"):
        self.n, self.m, self.dim, self.n_s = n, m, dim, n_s
        self.dtype = np.float64 if precision == "double" else np.float32
        path = os.path.join(directory, f"lib{name}.so")
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"{path} not found; run generate_c_hmpc_solver first")
        self._lib = ctypes.CDLL(os.path.abspath(path))
        self._fn = getattr(self._lib, f"{name}_solve")
        dptr = np.ctypeslib.ndpointer(dtype=self.dtype, flags="C")
        self._fn.argtypes = [dptr, dptr, dptr, dptr,
                             ctypes.POINTER(ctypes.c_int), dptr, dptr, dptr,
                             dptr]
        self._fn.restype = ctypes.c_int

    def __call__(self, x0, xr, ur):
        x0 = np.ascontiguousarray(x0, dtype=self.dtype).ravel()
        xr = np.ascontiguousarray(xr, dtype=self.dtype).ravel()
        ur = np.ascontiguousarray(ur, dtype=self.dtype).ravel()
        if x0.size != self.n or xr.size != self.n or ur.size != self.m:
            raise ValueError(
                f"expected x0/xr of dim {self.n} and ur of dim {self.m}")
        u = np.zeros(self.m, self.dtype)
        z = np.zeros(self.dim, self.dtype)
        s = np.zeros(self.n_s, self.dtype)
        lam = np.zeros(self.n_s, self.dtype)
        k = ctypes.c_int(0)
        tms = np.zeros(4, self.dtype)
        e_flag = self._fn(x0, xr, ur, u, ctypes.byref(k), z, s, lam,
                          tms)
        return u, int(k.value), int(e_flag), dict(
            z=z, s=s, lam=lam, update_time_ms=float(tms[0]),
            solve_time_ms=float(tms[1]), polish_time_ms=float(tms[2]),
            run_time_ms=float(tms[3]))

class CompiledCSemibandSolver:
    """ctypes bridge for generated MPCT ADMM-semiband C solvers
    (z [nz], v [nv], lam [nv] outputs — nv > nz when the constrained-output
    flag adds per-stage output rows)."""

    def __init__(self, name: str, n: int, m: int, nz: int, nv: int,
                 directory: str = "generated_solvers",
                 precision: str = "double"):
        self.n, self.m, self.nz, self.nv = n, m, nz, nv
        self.dtype = np.float64 if precision == "double" else np.float32
        path = os.path.join(directory, f"lib{name}.so")
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"{path} not found; run generate_c_mpct_semiband_solver "
                "first")
        self._lib = ctypes.CDLL(os.path.abspath(path))
        self._fn = getattr(self._lib, f"{name}_solve")
        dptr = np.ctypeslib.ndpointer(dtype=self.dtype, flags="C")
        self._fn.argtypes = [dptr, dptr, dptr, dptr,
                             ctypes.POINTER(ctypes.c_int), dptr, dptr, dptr,
                             dptr]
        self._fn.restype = ctypes.c_int

    def __call__(self, x0, xr, ur):
        x0 = np.ascontiguousarray(x0, dtype=self.dtype).ravel()
        xr = np.ascontiguousarray(xr, dtype=self.dtype).ravel()
        ur = np.ascontiguousarray(ur, dtype=self.dtype).ravel()
        if x0.size != self.n or xr.size != self.n or ur.size != self.m:
            raise ValueError(
                f"expected x0/xr of dim {self.n} and ur of dim {self.m}")
        u = np.zeros(self.m, self.dtype)
        z = np.zeros(self.nz, self.dtype)
        v = np.zeros(self.nv, self.dtype)
        lam = np.zeros(self.nv, self.dtype)
        k = ctypes.c_int(0)
        tms = np.zeros(4, self.dtype)
        e_flag = self._fn(x0, xr, ur, u, ctypes.byref(k), z, v, lam,
                          tms)
        return u, int(k.value), int(e_flag), dict(
            z=z, v=v, lam=lam, update_time_ms=float(tms[0]),
            solve_time_ms=float(tms[1]), polish_time_ms=float(tms[2]),
            run_time_ms=float(tms[3]))


class CompiledCSplitSolver:
    """ctypes bridge for the two-dual split solvers: ellipMPC ADMM-soc
    (with a runtime radius input) and HMPC ADMM/SADMM-split.
    Outputs: z [dim], s [n_s], lam [dim], mu [n_s]."""

    def __init__(self, name: str, n: int, m: int, dim: int, n_s: int,
                 has_radius: bool = False,
                 directory: str = "generated_solvers",
                 precision: str = "double"):
        self.n, self.m, self.dim, self.n_s = n, m, dim, n_s
        self.has_radius = has_radius
        self.dtype = np.float64 if precision == "double" else np.float32
        path = os.path.join(directory, f"lib{name}.so")
        if not os.path.exists(path):
            raise FileNotFoundError(f"{path} not found; generate it first")
        self._lib = ctypes.CDLL(os.path.abspath(path))
        self._fn = getattr(self._lib, f"{name}_solve")
        dptr = np.ctypeslib.ndpointer(dtype=self.dtype, flags="C")
        args = [dptr, dptr, dptr]
        if has_radius:
            args.append(ctypes.c_double if self.dtype == np.float64
                        else ctypes.c_float)
        args += [dptr, ctypes.POINTER(ctypes.c_int), dptr, dptr, dptr,
                 dptr, dptr]
        self._fn.argtypes = args
        self._fn.restype = ctypes.c_int

    def __call__(self, x0, xr, ur, r_ellip=None):
        x0 = np.ascontiguousarray(x0, dtype=self.dtype).ravel()
        xr = np.ascontiguousarray(xr, dtype=self.dtype).ravel()
        ur = np.ascontiguousarray(ur, dtype=self.dtype).ravel()
        if x0.size != self.n or xr.size != self.n or ur.size != self.m:
            raise ValueError(
                f"expected x0/xr of dim {self.n} and ur of dim {self.m}")
        u = np.zeros(self.m, self.dtype)
        z = np.zeros(self.dim, self.dtype)
        s = np.zeros(self.n_s, self.dtype)
        lam = np.zeros(self.dim, self.dtype)
        mu = np.zeros(self.n_s, self.dtype)
        k = ctypes.c_int(0)
        tms = np.zeros(4, self.dtype)
        inputs = [x0, xr, ur]
        if self.has_radius:
            inputs.append((ctypes.c_double if self.dtype == np.float64
                           else ctypes.c_float)(float(r_ellip)))
        e_flag = self._fn(*inputs, u, ctypes.byref(k), z, s, lam, mu,
                          tms)
        return u, int(k.value), int(e_flag), dict(
            z=z, s=s, lam=lam, mu=mu, update_time_ms=float(tms[0]),
            solve_time_ms=float(tms[1]), polish_time_ms=float(tms[2]),
            run_time_ms=float(tms[3]))


class CompiledCEllipHmpcSolver:
    """ctypes bridge for generated ellipHMPC ADMM C solvers: 7 inputs
    (x0, xre, xrs, xrc, ure, urs, urc), outputs z [dim], s [n_s],
    lam [n_s] — the reference MEX's decomposed-reference signature
    (struct_ellipHMPC_ADMM_C_Matlab.c:27)."""

    def __init__(self, name: str, n: int, m: int, dim: int, n_s: int,
                 directory: str = "generated_solvers",
                 precision: str = "double"):
        self.n, self.m, self.dim, self.n_s = n, m, dim, n_s
        self.dtype = np.float64 if precision == "double" else np.float32
        path = os.path.join(directory, f"lib{name}.so")
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"{path} not found; run generate_c_elliphmpc_solver first")
        self._lib = ctypes.CDLL(os.path.abspath(path))
        self._fn = getattr(self._lib, f"{name}_solve")
        dptr = np.ctypeslib.ndpointer(dtype=self.dtype, flags="C")
        self._fn.argtypes = [dptr] * 7 + [
            dptr, ctypes.POINTER(ctypes.c_int), dptr, dptr, dptr,
            dptr]
        self._fn.restype = ctypes.c_int

    def __call__(self, x0, xre, xrs, xrc, ure, urs, urc):
        refs = [np.ascontiguousarray(a, dtype=self.dtype).ravel()
                for a in (x0, xre, xrs, xrc, ure, urs, urc)]
        u = np.zeros(self.m, self.dtype)
        z = np.zeros(self.dim, self.dtype)
        s = np.zeros(self.n_s, self.dtype)
        lam = np.zeros(self.n_s, self.dtype)
        k = ctypes.c_int(0)
        tms = np.zeros(4, self.dtype)
        e_flag = self._fn(*refs, u, ctypes.byref(k), z, s, lam,
                          tms)
        return u, int(k.value), int(e_flag), dict(
            z=z, s=s, lam=lam, update_time_ms=float(tms[0]),
            solve_time_ms=float(tms[1]), polish_time_ms=float(tms[2]),
            run_time_ms=float(tms[3]))


class CompiledCTvSolver:
    """ctypes bridge for TIME_VARYING generated C solvers: the reference's
    9-input signature (x0, xr, ur, A, B, Qdiag, Rdiag, LB, UB)
    (struct_laxMPC_ADMM_C_Matlab.c:29-88, TIME_VARYING=1)."""

    def __init__(self, name: str, n: int, m: int, nz: int,
                 directory: str = "generated_solvers",
                 precision: str = "double"):
        self.n, self.m, self.nz = n, m, nz
        self.dtype = np.float64 if precision == "double" else np.float32
        path = os.path.join(directory, f"lib{name}.so")
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"{path} not found; run generate_c_tv_solver first")
        self._lib = ctypes.CDLL(os.path.abspath(path))
        self._fn = getattr(self._lib, f"{name}_solve")
        dptr = np.ctypeslib.ndpointer(dtype=self.dtype, flags="C")
        self._fn.argtypes = [dptr] * 9 + [
            dptr, ctypes.POINTER(ctypes.c_int), dptr, dptr, dptr, dptr]
        self._fn.restype = ctypes.c_int

    def __call__(self, x0, xr, ur, A, B, Qd, Rd, LB, UB):
        n, m = self.n, self.m
        args = [np.ascontiguousarray(a, dtype=self.dtype)
                for a in (x0, xr, ur, A, B, Qd, Rd, LB, UB)]
        shapes = [(n,), (n,), (m,), (n, n), (n, m), (n,), (m,),
                  (n + m,), (n + m,)]
        for a, sh in zip(args, shapes):
            if a.reshape(-1).size != int(np.prod(sh)):
                raise ValueError(f"expected input of shape {sh}")
        args = [a.reshape(-1) for a in args]
        u = np.zeros(m, self.dtype)
        z = np.zeros(self.nz, self.dtype)
        v = np.zeros(self.nz, self.dtype)
        lam = np.zeros(self.nz, self.dtype)
        k = ctypes.c_int(0)
        tms = np.zeros(4, self.dtype)
        e_flag = self._fn(*args, u, ctypes.byref(k), z, v, lam, tms)
        return u, int(k.value), int(e_flag), dict(
            z=z, v=v, lam=lam, update_time_ms=float(tms[0]),
            solve_time_ms=float(tms[1]), polish_time_ms=float(tms[2]),
            run_time_ms=float(tms[3]))


class CompiledCTvFistaSolver:
    """ctypes bridge for TIME_VARYING generated FISTA C solvers (9 inputs,
    z/lam outputs)."""

    def __init__(self, name: str, n: int, m: int, N: int, nz: int,
                 directory: str = "generated_solvers",
                 precision: str = "double"):
        self.n, self.m, self.N, self.nz = n, m, N, nz
        self.dtype = np.float64 if precision == "double" else np.float32
        path = os.path.join(directory, f"lib{name}.so")
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"{path} not found; run generate_c_tv_fista_solver first")
        self._lib = ctypes.CDLL(os.path.abspath(path))
        self._fn = getattr(self._lib, f"{name}_solve")
        dptr = np.ctypeslib.ndpointer(dtype=self.dtype, flags="C")
        self._fn.argtypes = [dptr] * 9 + [
            dptr, ctypes.POINTER(ctypes.c_int), dptr, dptr, dptr]
        self._fn.restype = ctypes.c_int

    def __call__(self, x0, xr, ur, A, B, Qd, Rd, LB, UB):
        args = [np.ascontiguousarray(a, dtype=self.dtype).reshape(-1)
                for a in (x0, xr, ur, A, B, Qd, Rd, LB, UB)]
        u = np.zeros(self.m, self.dtype)
        z = np.zeros(self.nz, self.dtype)
        lam = np.zeros(self.N * self.n, self.dtype)
        k = ctypes.c_int(0)
        tms = np.zeros(4, self.dtype)
        e_flag = self._fn(*args, u, ctypes.byref(k), z, lam, tms)
        return u, int(k.value), int(e_flag), dict(
            z=z, lam=lam, update_time_ms=float(tms[0]),
            solve_time_ms=float(tms[1]), polish_time_ms=float(tms[2]),
            run_time_ms=float(tms[3]))
