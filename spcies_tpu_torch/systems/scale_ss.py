"""Engineering-units scaling of a discrete state-space model.

Counterpart of spcies_tpu/systems/scale_ss.py (reference:
+sp_utils/scale_ss.m:27-41). Transforms (x_o, u_o) to incremental scaled
units x = Nx*(x_o - x0), u = Nu*(u_o - u0), scaling A/B and the box
constraints accordingly. Its output's Nx, Nu, x0 and u0 are the sys fields
the `in_engineering` option reads (api.BatchedSolver.set_engineering), whose
input scaling (BatchedSolver._to_incremental) is the same arithmetic as
the bounds' here. Plain numpy, as in the reference package.
"""

from __future__ import annotations

import numpy as np


def scale_ss(A, B, UBx, LBx, UBu, LBu, x0, u0, Nx, Nu):
    Nx = np.asarray(Nx, dtype=float).ravel()
    Nu = np.asarray(Nu, dtype=float).ravel()
    x0 = np.asarray(x0, dtype=float).ravel()
    u0 = np.asarray(u0, dtype=float).ravel()
    As = np.diag(Nx) @ np.asarray(A, dtype=float) @ np.diag(1.0 / Nx)
    Bs = np.diag(Nx) @ np.asarray(B, dtype=float) @ np.diag(1.0 / Nu)
    return dict(
        A=As, B=Bs,
        UBx=Nx * (np.asarray(UBx, float) - x0),
        LBx=Nx * (np.asarray(LBx, float) - x0),
        UBu=Nu * (np.asarray(UBu, float) - u0),
        LBu=Nu * (np.asarray(LBu, float) - u0),
        x0=x0, u0=u0, Nx=Nx, Nu=Nu,
    )
