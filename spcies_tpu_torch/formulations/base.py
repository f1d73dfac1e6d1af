"""Formulation builder registry.

The reference dispatches to per-triple constructor functions by string
concatenation + eval (`cons_<formulation>[_<method>][_<submethod>]_<platform>`,
spcies_gen_controller.m:111-130). Here the same plugin axis is an explicit
registry keyed on the (formulation, method, submethod) triple; user
formulations (the reference's formulations/+personal/ escape hatch) register
with the same decorator.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

BUILDERS: dict[tuple[str, str, str], Callable] = {}


def register_builder(formulation: str, method: str, submethod: str = ""):
    def deco(fn):
        BUILDERS[(formulation, method, submethod)] = fn
        return fn
    return deco


def get_builder(formulation: str, method: str, submethod: str = ""):
    key = (formulation, method, submethod)
    if key not in BUILDERS:
        raise NotImplementedError(
            f"No solver builder registered for {key}; available: "
            f"{sorted(BUILDERS)}")
    return BUILDERS[key]


def get_sys_matrices(sys: dict):
    """Extract (A, B, n, m) from a reference-style sys dict
    (spcies_gen_controller.m:77-93 field conventions)."""
    A = np.asarray(sys["A"], dtype=float)
    B = np.asarray(sys.get("B", sys.get("Bu")), dtype=float)
    return A, B, A.shape[0], B.shape[1]


def get_bounds(sys: dict, n: int, m: int, inf_value: float = 1e30):
    """Stage box bounds [LBx; LBu] / [UBx; UBu] with missing bounds defaulting
    to +-inf_value (the reference clamps infinities at codegen time,
    platforms/+C_code/dec_var.m write_value)."""
    LBx = np.asarray(sys.get("LBx", -inf_value * np.ones(n)), dtype=float).ravel()
    UBx = np.asarray(sys.get("UBx", inf_value * np.ones(n)), dtype=float).ravel()
    LBu = np.asarray(sys.get("LBu", -inf_value * np.ones(m)), dtype=float).ravel()
    UBu = np.asarray(sys.get("UBu", inf_value * np.ones(m)), dtype=float).ravel()
    return LBx, UBx, LBu, UBu
