"""State carried across from the JAX package.

A solver's state is its ingredient dict: the offline fp64 matrices and
scalars a builder bakes into the online loop. The JAX package exposes it as
`solver.ingredients` (numpy arrays and Python scalars); the port's builders
take the same keys (`make_solver(..., ingredients=...)`), so one set of
numbers can drive both packages.
"""

from __future__ import annotations

import numpy as np

# the keys the laxMPC-ADMM builders read
LAXMPC_ADMM_KEYS = ("n", "m", "N", "nz", "rho_is_scalar", "rho_scalar",
                    "rho_vec", "rho_inv_vec", "A", "Qd", "Rd", "T", "M_q",
                    "M_b", "LB_z", "UB_z")


def ingredients_from_jax(ing: dict) -> dict:
    """Copy a JAX solver's ingredient dict into the port's form: arrays
    become fp64 numpy arrays (integer and bool arrays keep their dtype),
    Python and numpy scalars become Python scalars. Raises KeyError if a
    key the port's builder reads is missing."""
    missing = [k for k in LAXMPC_ADMM_KEYS if k not in ing]
    if missing:
        raise KeyError(f"ingredients lack {missing}")
    out = {}
    for key, val in ing.items():
        if val is None or isinstance(val, (bool, int, float, str)):
            out[key] = val
            continue
        arr = np.array(val)     # a copy, from numpy or any array type
        if arr.ndim == 0:
            out[key] = arr.item()
        elif np.issubdtype(arr.dtype, np.floating):
            out[key] = arr.astype(np.float64)
        else:
            out[key] = arr
    return out
