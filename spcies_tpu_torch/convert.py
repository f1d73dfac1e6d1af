"""State carried across from the JAX package.

A solver's state is its ingredient dict: the offline fp64 matrices and
scalars a builder bakes into the online loop. The JAX package exposes it as
`solver.ingredients` (numpy arrays and Python scalars); the port's builders
take the same keys (`make_solver(..., ingredients=...)`), so one set of
numbers can drive both packages. A banded builder reads the keys of
BANDED_KEYS where its triple has an entry; HMPC-ADMM's and the split
pair's banded backends form their structured KKT from the common HMPC
ingredients (H, G, C and the rest) and need no keys beyond them: their
BANDED_KEYS entries are their BUILDER_KEYS entries.
"""

from __future__ import annotations

import numpy as np

_ADMM_RHO = ("rho_is_scalar", "rho_scalar", "rho_vec", "rho_inv_vec")
_FISTA = ("hinv_diag", "G", "Winv")
# hmpc_common_ingredients; the builders form M1 and M2 from H, G and C
_HMPC = ("n", "m", "N", "n_y", "ns", "dim", "n_eq", "n_s", "n_box", "n_soc",
         "A", "B", "Q", "Te", "Se", "Th", "Sh", "H", "G", "C", "d",
         "box_constraints", "use_soc", "box_LB", "box_UB", "stage_LB",
         "stage_UB", "LBy", "UBy")

# (formulation, method, submethod) -> the keys that triple's builders read
BUILDER_KEYS = {
    ("laxMPC", "ADMM", ""): ("n", "m", "N", "nz", *_ADMM_RHO, "A", "Qd",
                             "Rd", "T", "M_q", "M_b", "LB_z", "UB_z"),
    ("laxMPC", "FISTA", ""): ("n", "m", "N", "nz", "A", "Qd", "Rd", "T",
                              *_FISTA, "LB_z", "UB_z"),
    ("equMPC", "ADMM", ""): ("n", "m", "N", "nz", *_ADMM_RHO, "A", "Qd",
                             "Rd", "M_q", "M_b0", "M_bN", "LB_z", "UB_z"),
    ("equMPC", "FISTA", ""): ("n", "m", "N", "nz", "A", "Qd", "Rd",
                              *_FISTA, "LB_z", "UB_z"),
    ("MPCT", "EADMM", ""): ("n", "m", "N", "nm", "nz1", "nrow", "T", "S",
                            "rho", "H1i", "W2", "M3", "LB", "UB"),
    ("MPCT", "ADMM", "cs"): ("n", "m", "N", "nz", *_ADMM_RHO, "T", "S",
                             "M_q", "M_b", "LB", "UB"),
    ("MPCT", "ADMM", "semiband"): ("n", "m", "N", "p", "nz", "nv",
                                   "rho_is_scalar", "rho_scalar", "rho_vec",
                                   "T", "S", "M_q", "M_b", "C_tilde", "LBv",
                                   "UBv", "soft_mask", "beta", "soft",
                                   "constrained_output"),
    ("ellipMPC", "ADMM", ""): ("n", "m", "N", "nz", "A", "Qd", "Rd", "T",
                               "rho_is_scalar", "rho_s", "rho_T", "P",
                               "P_half", "Pinv_half", "c", "r", "M_q",
                               "M_b", "LB", "UB"),
    ("ellipMPC", "ADMM", "soc"): ("n", "m", "N", "dim", "n_s", "A", "Qd",
                                  "Rd", "T", "sigma", "rho", "M1", "M2_b0",
                                  "M2_r", "M2_d", "PhiP", "LB", "UB",
                                  "r_default"),
    ("HMPC", "ADMM", ""): _HMPC,
    ("HMPC", "ADMM", "split"): _HMPC,
    ("HMPC", "SADMM", "split"): _HMPC,
    ("ellipHMPC", "ADMM", ""): _HMPC,
}

# the band-Cholesky blocks and stagewise operators of backend='banded'
_BAND = ("A", "B", "AB", "Alpha", "Beta")
_ADMM_BAND = ("Hi_0", "Hi_mid")

# (formulation, method, submethod) -> the keys that triple's banded
# builder reads, where it has one
BANDED_KEYS = {
    ("laxMPC", "ADMM", ""): ("n", "m", "N", "nz", *_ADMM_RHO, "Qd", "Rd",
                             "T", *_BAND, *_ADMM_BAND, "Hi_N", "LB_z",
                             "UB_z"),
    ("laxMPC", "FISTA", ""): ("n", "m", "N", "nz", "Qd", "Rd", "T",
                              "hinv_diag", *_BAND, "LB_z", "UB_z"),
    ("equMPC", "ADMM", ""): ("n", "m", "N", "nz", *_ADMM_RHO, "Qd", "Rd",
                             *_BAND, *_ADMM_BAND, "LB_z", "UB_z"),
    ("equMPC", "FISTA", ""): ("n", "m", "N", "nz", "Qd", "Rd", "hinv_diag",
                              *_BAND, "LB_z", "UB_z"),
    ("ellipMPC", "ADMM", ""): ("n", "m", "N", "nz", "Qd", "Rd", "T",
                               "rho_is_scalar", "rho_s", "rho_T", "P",
                               "P_half", "Pinv_half", "c", "r", *_BAND,
                               *_ADMM_BAND, "Hi_N", "LB", "UB"),
    # mpct_cs_banded_ingredients
    ("MPCT", "ADMM", "cs"): ("n", "m", "N", "nz", "sd", "bmax", *_ADMM_RHO,
                             "T", "S", "Hinv_st", "E0", "Cst", "Dst", "Fst",
                             "Alpha", "BetaInv", "LB", "UB"),
    # mpct_admm_semiband_ingredients(..., structured=True)
    ("MPCT", "ADMM", "semiband"): ("n", "m", "N", "p", "nz", "nv",
                                   "rho_is_scalar", "rho_scalar", "rho_vec",
                                   "A", "B", "T", "S", "blocks_inv", "Gu",
                                   "Gv", "K1", "Alpha", "BetaInv", "Pu",
                                   "Vt", "K2", "stage_map", "LBv", "UBv",
                                   "soft_mask", "beta", "soft",
                                   "constrained_output"),
    ("HMPC", "ADMM", ""): _HMPC,
    ("HMPC", "ADMM", "split"): _HMPC,
    ("HMPC", "SADMM", "split"): _HMPC,
}


def ingredients_from_jax(ing: dict, formulation: str = "laxMPC",
                         method: str = "ADMM", submethod: str = "",
                         backend: str = "dense") -> dict:
    """Copy a JAX solver's ingredient dict into the port's form: arrays
    become fp64 numpy arrays (integer and bool arrays keep their dtype),
    Python and numpy scalars become Python scalars. Raises KeyError if a
    key the port's (formulation, method, submethod) builder for `backend`
    reads is missing ('banded': BANDED_KEYS; any other: BUILDER_KEYS)."""
    triple = (formulation, method, submethod)
    layouts = BANDED_KEYS if backend == "banded" else BUILDER_KEYS
    if triple not in layouts:
        raise KeyError(f"no ingredient layout for {triple} on backend "
                       f"{backend!r}; known: {sorted(layouts)}")
    missing = [k for k in layouts[triple] if k not in ing]
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
