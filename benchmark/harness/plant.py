"""The program's (sys, param) and options from a configuration file.

The benchmark makes the plant's matrices and the terminal weight itself,
with the plain references' own code, and hands the same numbers to the
program and to the reference.
"""

from __future__ import annotations

import numpy as np
import scipy.linalg

from reference.common import plant_matrices


def sys_param(config: dict):
    """(sys, param) in the shape `make_solver` takes."""
    A, B = plant_matrices(config)
    plant = config["plant"]
    sys = dict(A=A, B=B, **{key: np.asarray(plant[key], float)
                            for key in ("LBx", "UBx", "LBu", "UBu")})
    param = dict(N=int(config["N"]))
    for key, diag in config["weights"].items():
        if diag == "dare":
            continue
        param[key] = np.diag(np.asarray(diag, float))
    if config["weights"].get("T") == "dare":
        param["T"] = scipy.linalg.solve_discrete_are(A, B, param["Q"],
                                                     param["R"])
    if "w" in config:
        param["w"] = float(config["w"])
    return sys, param


def options(sp, config: dict):
    """The program's Options of the configuration's solver settings."""
    opt = sp.default_options(config["formulation"], config["method"],
                             config.get("submethod", ""),
                             **config["solver"])
    opt.precision = config["precision"]
    return opt
