"""spcies_tpu_torch — the PyTorch/CUDA port of spcies_tpu, the batched MPC
solve engine.

The same public API as spcies_tpu, on PyTorch tensors on a chosen device:

    make_solver(sys, param, formulation=..., method=..., submethod=...,
                options=..., backend=..., device=...) -> BatchedSolver

Offline ingredients are computed in fp64 numpy, as in the JAX package; the
online loop runs as torch operations ('dense') or as one hand-written CUDA
kernel per solve ('fused', kernels/ and csrc/). Solvers run on the CUDA
card unless the caller passes device="cpu". This package never imports
jax or spcies_tpu.
"""

__version__ = "0.1.0"

from spcies_tpu_torch.config import (Options, Problem, default_options,
                                     SOLVER_REGISTRY,
                                     determine_formulation)
from spcies_tpu_torch.api import make_solver
from spcies_tpu_torch import systems
from spcies_tpu_torch import formulations
from spcies_tpu_torch import solvers
from spcies_tpu_torch import kernels
from spcies_tpu_torch import runtime
from spcies_tpu_torch import parallel
from spcies_tpu_torch import utils
from spcies_tpu_torch import oracle

__all__ = [
    "__version__",
    "Options",
    "Problem",
    "default_options",
    "SOLVER_REGISTRY",
    "determine_formulation",
    "make_solver",
    "systems",
    "formulations",
    "solvers",
    "kernels",
    "runtime",
    "parallel",
    "utils",
    "oracle",
]
