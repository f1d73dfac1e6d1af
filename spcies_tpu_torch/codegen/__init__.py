"""Plain-C solver generation for the PyTorch port: the embedded arm of the
package, fed from the port's own fp64 numpy ingredients. It writes the
same C sources as spcies_tpu.codegen, byte for byte, from the same sys,
param and options."""

from spcies_tpu_torch.codegen.emit_c import (
    generate_c_solver, generate_c_fista_solver,
    generate_c_mpct_eadmm_solver, generate_c_hmpc_solver,
    generate_c_tv_solver, generate_c_tv_fista_solver, generate_cl_demo,
    clear_generated)
from spcies_tpu_torch.codegen.emit_c_ext import (
    generate_c_mpct_cs_solver, generate_c_mpct_semiband_solver,
    generate_c_ellipmpc_soc_solver, generate_c_hmpc_split_solver,
    generate_c_elliphmpc_solver)
from spcies_tpu_torch.codegen.dispatch import generate_embedded_solver
from spcies_tpu_torch.codegen.cbridge import (
    CompiledCSolver, CompiledCFistaSolver, CompiledCMpctEadmmSolver,
    CompiledCHmpcSolver, CompiledCSemibandSolver, CompiledCSplitSolver,
    CompiledCEllipHmpcSolver, CompiledCTvSolver, CompiledCTvFistaSolver)

__all__ = ["generate_c_solver", "generate_c_fista_solver",
           "generate_c_mpct_eadmm_solver", "generate_c_hmpc_solver",
           "generate_c_mpct_cs_solver", "generate_c_mpct_semiband_solver",
           "generate_c_ellipmpc_soc_solver", "generate_c_hmpc_split_solver",
           "generate_c_elliphmpc_solver", "generate_embedded_solver",
           "generate_c_tv_solver", "generate_c_tv_fista_solver",
           "generate_cl_demo",
           "clear_generated",
           "CompiledCSolver", "CompiledCFistaSolver",
           "CompiledCMpctEadmmSolver", "CompiledCHmpcSolver",
           "CompiledCSemibandSolver", "CompiledCSplitSolver",
           "CompiledCEllipHmpcSolver", "CompiledCTvSolver",
           "CompiledCTvFistaSolver"]
