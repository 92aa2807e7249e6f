"""amg_jax — sparse linear algebra + asynchronous algebraic multigrid in JAX.

A from-scratch JAX/XLA framework with the capabilities of the reference
C++ MPI/OpenMP code `jwp3/async-multigrid` (see SURVEY.md): CSR/ELL sparse
kernels, AMG hierarchy construction (strength-of-connection, PMIS/HMIS
coarsening, direct/ext+i interpolation, Galerkin RAP), the full smoother family
(weighted/L1 Jacobi, hybrid Jacobi-Gauss-Seidel, symmetric variants,
asynchronous relaxation, stochastic Southwell), and the complete solver
taxonomy: multiplicative V-cycles plus the additive multadd / AFACx / AFACj /
BPX cycles in synchronous and asynchronous (bounded-staleness) forms, with
Chebyshev/Richardson acceleration and PCG outer iteration — single-chip and
sharded over `jax.sharding.Mesh` device meshes.

Design stance (accelerator-first, not a port):
  * setup (coarsening / interpolation / RAP SpGEMM) runs host-side once per
    matrix in float64; solve-time state lives on device in ELL / stencil form.
  * the coarsest-grid direct solve is a precomputed dense inverse applied by a
    single matmul, the counterpart of the reference's gathered Gaussian
    elimination (`hypre_GaussElimSetup/Solve`).
  * asynchronous execution is a bounded-staleness state machine over
    bulk-synchronous XLA steps — the honest accelerator realization of the
    reference's relaxed-consistency OpenMP/MPI model, matching the semantics of its own
    sequential simulators (reference: src/SEQ_AMG.cpp:237-793).
"""

import jax as _jax

# AMG requires float64 for setup and for matching reference convergence
# histories; the solve-time dtype is the platform policy's (amg_jax.dtypes).
_jax.config.update("jax_enable_x64", True)

from amg_jax import dtypes  # noqa: E402
from amg_jax.sparse.csr import CSRMatrix  # noqa: E402
from amg_jax.sparse.ell import ELLMatrix  # noqa: E402
from amg_jax.sparse.stencil import StencilOperator  # noqa: E402

__version__ = "0.1.0"
__all__ = [
    "CSRMatrix",
    "ELLMatrix",
    "StencilOperator",
    "dtypes",
]
