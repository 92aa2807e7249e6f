from amg_jax.sparse.bsr import BSRMatrix, bsr_fill_stats, bsr_from_csr
from amg_jax.sparse.csr import CSRMatrix
from amg_jax.sparse.ell import ELLMatrix
from amg_jax.sparse.stencil import StencilOperator

__all__ = [
    "BSRMatrix",
    "CSRMatrix",
    "ELLMatrix",
    "StencilOperator",
    "bsr_fill_stats",
    "bsr_from_csr",
]
