"""Device-side ELL (padded-row) sparse matrix.

Accelerator sparse format: every row padded to the same width `k`, giving static
shapes and a regular gather — the layout XLA tiles well. This is the solve-time
analog of the per-level CSR blocks the reference extracts from hypre
(reference: src/SMEM_Setup.cpp:182-588) and of its fused CSR SpMV workhorse
`SMEM_SpGEMV` (reference: src/SMEM_MatVec.cpp:123-259).

SpMV is `(vals * x[cols]).sum(axis=1)`: one gather + one elementwise multiply +
a small-axis reduction, all fused by XLA into a single bandwidth-bound loop.
Transposed products (restriction) are never scattered on device; explicit
transposes are materialized host-side at setup, exactly as the reference builds
explicit `R` (reference: src/SMEM_Setup.cpp:1341-1370).

Padding convention: col = 0, val = 0 (safe under gather).
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from amg_jax.dtypes import INDEX_DTYPE


@jax.tree_util.register_pytree_node_class
@dataclass
class ELLMatrix:
    """ELL matrix as a pytree of two device arrays.

    cols: (n_rows, k) int32 — column index per slot (0 where padded)
    vals: (n_rows, k) float — value per slot (0 where padded)
    n_cols is carried as static aux data (`shape_cols`) so rectangular
    operators (P: fine×coarse, R: coarse×fine) know their domain size.
    """

    cols: jnp.ndarray
    vals: jnp.ndarray
    shape_cols: int  # static aux: number of columns of the operator

    def tree_flatten(self):
        return (self.cols, self.vals), self.shape_cols

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(cols=children[0], vals=children[1], shape_cols=aux)

    @property
    def n_rows(self) -> int:
        return self.cols.shape[0]

    @property
    def k(self) -> int:
        return self.cols.shape[1]

    @property
    def shape(self) -> tuple:
        return (self.n_rows, self.shape_cols)

    @property
    def nnz_padded(self) -> int:
        return self.cols.size

    # ---- apply --------------------------------------------------------
    def matvec(self, x: jnp.ndarray) -> jnp.ndarray:
        """y = A @ x."""
        return ell_spmv(self, x)

    def __matmul__(self, x):
        return ell_spmv(self, x)


def ell_from_csr(csr, k: int | None = None, dtype=None) -> ELLMatrix:
    """Convert a host CSRMatrix to device ELL, padding rows to width k."""
    n = csr.n_rows
    if k is None:
        k = max(csr.max_row_nnz, 1)
    cols = np.zeros((n, k), dtype=INDEX_DTYPE)
    vals = np.zeros((n, k), dtype=np.float64)
    counts = np.diff(csr.indptr)
    if csr.nnz:
        # slot index of each nnz within its row
        row_ids = np.repeat(np.arange(n), counts)
        slot = np.arange(csr.nnz) - np.repeat(csr.indptr[:-1], counts)
        cols[row_ids, slot] = csr.indices
        vals[row_ids, slot] = csr.data
    if dtype is None:
        dtype = jnp.float64
    return ELLMatrix(
        cols=jnp.asarray(cols),
        vals=jnp.asarray(vals, dtype=dtype),
        shape_cols=csr.n_cols,
    )


def ell_ds_pair(csr, k: int | None = None):
    """(A_hi, A_lo) f32 ELL pair whose value sum represents the f64 matrix
    — the double-single operator split for the UNSTRUCTURED path (the
    matrix-from-file escape hatch), consumed by ops/ds.py::ds_matvec /
    ds_residual and solve/mixed.mixed_pcg exactly like the DIA kernel
    pair. Both share one cols array (the lo operator aliases it)."""
    hi = ell_from_csr(csr, k=k, dtype=jnp.float32)
    v64 = np.zeros(hi.vals.shape, np.float64)
    counts = np.diff(csr.indptr)
    if csr.nnz:
        n = csr.n_rows
        row_ids = np.repeat(np.arange(n), counts)
        slot = np.arange(csr.nnz) - np.repeat(csr.indptr[:-1], counts)
        v64[row_ids, slot] = csr.data
    lo = (v64 - np.asarray(hi.vals, np.float64)).astype(np.float32)
    return hi, ELLMatrix(
        cols=hi.cols, vals=jnp.asarray(lo), shape_cols=csr.n_cols
    )


def ell_spmv(a: ELLMatrix, x: jnp.ndarray) -> jnp.ndarray:
    """y = A @ x: gather + multiply + reduce over the (small) slot axis."""
    return jnp.sum(a.vals * x[a.cols], axis=1)


def ell_spgemv(
    a: ELLMatrix, x: jnp.ndarray, b: jnp.ndarray, alpha, beta
) -> jnp.ndarray:
    """Fused y = alpha*A@x + beta*b — the reference's SpMV workhorse with its
    eight (alpha, beta) specializations collapsed into one XLA-fused kernel
    (reference: src/SMEM_MatVec.cpp:123-259)."""
    return alpha * ell_spmv(a, x) + beta * b


def ell_residual(a: ELLMatrix, x: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """r = b - A@x (reference: src/SEQ_MatVec.cpp:44-63)."""
    return b - ell_spmv(a, x)
