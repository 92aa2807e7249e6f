"""Device-side BSR (blocked-ELL) sparse matrix — the gather-amortized format.

Motivation: a scalar-gather ELL SpMV issues one gather per stored entry.
BSR groups rows into bm-row blocks and columns into bn-wide blocks and
stores dense bm×bn tiles: one gather index now moves bn contiguous values
and feeds bm×bn multiply-adds, cutting the gather count by ~bm·bn/fill. The
multiply is a regular batched (bm×bn)·(bn) contraction.

It serves the role the reference's CSR row loops play for *unstructured*
matrices (elasticity/Maxwell/file matrices and coarse AMG levels, where no
stencil fast path exists) — reference workhorse:
src/SMEM_MatVec.cpp:123-259. Structured fine grids keep the stencil path.
Which format "auto" picks is the platform policy's (amg_jax.dtypes).

Layout: ELL-of-blocks. Every row-block is padded to the same number of
column-block slots `kb` (block col = 0, tile = 0 where padded — safe under
gather). Vectors are padded/sliced internally, so callers keep true sizes.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from amg_jax.dtypes import INDEX_DTYPE


@jax.tree_util.register_pytree_node_class
@dataclass
class BSRMatrix:
    """Blocked-ELL matrix as a pytree of two device arrays.

    block_cols: (nrb, kb) int32  — column-block index per slot (0 if padded)
    blocks:     (nrb, kb, bm, bn) float — dense tile per slot (0 if padded)
    shape (static aux): true (n_rows, n_cols) of the operator.
    """

    block_cols: jnp.ndarray
    blocks: jnp.ndarray
    shape: tuple

    def tree_flatten(self):
        return (self.block_cols, self.blocks), self.shape

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(block_cols=children[0], blocks=children[1], shape=aux)

    # ---- static geometry ----------------------------------------------
    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def shape_cols(self) -> int:  # ELLMatrix-compatible name
        return self.shape[1]

    @property
    def bm(self) -> int:
        return self.blocks.shape[2]

    @property
    def bn(self) -> int:
        return self.blocks.shape[3]

    @property
    def nrb(self) -> int:
        return self.blocks.shape[0]

    @property
    def kb(self) -> int:
        return self.blocks.shape[1]

    @property
    def nnz_padded(self) -> int:
        """Stored scalars (incl. zero fill) — the bandwidth cost."""
        return self.blocks.size

    # ---- apply ----------------------------------------------------------
    def matvec(self, x: jnp.ndarray) -> jnp.ndarray:
        return bsr_spmv(self, x)

    def __matmul__(self, x):
        return bsr_spmv(self, x)


def bsr_from_csr(csr, bm: int = 8, bn: int = 8, dtype=None) -> BSRMatrix:
    """Convert a host CSRMatrix to blocked-ELL, tiling by bm×bn blocks."""
    n, m = csr.shape
    nrb = -(-n // bm)
    ncb = -(-m // bn)
    counts_per_rb = np.zeros(nrb, dtype=np.int64)
    if csr.nnz:
        rows = np.repeat(
            np.arange(n, dtype=np.int64), np.diff(csr.indptr).astype(np.int64)
        )
        cols = csr.indices.astype(np.int64)
        rb = rows // bm
        cb = cols // bn
        key = rb * ncb + cb
        uk = np.unique(key)
        ub_rb = uk // ncb
        counts_per_rb = np.bincount(ub_rb, minlength=nrb)
        kb = max(int(counts_per_rb.max()), 1)
        # slot of each unique block within its row-block (uk is sorted, so
        # blocks of one rb are contiguous)
        first = np.searchsorted(ub_rb, np.arange(nrb))
        slot_of_block = np.arange(len(uk)) - first[ub_rb]
        block_cols = np.zeros((nrb, kb), dtype=INDEX_DTYPE)
        block_cols[ub_rb, slot_of_block] = uk % ncb
        blocks = np.zeros((nrb, kb, bm, bn), dtype=np.float64)
        g = np.searchsorted(uk, key)  # global block id per nnz
        blocks[rb, slot_of_block[g], rows % bm, cols % bn] = csr.data
    else:
        kb = 1
        block_cols = np.zeros((nrb, kb), dtype=INDEX_DTYPE)
        blocks = np.zeros((nrb, kb, bm, bn), dtype=np.float64)
    if dtype is None:
        dtype = jnp.float64
    return BSRMatrix(
        block_cols=jnp.asarray(block_cols),
        blocks=jnp.asarray(blocks, dtype=dtype),
        shape=(n, m),
    )


def bsr_fill_stats(csr, bm: int = 8, bn: int = 8) -> dict:
    """Storage diagnostics for the format choice: how much zero fill would
    bm×bn tiling introduce, and the gather-index reduction vs ELL."""
    n, m = csr.shape
    ncb = -(-m // bn)
    nrb = -(-n // bm)
    if csr.nnz == 0:
        return {"padded": nrb * bm * bn, "nnz": 0, "blowup": np.inf,
                "gathers_bsr": nrb, "gathers_ell": n}
    rows = np.repeat(
        np.arange(n, dtype=np.int64), np.diff(csr.indptr).astype(np.int64)
    )
    key = (rows // bm) * ncb + csr.indices.astype(np.int64) // bn
    uk = np.unique(key)
    counts = np.bincount(uk // ncb, minlength=nrb)
    kb = max(int(counts.max()), 1)
    padded = nrb * kb * bm * bn
    k_ell = max(int(np.diff(csr.indptr).max()), 1)
    return {
        "padded": padded,
        "nnz": csr.nnz,
        "blowup": padded / csr.nnz,
        "kb": kb,
        "gathers_bsr": nrb * kb,
        "gathers_ell": n * k_ell,
    }


def bsr_spmv(a: BSRMatrix, x: jnp.ndarray) -> jnp.ndarray:
    """y = A @ x: block-gather + batched tile·segment contraction."""
    n, m = a.shape
    bn = a.bn
    ncb = -(-m // bn)
    xp = jnp.pad(x, (0, ncb * bn - m)) if ncb * bn != m else x
    xb = xp.reshape(ncb, bn)
    g = xb[a.block_cols]  # (nrb, kb, bn) — one index moves bn values
    # HIGHEST: without it a float32 product may run in TF32 on the GPU
    y = jnp.einsum(
        "rkij,rkj->ri", a.blocks, g, preferred_element_type=a.blocks.dtype,
        precision=jax.lax.Precision.HIGHEST,
    )
    y = y.reshape(-1)
    return y[:n] if y.shape[0] != n else y


def bsr_spgemv(a: BSRMatrix, x, b, alpha, beta) -> jnp.ndarray:
    """Fused y = alpha*A@x + beta*b (reference: src/SMEM_MatVec.cpp:123-259)."""
    return alpha * bsr_spmv(a, x) + beta * b


def bsr_residual(a: BSRMatrix, x, b) -> jnp.ndarray:
    """r = b - A@x (reference: src/SEQ_MatVec.cpp:44-63)."""
    return b - bsr_spmv(a, x)
