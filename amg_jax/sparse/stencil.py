"""Structured-grid stencil operator — the single-chip speed-of-light path.

Constant-coefficient stencil matrices (5-pt/9-pt 2D, 7-pt/27-pt 3D Laplacians,
difconv) never need an explicit sparse format on device: the matvec is a sum of
shifted slices of the grid-shaped vector, which XLA fuses into one
bandwidth-bound elementwise loop with zero index traffic. This is the
device counterpart of the reference's stencil problem classes (reference:
src/DMEM_BuildMatrix.cpp:169-440, src/Laplacian.cpp:3-199) used as the headline
nnz/s benchmark path.

Zero-padding the grid reproduces the truncated boundary rows of the assembled
matrix (homogeneous Dirichlet), matching hypre's `GenerateLaplacian*` assembly
the reference wraps.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_pytree_node_class
@dataclass
class StencilOperator:
    """weights: (m,) device array; offsets/grid_shape: static aux metadata."""

    weights: jnp.ndarray
    offsets: Tuple[Tuple[int, ...], ...]  # static, one tuple per weight
    grid_shape: Tuple[int, ...]  # static

    def tree_flatten(self):
        return (self.weights,), (self.offsets, self.grid_shape)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(weights=children[0], offsets=aux[0], grid_shape=aux[1])

    @property
    def n_rows(self) -> int:
        return int(np.prod(self.grid_shape))

    @property
    def shape(self) -> tuple:
        return (self.n_rows, self.n_rows)

    @property
    def nnz_stencil(self) -> int:
        """nnz counted as if every row had the full stencil (upper bound)."""
        return self.n_rows * len(self.offsets)

    def nnz_exact(self) -> int:
        """Exact nnz of the equivalent assembled matrix."""
        total = 0
        for off in self.offsets:
            rows = 1
            for dim, d in zip(self.grid_shape, off):
                rows *= max(dim - abs(d), 0)
            total += rows
        return total

    def matvec(self, x: jnp.ndarray) -> jnp.ndarray:
        return stencil_matvec(self, x)

    def __matmul__(self, x):
        return stencil_matvec(self, x)

    def diagonal(self) -> jnp.ndarray:
        """Constant diagonal broadcast to a full vector (center weight)."""
        center = None
        for w_idx, off in enumerate(self.offsets):
            if all(d == 0 for d in off):
                center = self.weights[w_idx]
        if center is None:
            center = jnp.zeros((), dtype=self.weights.dtype)
        return jnp.full((self.n_rows,), center, dtype=self.weights.dtype)


def stencil_matvec(a: StencilOperator, x: jnp.ndarray) -> jnp.ndarray:
    """y = A @ x via shifted-slice accumulation on the grid view."""
    grid = x.reshape(a.grid_shape)
    ndim = len(a.grid_shape)
    pads = [
        (
            max(abs(off[d]) for off in a.offsets),
            max(abs(off[d]) for off in a.offsets),
        )
        for d in range(ndim)
    ]
    padded = jnp.pad(grid, pads)
    y = jnp.zeros_like(grid)
    for w_idx, off in enumerate(a.offsets):
        idx = tuple(
            slice(pads[d][0] + off[d], pads[d][0] + off[d] + a.grid_shape[d])
            for d in range(ndim)
        )
        y = y + a.weights[w_idx] * padded[idx]
    return y.reshape(x.shape)


def stencil_to_csr(a: StencilOperator):
    """Assemble the stencil into a host CSRMatrix (for setup / validation)."""
    import scipy.sparse as sp

    from amg_jax.sparse.csr import CSRMatrix

    shape = a.grid_shape
    n = int(np.prod(shape))
    idx = np.arange(n).reshape(shape)
    rows_all, cols_all, vals_all = [], [], []
    weights = np.asarray(a.weights, dtype=np.float64)
    for w, off in zip(weights, a.offsets):
        # rows (i) whose neighbor i+off is inside the grid
        src = tuple(
            slice(max(-d, 0), s - max(d, 0)) for d, s in zip(off, shape)
        )
        dst = tuple(
            slice(max(d, 0), s - max(-d, 0)) for d, s in zip(off, shape)
        )
        rows_all.append(idx[src].reshape(-1))
        cols_all.append(idx[dst].reshape(-1))
        vals_all.append(np.full(idx[src].size, w))
    m = sp.coo_matrix(
        (
            np.concatenate(vals_all),
            (np.concatenate(rows_all), np.concatenate(cols_all)),
        ),
        shape=(n, n),
    )
    return CSRMatrix.from_scipy(m)
