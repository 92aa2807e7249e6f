"""Host-side CSR matrix (numpy-backed) used during setup.

This is the setup-time data structure: AMG hierarchy construction (strength,
coarsening, interpolation, RAP) is graph-driven and irregular, so it runs once
per matrix on the host in float64 — the role hypre's `hypre_CSRMatrix` plays in
the reference (reference: src/Main.hpp:304-316, src/SMEM_Setup.cpp:182-588).
Solve-time state is converted to device formats (`ELLMatrix`,
`StencilOperator`).

SpGEMM currently routes through scipy.sparse (host, setup-time only); the
native C++ SpGEMM backend in `native/` replaces it when built (see
`amg_jax.setup.rap`).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import scipy.sparse as _sp

from amg_jax.dtypes import INDEX_DTYPE, SETUP_DTYPE


def _use_native() -> bool:
    """Route SpGEMM/transpose through native/libamgsetup.so when available
    (AMG_JAX_NATIVE=0 forces the scipy path)."""
    if os.environ.get("AMG_JAX_NATIVE", "1") == "0":
        return False
    from amg_jax import native_backend as nb

    return nb.available()


@dataclass
class CSRMatrix:
    """Compressed sparse row matrix: indptr[n+1], indices[nnz], data[nnz]."""

    indptr: np.ndarray
    indices: np.ndarray
    data: np.ndarray
    shape: tuple

    # ---- constructors -------------------------------------------------
    @staticmethod
    def from_scipy(m) -> "CSRMatrix":
        m = m.tocsr()
        m.sum_duplicates()
        return CSRMatrix(
            indptr=m.indptr.astype(INDEX_DTYPE),
            indices=m.indices.astype(INDEX_DTYPE),
            data=m.data.astype(SETUP_DTYPE),
            shape=tuple(m.shape),
        )

    @staticmethod
    def from_coo(rows, cols, vals, shape) -> "CSRMatrix":
        m = _sp.coo_matrix((vals, (rows, cols)), shape=shape)
        return CSRMatrix.from_scipy(m)

    @staticmethod
    def from_dense(a) -> "CSRMatrix":
        return CSRMatrix.from_scipy(_sp.csr_matrix(np.asarray(a, dtype=SETUP_DTYPE)))

    @staticmethod
    def eye(n: int) -> "CSRMatrix":
        return CSRMatrix.from_scipy(_sp.identity(n, dtype=SETUP_DTYPE, format="csr"))

    # ---- views --------------------------------------------------------
    def to_scipy(self) -> _sp.csr_matrix:
        return _sp.csr_matrix(
            (self.data, self.indices, self.indptr), shape=self.shape, copy=False
        )

    def to_dense(self) -> np.ndarray:
        return self.to_scipy().toarray()

    # ---- properties ---------------------------------------------------
    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def n_cols(self) -> int:
        return self.shape[1]

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    @property
    def max_row_nnz(self) -> int:
        if self.n_rows == 0:
            return 0
        return int(np.max(np.diff(self.indptr)))

    # ---- host ops (setup-time) ---------------------------------------
    def diagonal(self) -> np.ndarray:
        return self.to_scipy().diagonal()

    def l1_row_norms(self) -> np.ndarray:
        """Row-wise sum of |a_ij| — the L1-Jacobi scaling of the reference
        (reference: src/SMEM_Setup.cpp:222-232, src/DMEM_Setup.cpp:391-433)."""
        s = self.to_scipy()
        out = np.abs(s).sum(axis=1)
        return np.asarray(out).reshape(-1).astype(SETUP_DTYPE)

    def transpose(self) -> "CSRMatrix":
        if _use_native():
            from amg_jax import native_backend as nb

            bi, bj, bv = nb.transpose(
                self.indptr, self.indices, self.data, self.shape
            )
            return CSRMatrix(
                indptr=bi.astype(INDEX_DTYPE),
                indices=bj.astype(INDEX_DTYPE),
                data=bv,
                shape=(self.n_cols, self.n_rows),
            )
        return CSRMatrix.from_scipy(self.to_scipy().T.tocsr())

    def matmul(self, other: "CSRMatrix") -> "CSRMatrix":
        if _use_native():
            from amg_jax import native_backend as nb

            ci, cj, cv = nb.spgemm(
                self.indptr, self.indices, self.data,
                other.indptr, other.indices, other.data,
                self.shape, other.shape,
            )
            return CSRMatrix(
                indptr=ci.astype(INDEX_DTYPE),
                indices=cj.astype(INDEX_DTYPE),
                data=cv,
                shape=(self.n_rows, other.n_cols),
            )
        return CSRMatrix.from_scipy(self.to_scipy() @ other.to_scipy())

    def matvec(self, x: np.ndarray) -> np.ndarray:
        return self.to_scipy() @ x

    def scale_rows(self, s: np.ndarray) -> "CSRMatrix":
        d = _sp.diags(np.asarray(s, dtype=SETUP_DTYPE))
        return CSRMatrix.from_scipy(d @ self.to_scipy())

    def __matmul__(self, other):
        if isinstance(other, CSRMatrix):
            return self.matmul(other)
        return self.matvec(other)
