"""Galerkin triple product and smoothed transfer operators.

Setup-time SpGEMM (host, float64): A_c = R A P with R = P^T — the Galerkin
coarse operator hypre's RAP builds for the reference — and the multadd
smoothed transfers P~ = (I - w S^-1 A) P, R~ = P~^T (reference:
src/SMEM_Setup.cpp:1173-1339 `SmoothTransfer`/`EigenMatMat`, which the
reference computes with Eigen SpGEMM; here scipy.sparse, with the native C++
backend in `native/` as the drop-in replacement when built).
"""

from __future__ import annotations

import numpy as np

from amg_jax.sparse.csr import CSRMatrix


def galerkin_product(R: CSRMatrix, A: CSRMatrix, P: CSRMatrix) -> CSRMatrix:
    """A_c = R A P, with tiny entries dropped to keep ELL widths bounded.
    Routes through the native SpGEMM backend when built (CSRMatrix.matmul)."""
    ac = R.matmul(A).matmul(P).to_scipy()
    ac.sum_duplicates()
    # drop numerically-zero fill-in (exact zeros from cancellation)
    ac.data[np.abs(ac.data) < 1e-300] = 0.0
    ac.eliminate_zeros()
    return CSRMatrix.from_scipy(ac)


def smoothed_transfer(
    A: CSRMatrix, P: CSRMatrix, scale: np.ndarray, w: float
) -> tuple[CSRMatrix, CSRMatrix]:
    """P~ = (I - w S^-1 A) P and R~ = P~^T, the smoothed interpolants the
    multadd cycle folds its smoother into (reference:
    src/SMEM_Setup.cpp:1173-1254, src/DMEM_Smooth.cpp:574-638).

    `scale` is diag(A) or the L1 row norms, matching the smoother in use.
    """
    import scipy.sparse as sp

    g = sp.identity(A.n_rows, format="csr") - sp.diags(w / scale) @ A.to_scipy()
    ps = (g @ P.to_scipy()).tocsr()
    p_smooth = CSRMatrix.from_scipy(ps)
    return p_smooth, CSRMatrix.from_scipy(ps.T.tocsr())


def estimate_rho_dinv_a(
    A: CSRMatrix, iters: int = 30, seed: int = 0, scale: np.ndarray | None = None
) -> float:
    """Spectral-radius estimate of S^-1 A by power iteration — the weight
    oracle the reference gets from hypre_ParCSRMaxEigEstimateCG
    (reference: src/DMEM_Setup.cpp:77-87). `scale` defaults to diag(A)."""
    rng = np.random.default_rng(seed)
    a = A.to_scipy()
    d = A.diagonal() if scale is None else scale
    d = np.where(d == 0.0, 1.0, d)
    x = rng.random(A.n_rows)
    lam = 1.0
    for _ in range(iters):
        x = (a @ x) / d
        nrm = np.linalg.norm(x)
        if nrm == 0.0:
            return 1.0
        lam = nrm
        x /= nrm
    return float(lam)
