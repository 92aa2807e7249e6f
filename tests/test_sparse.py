"""Unit tests for sparse containers and kernels vs scipy/dense references."""

import numpy as np
import pytest

import jax.numpy as jnp

from amg_jax.problems import (
    difconv_3d,
    laplacian_2d_5pt,
    laplacian_3d_7pt,
    laplacian_3d_27pt,
    vardifconv_3d,
)
from amg_jax.sparse.csr import CSRMatrix
from amg_jax.sparse.ell import ell_from_csr, ell_residual, ell_spgemv, ell_spmv


def random_csr(n, m, density=0.2, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.random((n, m)) * (rng.random((n, m)) < density)
    # keep it nonsingular-ish for tests that need matvecs only
    return CSRMatrix.from_dense(a), a


class TestCSR:
    def test_roundtrip(self):
        csr, dense = random_csr(17, 23)
        np.testing.assert_allclose(csr.to_dense(), dense)

    def test_transpose_matmul(self):
        a_csr, a = random_csr(9, 13, seed=1)
        b_csr, b = random_csr(13, 7, seed=2)
        np.testing.assert_allclose(a_csr.transpose().to_dense(), a.T)
        np.testing.assert_allclose((a_csr @ b_csr).to_dense(), a @ b, atol=1e-14)

    def test_l1_row_norms_and_diag(self):
        csr, dense = random_csr(12, 12, seed=3)
        np.testing.assert_allclose(csr.l1_row_norms(), np.abs(dense).sum(1))
        np.testing.assert_allclose(csr.diagonal(), np.diag(dense))


class TestELL:
    def test_spmv_matches_scipy(self):
        csr, dense = random_csr(31, 31, seed=4)
        ell = ell_from_csr(csr)
        x = np.random.default_rng(5).random(31)
        np.testing.assert_allclose(
            np.asarray(ell_spmv(ell, jnp.asarray(x))), dense @ x, atol=1e-13
        )

    def test_rectangular(self):
        csr, dense = random_csr(10, 25, seed=6)
        ell = ell_from_csr(csr)
        assert ell.shape == (10, 25)
        x = np.random.default_rng(7).random(25)
        np.testing.assert_allclose(
            np.asarray(ell @ jnp.asarray(x)), dense @ x, atol=1e-13
        )

    def test_fused_spgemv_and_residual(self):
        csr, dense = random_csr(20, 20, seed=8)
        ell = ell_from_csr(csr)
        rng = np.random.default_rng(9)
        x, b = rng.random(20), rng.random(20)
        xa, ba = jnp.asarray(x), jnp.asarray(b)
        np.testing.assert_allclose(
            np.asarray(ell_spgemv(ell, xa, ba, -1.0, 1.0)),
            b - dense @ x,
            atol=1e-13,
        )
        np.testing.assert_allclose(
            np.asarray(ell_residual(ell, xa, ba)), b - dense @ x, atol=1e-13
        )

    def test_empty_rows(self):
        dense = np.zeros((5, 5))
        dense[0, 0] = 2.0
        ell = ell_from_csr(CSRMatrix.from_dense(dense))
        x = jnp.arange(5.0)
        np.testing.assert_allclose(np.asarray(ell @ x), dense @ np.arange(5.0))


STENCIL_CASES = [
    ("5pt", lambda: laplacian_2d_5pt(7, 5)),
    ("7pt", lambda: laplacian_3d_7pt(4, 5, 3, cx=1.0, cy=2.0, cz=0.5)),
    ("27pt", lambda: laplacian_3d_27pt(4, 3, 5)),
    ("difconv_fwd", lambda: difconv_3d(4, 4, 4, eps=0.1, atype=0)),
    ("difconv_bwd", lambda: difconv_3d(4, 4, 4, eps=0.1, atype=1)),
    ("difconv_up", lambda: difconv_3d(4, 4, 4, eps=0.1, ax=-1.0, atype=2)),
    ("difconv_cen", lambda: difconv_3d(4, 4, 4, eps=0.1, atype=3)),
]


class TestStencils:
    @pytest.mark.parametrize("name,gen", STENCIL_CASES, ids=[c[0] for c in STENCIL_CASES])
    def test_stencil_matches_assembled_csr(self, name, gen):
        prob = gen()
        x = np.random.default_rng(0).random(prob.n)
        y_stencil = np.asarray(prob.stencil @ jnp.asarray(x))
        y_csr = prob.A @ x
        np.testing.assert_allclose(y_stencil, y_csr, atol=1e-11)

    def test_5pt_row_sums_interior(self):
        prob = laplacian_2d_5pt(5)
        dense = prob.A.to_dense()
        # interior row: 4 on diag, four -1 neighbors
        i = 2 * 5 + 2
        assert dense[i, i] == 4.0
        assert dense[i].sum() == 0.0

    def test_nnz_exact(self):
        prob = laplacian_2d_5pt(6, 4)
        assert prob.stencil.nnz_exact() == prob.A.nnz

    def test_vardifconv_spd(self):
        prob = vardifconv_3d(4, eps=1.0, seed=0)
        dense = prob.A.to_dense()
        np.testing.assert_allclose(dense, dense.T, atol=1e-12)
        eigs = np.linalg.eigvalsh(dense)
        assert eigs.min() > 0
