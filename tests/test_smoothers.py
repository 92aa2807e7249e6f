"""Smoother semantics tests vs explicit numpy references."""

import numpy as np
import jax.numpy as jnp

from amg_jax.problems import laplacian_2d_5pt
from amg_jax.smooth import SmootherType, make_smoother_data, smooth, smooth_transpose
from amg_jax.smooth.smoothers import gs_scan_sweep
from amg_jax.sparse.csr import CSRMatrix
from amg_jax.sparse.ell import ell_from_csr


def spd_problem(n=24, seed=0):
    prob = laplacian_2d_5pt(n, 1)  # 1D chain via degenerate grid? keep 2D:
    prob = laplacian_2d_5pt(6, 4)
    return prob


def setup(n_grid=6):
    prob = laplacian_2d_5pt(n_grid, n_grid)
    A = prob.A
    ell = ell_from_csr(A)
    dense = A.to_dense()
    rng = np.random.default_rng(42)
    u0 = rng.random(A.n_rows)
    f = rng.random(A.n_rows)
    return A, ell, dense, u0, f


class TestJacobi:
    def test_weighted_jacobi_sweep(self):
        A, ell, dense, u0, f = setup()
        w = 0.8
        sm = make_smoother_data(A, SmootherType.JACOBI, w=w)
        u1 = smooth(ell, sm, SmootherType.JACOBI, jnp.asarray(u0), jnp.asarray(f))
        expect = u0 + w / np.diag(dense) * (f - dense @ u0)
        np.testing.assert_allclose(np.asarray(u1), expect, atol=1e-13)

    def test_zero_guess_skips_matvec(self):
        A, ell, dense, u0, f = setup()
        sm = make_smoother_data(A, SmootherType.JACOBI, w=0.7)
        u_zg = smooth(
            ell, sm, SmootherType.JACOBI, jnp.zeros(A.n_rows), jnp.asarray(f),
            num_sweeps=2, zero_guess=True,
        )
        u_explicit = smooth(
            ell, sm, SmootherType.JACOBI, jnp.zeros(A.n_rows), jnp.asarray(f),
            num_sweeps=2, zero_guess=False,
        )
        np.testing.assert_allclose(np.asarray(u_zg), np.asarray(u_explicit), atol=1e-13)

    def test_l1_jacobi_scale(self):
        A, ell, dense, u0, f = setup()
        sm = make_smoother_data(A, SmootherType.L1_JACOBI, w=1.0)
        u1 = smooth(ell, sm, SmootherType.L1_JACOBI, jnp.asarray(u0), jnp.asarray(f))
        l1 = np.abs(dense).sum(1)
        expect = u0 + (f - dense @ u0) / l1
        np.testing.assert_allclose(np.asarray(u1), expect, atol=1e-13)

    def test_jacobi_converges_on_laplacian(self):
        A, ell, dense, u0, f = setup(8)
        sm = make_smoother_data(A, SmootherType.L1_JACOBI, w=1.0)
        u = jnp.asarray(u0)
        fa = jnp.asarray(f)
        r0 = np.linalg.norm(f - dense @ u0)
        u = smooth(ell, sm, SmootherType.L1_JACOBI, u, fa, num_sweeps=50)
        r = np.linalg.norm(f - dense @ np.asarray(u))
        assert r < 0.5 * r0


class TestGaussSeidel:
    def numpy_gs(self, dense, u, f):
        u = u.copy()
        for i in range(len(u)):
            u[i] = (f[i] - dense[i] @ u + dense[i, i] * u[i]) / dense[i, i]
        return u

    def test_full_block_gs_equals_sequential(self):
        A, ell, dense, u0, f = setup()
        sm = make_smoother_data(A, SmootherType.GS)
        u1 = smooth(ell, sm, SmootherType.GS, jnp.asarray(u0), jnp.asarray(f))
        np.testing.assert_allclose(np.asarray(u1), self.numpy_gs(dense, u0, f), atol=1e-12)

    def test_gs_scan_matches(self):
        A, ell, dense, u0, f = setup()
        u1 = gs_scan_sweep(ell, jnp.asarray(np.diag(dense)), jnp.asarray(u0), jnp.asarray(f))
        np.testing.assert_allclose(np.asarray(u1), self.numpy_gs(dense, u0, f), atol=1e-12)

    def test_hybrid_jgs_block_semantics(self):
        """Hybrid JGS = GS inside each block with off-block values at u_prev
        (reference thread-block semantics, src/SMEM_Smooth.cpp:222-305)."""
        A, ell, dense, u0, f = setup()
        bs = 10
        sm = make_smoother_data(A, SmootherType.HYBRID_JGS, block_size=bs)
        u1 = smooth(ell, sm, SmootherType.HYBRID_JGS, jnp.asarray(u0), jnp.asarray(f))
        n = len(u0)
        expect = u0.copy()
        for lo in range(0, n, bs):
            hi = min(lo + bs, n)
            for i in range(lo, hi):
                acc = f[i]
                for j in range(n):
                    if j == i:
                        continue
                    uj = expect[j] if (lo <= j < i) else u0[j]
                    acc -= dense[i, j] * uj
                expect[i] = acc / dense[i, i]
        np.testing.assert_allclose(np.asarray(u1), expect, atol=1e-12)

    def test_backward_transpose_roundtrip(self):
        A, ell, dense, u0, f = setup()
        sm = make_smoother_data(A, SmootherType.HYBRID_JGS, block_size=8)
        fwd = smooth(ell, sm, SmootherType.HYBRID_JGS, jnp.asarray(u0), jnp.asarray(f))
        bwd = smooth_transpose(
            ell, sm, SmootherType.HYBRID_JGS, jnp.asarray(u0), jnp.asarray(f)
        )
        # backward sweep must equal GS with reversed in-block ordering
        n = len(u0)
        bs = 8
        expect = u0.copy()
        for lo in range(0, n, bs):
            hi = min(lo + bs, n)
            for i in reversed(range(lo, hi)):
                acc = f[i]
                for j in range(n):
                    if j == i:
                        continue
                    uj = expect[j] if (i < j < hi) else u0[j]
                    acc -= dense[i, j] * uj
                expect[i] = acc / dense[i, i]
        np.testing.assert_allclose(np.asarray(bwd), expect, atol=1e-12)
        assert not np.allclose(np.asarray(fwd), np.asarray(bwd))


class TestSymmetric:
    def test_sym_jacobi_formula(self):
        A, ell, dense, u0, f = setup()
        w = 0.9
        sm = make_smoother_data(A, SmootherType.SYM_JACOBI, w=w)
        u1 = smooth(ell, sm, SmootherType.SYM_JACOBI, jnp.asarray(u0), jnp.asarray(f))
        D = np.diag(dense)
        r = f - dense @ u0
        t = w / D * r
        expect = u0 + 2.0 * t - w / D * (dense @ t)
        np.testing.assert_allclose(np.asarray(u1), expect, atol=1e-13)

    def test_sym_smoother_operator_is_symmetric(self):
        """M_sym = wD^-1 (2D/w - A) wD^-1 must be a symmetric matrix — the
        property that keeps additive cycles SPD (reference:
        src/SEQ_Smooth.cpp:119-189)."""
        A, ell, dense, u0, f = setup(4)
        n = dense.shape[0]
        sm = make_smoother_data(A, SmootherType.SYM_JACOBI, w=0.85)
        cols = []
        for i in range(n):
            e = np.zeros(n)
            e[i] = 1.0
            # du for u0=0, f=e gives M_sym e
            out = smooth(
                ell, sm, SmootherType.SYM_JACOBI, jnp.zeros(n), jnp.asarray(e),
                zero_guess=True,
            )
            cols.append(np.asarray(out))
        M = np.stack(cols, axis=1)
        np.testing.assert_allclose(M, M.T, atol=1e-12)
