"""Native C++ setup backend vs scipy reference."""

import os

import numpy as np
import pytest

from amg_jax import native_backend as nb
from amg_jax.problems import laplacian_2d_5pt, laplacian_3d_27pt
from amg_jax.setup.coarsen import C_PT, F_PT, pmis_native
from amg_jax.setup.strength import strength_graph
from amg_jax.sparse.csr import CSRMatrix

pytestmark = pytest.mark.skipif(
    not nb.available(), reason="native library not built"
)


def random_csr(n, m, density=0.15, seed=0):
    rng = np.random.default_rng(seed)
    a = (rng.random((n, m)) - 0.2) * (rng.random((n, m)) < density)
    return CSRMatrix.from_dense(a), a


class TestSpGEMM:
    def test_matches_scipy(self):
        A, ad = random_csr(40, 33, seed=1)
        B, bd = random_csr(33, 27, seed=2)
        ci, cj, cv = nb.spgemm(
            A.indptr, A.indices, A.data, B.indptr, B.indices, B.data,
            A.shape, B.shape,
        )
        got = CSRMatrix(
            indptr=ci.astype(np.int32), indices=cj.astype(np.int32),
            data=cv, shape=(40, 27),
        )
        np.testing.assert_allclose(got.to_dense(), ad @ bd, atol=1e-13)

    def test_csr_matmul_dispatch(self):
        A, ad = random_csr(20, 20, seed=3)
        got = A.matmul(A)
        np.testing.assert_allclose(got.to_dense(), ad @ ad, atol=1e-13)
        # canonical CSR: sorted column indices per row
        for i in range(20):
            row = got.indices[got.indptr[i] : got.indptr[i + 1]]
            assert (np.diff(row) > 0).all() if row.size > 1 else True

    def test_rap_native_equals_scipy(self):
        prob = laplacian_2d_5pt(12)
        from amg_jax.setup.coarsen import hmis
        from amg_jax.setup.interp import extended_i_interpolation
        from amg_jax.setup.rap import galerkin_product

        S = strength_graph(prob.A, 0.25)
        cf = hmis(S)
        P = extended_i_interpolation(prob.A, S, cf)
        R = P.transpose()
        os.environ["AMG_JAX_NATIVE"] = "1"
        ac_native = galerkin_product(R, prob.A, P)
        os.environ["AMG_JAX_NATIVE"] = "0"
        try:
            ac_scipy = galerkin_product(R, prob.A, P)
        finally:
            os.environ["AMG_JAX_NATIVE"] = "1"
        np.testing.assert_allclose(
            ac_native.to_dense(), ac_scipy.to_dense(), atol=1e-13
        )


class TestTranspose:
    def test_matches_scipy(self):
        A, ad = random_csr(17, 29, seed=4)
        bi, bj, bv = nb.transpose(A.indptr, A.indices, A.data, A.shape)
        got = CSRMatrix(
            indptr=bi.astype(np.int32), indices=bj.astype(np.int32),
            data=bv, shape=(29, 17),
        )
        np.testing.assert_allclose(got.to_dense(), ad.T, atol=1e-15)


class TestNativePMIS:
    def test_valid_splitting(self):
        prob = laplacian_3d_27pt(6)
        S = strength_graph(prob.A, 0.25)
        cf = pmis_native(S, seed=0)
        n = prob.n
        nc = int((cf == C_PT).sum())
        assert 0 < nc < n
        # every F point with strong connections depends on >= 1 C point
        for i in range(n):
            si = S.indices[S.indptr[i] : S.indptr[i + 1]]
            if cf[i] == F_PT and len(si):
                assert any(cf[j] == C_PT for j in si)
        # C points form an independent set in the symmetrized graph
        G = ((S + S.T) > 0).tocsr()
        for i in range(n):
            if cf[i] == C_PT:
                for j in G.indices[G.indptr[i] : G.indptr[i + 1]]:
                    assert not (j != i and cf[j] == C_PT)

    def test_deterministic(self):
        prob = laplacian_2d_5pt(10)
        S = strength_graph(prob.A, 0.25)
        np.testing.assert_array_equal(
            pmis_native(S, seed=7), pmis_native(S, seed=7)
        )

    def test_full_hierarchy_with_native_coarsening(self):
        import jax.numpy as jnp

        from amg_jax.setup.hierarchy import HierarchyParams, build_hierarchy
        from amg_jax.smooth import SmootherType
        from amg_jax.solve import CycleConfig, CycleType, solve

        prob = laplacian_2d_5pt(24)
        params = HierarchyParams(
            coarsen_type="pmis_native", smoother=SmootherType.L1_JACOBI
        )
        hh, hier = build_hierarchy(prob.A, params, fine_stencil=prob.stencil)
        b = jnp.asarray(np.random.default_rng(0).random(prob.n))
        cfg = CycleConfig(cycle=CycleType.MULT, smoother=SmootherType.L1_JACOBI)
        res = solve(hier, cfg, b, tol=1e-8, max_cycles=60)
        assert float(res.rel_resnorm) <= 1e-8
        assert res.num_iters() <= 30
