"""BSR (blocked-ELL) format: conversion round-trip, SpMV parity vs CSR/ELL,
rectangular operators (P/R), and drop-in use inside the solver stack."""

import numpy as np
import pytest
import scipy.sparse as sp

from amg_jax.sparse import CSRMatrix, bsr_fill_stats, bsr_from_csr
from amg_jax.sparse.bsr import bsr_residual, bsr_spgemv, bsr_spmv
from amg_jax.sparse.ell import ell_from_csr, ell_spmv


def _random_csr(n, m, density, seed):
    rng = np.random.default_rng(seed)
    a = sp.random(n, m, density=density, random_state=rng, format="csr")
    a.data = rng.standard_normal(a.nnz)
    return CSRMatrix.from_scipy(a)


@pytest.mark.parametrize("bm,bn", [(8, 8), (4, 16), (8, 128), (3, 5)])
@pytest.mark.parametrize("n,m", [(100, 100), (97, 61), (61, 97)])
def test_bsr_spmv_matches_csr(bm, bn, n, m):
    csr = _random_csr(n, m, 0.08, seed=n * m + bm)
    a = bsr_from_csr(csr, bm=bm, bn=bn)
    x = np.random.default_rng(1).standard_normal(m)
    ref = csr.to_scipy() @ x
    got = np.asarray(bsr_spmv(a, x))
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12)


def test_bsr_matches_ell_on_laplacian():
    from amg_jax.problems import laplacian_2d_5pt

    prob = laplacian_2d_5pt(24)
    csr = prob.A
    a_bsr = bsr_from_csr(csr, bm=8, bn=8)
    a_ell = ell_from_csr(csr)
    x = np.random.default_rng(2).standard_normal(csr.n_rows)
    np.testing.assert_allclose(
        np.asarray(bsr_spmv(a_bsr, x)),
        np.asarray(ell_spmv(a_ell, x)),
        rtol=1e-12,
        atol=1e-12,
    )


def test_bsr_fused_and_residual():
    csr = _random_csr(64, 64, 0.1, seed=7)
    a = bsr_from_csr(csr)
    rng = np.random.default_rng(3)
    x, b = rng.standard_normal(64), rng.standard_normal(64)
    s = csr.to_scipy()
    np.testing.assert_allclose(
        np.asarray(bsr_spgemv(a, x, b, -1.5, 2.0)), -1.5 * (s @ x) + 2.0 * b,
        rtol=1e-12,
    )
    np.testing.assert_allclose(
        np.asarray(bsr_residual(a, x, b)), b - s @ x, rtol=1e-12
    )


def test_bsr_empty_matrix():
    csr = CSRMatrix.from_scipy(sp.csr_matrix((16, 16)))
    a = bsr_from_csr(csr)
    y = np.asarray(bsr_spmv(a, np.ones(16)))
    np.testing.assert_array_equal(y, np.zeros(16))


def test_fill_stats_reports_gather_reduction():
    from amg_jax.problems import laplacian_3d_27pt

    csr = laplacian_3d_27pt(12).A
    st = bsr_fill_stats(csr, bm=8, bn=8)
    assert st["nnz"] == csr.nnz
    assert st["gathers_bsr"] < st["gathers_ell"]
    assert st["blowup"] >= 1.0


def test_bsr_in_vcycle_matches_ell():
    """Swapping the device format must not change the solve at all —
    same operators, same arithmetic (up to summation order)."""
    import jax.numpy as jnp

    from amg_jax.problems import laplacian_2d_5pt
    from amg_jax.setup.hierarchy import HierarchyParams, build_hierarchy
    from amg_jax.solve import CycleConfig, CycleType, mult_vcycle

    prob = laplacian_2d_5pt(16)
    params = HierarchyParams(keep_stencil_fine=False)
    hh, hier_ell = build_hierarchy(prob.A, params)

    # rebuild device levels in BSR
    from amg_jax.setup.hierarchy import device_hierarchy

    params_bsr = HierarchyParams(keep_stencil_fine=False, device_format="bsr")
    hier_bsr = device_hierarchy(hh, params_bsr)

    cfg = CycleConfig(cycle=CycleType.MULT)
    b = jnp.asarray(np.random.default_rng(0).standard_normal(prob.n))
    x0 = jnp.zeros_like(b)
    x_ell = np.asarray(mult_vcycle(hier_ell, cfg, x0, b))
    x_bsr = np.asarray(mult_vcycle(hier_bsr, cfg, x0, b))
    np.testing.assert_allclose(x_bsr, x_ell, rtol=1e-10, atol=1e-12)
