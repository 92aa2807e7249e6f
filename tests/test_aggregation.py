"""Smoothed-aggregation setup: candidate exactness, Laplacian convergence,
and the elasticity solve that classical interpolation provably stalls on
(the reference's beam problem, src/Elasticity.cpp:7-261)."""

import numpy as np
import pytest

import jax.numpy as jnp

from amg_jax.problems import laplacian_2d_5pt
from amg_jax.problems.elasticity import elasticity_beam, rigid_body_modes
from amg_jax.setup.aggregation import (
    aggregate,
    amalgamate,
    build_sa_host_hierarchy,
    sa_strength,
    tentative_prolongator,
)
from amg_jax.setup.hierarchy import HierarchyParams, build_hierarchy
from amg_jax.smooth import SmootherType
from amg_jax.solve import CycleConfig, CycleType, solve


def test_rigid_body_modes_in_kernel():
    """RBMs of the unconstrained operator must be (near-)kernel vectors."""
    p = elasticity_beam(6, 3, 3)
    # rebuild the unreduced operator via a fully-free beam: use the reduced
    # system's candidates instead — energy must be tiny away from the clamp
    B = np.asarray(p.near_nullspace)
    A = p.A.to_scipy()
    for k in range(B.shape[1]):
        v = B[:, k]
        energy = v @ (A @ v) / max(v @ v, 1e-300)
        # clamped-boundary truncation leaves some energy, but modes must be
        # low-energy relative to the spectrum (lambda_max ~ 10)
        assert energy < 2.0, (k, energy)


def test_tentative_prolongator_exact():
    p = elasticity_beam(8, 3, 3)
    B = np.asarray(p.near_nullspace)
    C = amalgamate(p.A, 3)
    agg = aggregate(sa_strength(C, 0.0))
    P, Bc = tentative_prolongator(agg, B, 3)
    Ps = P.to_scipy()
    np.testing.assert_allclose(Ps @ Bc, B, atol=1e-12)
    G = (Ps.T @ Ps).toarray()
    np.testing.assert_allclose(G, np.eye(G.shape[0]), atol=1e-12)


def test_aggregate_covers_all_nodes():
    p = laplacian_2d_5pt(16)
    agg = aggregate(sa_strength(p.A.to_scipy().tocsr(), 0.0))
    assert (agg >= 0).all()
    assert agg.max() + 1 < p.n


def test_sa_laplacian_vcycle_converges():
    p = laplacian_2d_5pt(32)
    params = HierarchyParams(setup_type="sa", keep_stencil_fine=False)
    hh, hier = build_hierarchy(p.A, params)
    cfg = CycleConfig(cycle=CycleType.MULT, smoother=params.smoother)
    b = jnp.asarray(np.random.default_rng(0).random(p.n))
    res = solve(hier, cfg, b, tol=1e-8, max_cycles=60)
    assert float(res.rel_resnorm) < 1e-8
    assert int(res.iters) <= 40


@pytest.mark.parametrize("setup_type", ["sa", "classical"])
def test_elasticity_solve(setup_type):
    """BASELINE config 4: the elasticity beam must actually solve. SA uses
    rigid-body candidates; classical relies on PCG + auto-damped JGS."""
    p = elasticity_beam(16, 4, 4)
    params = HierarchyParams(
        setup_type=setup_type,
        num_functions=3,
        smoother=SmootherType.HYBRID_JGS,
        build_smoothed_transfers=False,
    )
    hh, hier = build_hierarchy(
        p.A, params, near_nullspace=np.asarray(p.near_nullspace)
    )
    cfg = CycleConfig(
        cycle=CycleType.MULT,
        smoother=SmootherType.HYBRID_JGS,
        num_pre_sweeps=2,
        num_post_sweeps=2,
    )
    b = jnp.asarray(p.rhs)
    res = solve(hier, cfg, b, tol=1e-8, max_cycles=150, outer="pcg")
    assert float(res.rel_resnorm) < 1e-8
    assert int(res.iters) < 120


def test_jgs_auto_damping_preserves_convergent_case():
    """On the Laplacian (where undamped JGS converges) auto must keep w=1."""
    from amg_jax.smooth import make_smoother_data

    p = laplacian_2d_5pt(16)
    sm_auto = make_smoother_data(
        p.A, SmootherType.HYBRID_JGS, jgs_weight="auto"
    )
    sm_none = make_smoother_data(p.A, SmootherType.HYBRID_JGS, jgs_weight=None)
    np.testing.assert_allclose(
        np.asarray(sm_auto.block_inv), np.asarray(sm_none.block_inv)
    )


def test_rigid_body_modes_shape():
    c2 = np.random.default_rng(0).random((10, 2))
    assert rigid_body_modes(c2).shape == (20, 3)
    c3 = np.random.default_rng(0).random((10, 3))
    assert rigid_body_modes(c3).shape == (30, 6)


def test_isolated_nodes_not_aggregated():
    """Dirichlet identity rows (empty strength rows) stay off the coarse
    grid: agg == -1, zero P rows, and the coarse operator is nonsingular
    (regression: clamped singleton aggregates made the identity-BC beam's
    coarsest matrix exactly singular)."""
    import scipy.sparse as sp

    p = laplacian_2d_5pt(8)
    A = p.A.to_scipy().tolil()
    # carve out 5 identity rows
    iso = [0, 7, 20, 33, 63]
    for i in iso:
        A[i, :] = 0.0
        A[:, i] = 0.0
        A[i, i] = 1.0
    S = sa_strength(sp.csr_matrix(A), 0.0)
    agg = aggregate(S)
    assert (agg[iso] == -1).all()
    assert (agg[np.setdiff1d(np.arange(p.n), iso)] >= 0).all()


def test_identity_bc_elasticity_sa_solves():
    """The full-grid (bc='identity') beam through SA: clamped dofs are
    excluded from coarsening, rank-deficient aggregate columns dropped, and
    the solve reaches 1e-8 like the reduced system does."""
    from amg_jax.problems.elasticity import elasticity_beam as beam

    p = beam(8, 4, 4, bc="identity")
    params = HierarchyParams(setup_type="sa", num_functions=3)
    hh, hier = build_hierarchy(
        p.A, params, near_nullspace=np.asarray(p.near_nullspace)
    )
    # nonsingular coarsest: the dense inverse must be finite
    assert np.isfinite(np.asarray(hier.coarse_Ainv)).all()
    cfg = CycleConfig(cycle=CycleType.MULT, smoother=params.smoother)
    res = solve(
        hier, cfg, jnp.asarray(p.rhs), tol=1e-8, max_cycles=150, outer="pcg"
    )
    assert float(res.rel_resnorm) < 1e-8


def test_tentative_prolongator_drops_zero_columns():
    """A 2-node aggregate cannot represent the rotation about its own axis:
    the tentative prolongator's QR yields an exactly-zero column, which must
    be dropped (with its B_coarse row) while keeping P @ Bc == B."""
    from amg_jax.setup.aggregation import tentative_prolongator

    coords = np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0]])
    B = rigid_body_modes(coords)  # (6, 6)
    agg = np.zeros(2, dtype=np.int64)
    P, Bc = tentative_prolongator(agg, B, 3)
    assert P.shape[1] == 5  # rank 5: axis rotation lost
    np.testing.assert_allclose(P.to_scipy() @ Bc, B, atol=1e-12)
