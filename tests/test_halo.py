"""Explicit ppermute halo exchange: the shard_map stencil matvec and smoother
sweep must be exactly equal to the single-device apply (semantics identical,
schedule different). The constant-vector-style probe follows the reference's
comm-layer test pattern (src/DMEM_Test.cpp:7-58)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from amg_jax.parallel import make_row_mesh
from amg_jax.parallel.dist import shard_vector
from amg_jax.parallel.halo import halo_jacobi_sweep, halo_stencil_matvec
from amg_jax.problems import laplacian_3d_27pt, laplacian_3d_7pt


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) >= 8
    return make_row_mesh(8)


@pytest.mark.parametrize("gen", [laplacian_3d_7pt, laplacian_3d_27pt])
def test_halo_matvec_matches_single_device(mesh, gen):
    prob = gen(16)
    A = prob.stencil
    x = jnp.asarray(np.random.default_rng(0).random(prob.n))
    y_ref = np.asarray(A @ x)
    mv, coeffs = halo_stencil_matvec(A, mesh)
    y = np.asarray(mv(shard_vector(x, mesh), coeffs))
    np.testing.assert_allclose(y, y_ref, rtol=1e-13, atol=1e-13)


def test_halo_matvec_constant_vector_probe(mesh):
    """A @ 1 hits every halo plane: interior rows of the 7-pt operator sum
    to 6/h^2 - ... — just compare against the dense row sums."""
    prob = laplacian_3d_7pt(16)
    ones = jnp.ones(prob.n)
    mv, coeffs = halo_stencil_matvec(prob.stencil, mesh)
    got = np.asarray(mv(shard_vector(ones, mesh), coeffs))
    ref = np.asarray(prob.stencil @ ones)
    np.testing.assert_allclose(got, ref, rtol=1e-13)


def test_halo_var_stencil(mesh):
    """Variable-coefficient (PFMG-style) level operator through the halo
    path."""
    from amg_jax.setup.structured import build_structured_hierarchy
    from amg_jax.smooth import SmootherType

    prob = laplacian_3d_27pt(16)
    _, hier = build_structured_hierarchy(
        prob.stencil, smoother=SmootherType.L1_JACOBI
    )
    A1 = hier.levels[1].A  # coarse level: VarStencilOperator
    n1 = A1.n_rows
    x = jnp.asarray(np.random.default_rng(1).random(n1))
    y_ref = np.asarray(A1 @ x)
    mv, coeffs = halo_stencil_matvec(A1, mesh)
    y = np.asarray(mv(shard_vector(x, mesh), coeffs))
    np.testing.assert_allclose(y, y_ref, rtol=1e-13, atol=1e-13)


def test_halo_jacobi_sweep_matches(mesh):
    prob = laplacian_3d_27pt(16)
    A = prob.stencil
    rng = np.random.default_rng(2)
    u = jnp.asarray(rng.random(prob.n))
    b = jnp.asarray(rng.random(prob.n))
    iw = (2.0 / 3.0) / np.asarray(A.diagonal())
    ref = np.asarray(u + jnp.asarray(iw) * (b - A @ u))
    sweep, coeffs = halo_jacobi_sweep(A, mesh, iw)
    got = np.asarray(
        sweep(
            shard_vector(u, mesh),
            shard_vector(b, mesh),
            shard_vector(jnp.asarray(iw), mesh),
            coeffs,
        )
    )
    np.testing.assert_allclose(got, ref, rtol=1e-13, atol=1e-13)


def test_halo_stencil_operator_matmul(mesh):
    """HaloStencilOperator's @ equals the single-device stencil matvec."""
    from amg_jax.parallel.halo import make_halo_stencil

    prob = laplacian_3d_27pt(16)
    h = make_halo_stencil(prob.stencil, mesh)
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.random(prob.n))
    ref = np.asarray(prob.stencil @ x)
    got = np.asarray(jax.jit(lambda v: h @ v)(shard_vector(x, mesh)))
    np.testing.assert_allclose(got, ref, rtol=1e-13, atol=1e-13)


def test_runner_async_smooth_distributed():
    """The distributed one-level async smoothing path (halo exchange per
    sweep, reference src/DMEM_Smooth.cpp:16-313) solves through the CLI."""
    from amg_jax.utils.config import SolverOptions
    from amg_jax.utils.runner import run_experiment

    st = run_experiment(SolverOptions(
        problem="7pt", n=16, solver="async_smooth", num_devices=8,
        tol=1e-5, num_cycles=4000,
    ))
    assert st.rel_resnorm <= 1e-5
