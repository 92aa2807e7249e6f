"""Double-single PCG + mixed-precision elasticity solve (BASELINE config 4).

Round-3 VERDICT item 1: the 157k-dof DIA elasticity PCG stalled at relative
residual ~1e-1 in f32 (kappa ~ 1e8 defeats plain f32 Krylov) while f64
converged in 19 iterations. The fix is solve/mixed.py::mixed_pcg — DS-state
PCG (krylov.ds_pcg) against a double-single operator coefficient pair with
an f32 V-cycle preconditioner. These tests pin that path at scale, with the
truth measured in f64 on the host (reference convergence oracle pattern:
src/SMEM_Solve.cpp:95-103).
"""

import jax
import jax.numpy as jnp
import numpy as np

from amg_jax.ops.ds import DS, ds_dot, ds_matvec, ds_scale_add
from amg_jax.problems.elasticity import elasticity_beam
from amg_jax.setup.structured import (
    build_dia_structured_hierarchy,
    csr_to_dia_stencil,
)
from amg_jax.smooth import SmootherType
from amg_jax.solve import CycleConfig, CycleType
from amg_jax.solve.mixed import mixed_pcg


def _to_ds(v64):
    hi = v64.astype(np.float32)
    return DS(jnp.asarray(hi), jnp.asarray((v64 - hi).astype(np.float32)))


class TestDSOps:
    def test_ds_dot_beats_f32(self):
        """Compensated DS dot is ~f64-accurate where plain f32 loses digits
        (large cancellations)."""
        rng = np.random.default_rng(0)
        a64 = rng.standard_normal(50_000) * 1e3
        b64 = rng.standard_normal(50_000)
        exact = float(a64 @ b64)
        got = float(ds_dot(_to_ds(a64), _to_ds(b64)))
        plain = float(
            jnp.dot(jnp.asarray(a64, jnp.float32), jnp.asarray(b64, jnp.float32))
        )
        scale = float(np.abs(a64 * b64).sum())
        # the leading-products tree-sum is plain f32, so the bound is
        # ~eps*log(n) on the ABSOLUTE scale (ample for CG's alpha/beta)
        assert abs(got - exact) / scale < 1e-8
        assert abs(got - exact) <= abs(plain - exact)

    def test_ds_scale_add_accuracy(self):
        rng = np.random.default_rng(1)
        y64 = rng.standard_normal(10_000) * 1e4
        x64 = rng.standard_normal(10_000)
        alpha = np.float32(3.14159)
        out = ds_scale_add(_to_ds(y64), jnp.asarray(alpha), _to_ds(x64))
        got = np.asarray(out.hi, np.float64) + np.asarray(out.lo, np.float64)
        exact = y64 + float(alpha) * x64
        err = np.abs(got - exact) / (np.abs(exact) + 1e-30)
        assert err.max() < 1e-12

    def test_ds_matvec_pair_accuracy(self):
        """(A_hi, A_lo) pair matvec of a DS vector matches the f64 CSR
        matvec to ~1e-12 relative."""
        prob = elasticity_beam(nx=12, ny=4, nz=4, bc="identity")
        vs, vs_lo = csr_to_dia_stencil(
            prob.A, prob.grid_shape, jnp.float32, return_lo=True
        )
        rng = np.random.default_rng(2)
        x64 = rng.standard_normal(prob.n) * 1e2
        y = ds_matvec((vs, vs_lo), _to_ds(x64))
        got = np.asarray(y.hi, np.float64) + np.asarray(y.lo, np.float64)
        exact = prob.A @ x64
        assert (
            np.linalg.norm(got - exact) / np.linalg.norm(exact) < 1e-11
        )


class TestMixedPCGElasticity:
    def _solve(self, nx, ny, nz, tol=1e-5, max_cycles=60):
        prob = elasticity_beam(nx=nx, ny=ny, nz=nz, bc="identity")
        pair = csr_to_dia_stencil(
            prob.A, prob.grid_shape, jnp.float32, return_lo=True
        )
        _, hier = build_dia_structured_hierarchy(
            prob.A, (nx + 1, ny + 1, nz + 1), num_functions=3,
            dtype=jnp.float32,
        )
        cfg = CycleConfig(
            cycle=CycleType.MULT, smoother=SmootherType.L1_JACOBI,
            num_pre_sweeps=2, num_post_sweeps=2,
        )
        b64 = np.asarray(prob.rhs) / np.linalg.norm(prob.rhs)
        res = mixed_pcg(
            hier, pair, cfg, jnp.asarray(b64, jnp.float32),
            tol=tol, max_cycles=max_cycles,
        )
        x64 = np.asarray(res.x, np.float64) + np.asarray(res.x_lo, np.float64)
        true_rel = np.linalg.norm(b64 - prob.A @ x64)
        return res, true_rel

    def test_small_beam_true_residual(self):
        res, true_rel = self._solve(24, 6, 6)
        assert float(res.rel_resnorm) <= 1e-5
        assert true_rel <= 2e-5
        # DS-measured rel must agree with the f64 truth (no config-4-style
        # failure published as success)
        assert abs(true_rel - float(res.rel_resnorm)) <= 0.5 * true_rel + 1e-7

    def test_large_beam_converges_at_scale(self):
        """The >=100k-dof pin (VERDICT round 3): f32 device compute reaches
        1e-5 TRUE relative residual with an iteration count near the f64
        reference's ~19 — the scale where plain f32 PCG stalls at ~1e-1."""
        res, true_rel = self._solve(96, 18, 18)  # 105,051 dofs
        assert float(res.rel_resnorm) <= 1e-5
        assert true_rel <= 2e-5
        assert int(res.iters) <= 32

    def test_history_is_monotone_after_burn_in(self):
        res, _ = self._solve(24, 6, 6)
        h = np.asarray(res.history)
        h = h[~np.isnan(h)]
        # after the PCG burn-in hump the outer-scaled history decreases
        assert h[-1] < 1e-5 * 1.01
        assert (np.diff(np.log10(h[4:])) < 1.0).all()


class TestFusedMixedPCG:
    def test_fused_matches_unfused_exactly(self):
        """The single-program (one-launch) mixed_pcg must be bit-identical
        to the host-loop version: same restarts, same iterates."""
        prob = elasticity_beam(nx=48, ny=12, nz=12, bc="identity")
        pair = csr_to_dia_stencil(
            prob.A, prob.grid_shape, jnp.float32, return_lo=True
        )
        _, hier = build_dia_structured_hierarchy(
            prob.A, (49, 13, 13), num_functions=3, dtype=jnp.float32,
            smoother=SmootherType.HYBRID_JGS,
        )
        cfg = CycleConfig(
            cycle=CycleType.MULT, smoother=SmootherType.HYBRID_JGS,
            num_pre_sweeps=2, num_post_sweeps=2,
        )
        b = jnp.asarray(
            np.asarray(prob.rhs) / np.linalg.norm(prob.rhs), jnp.float32
        )
        ru = mixed_pcg(hier, pair, cfg, b, tol=1e-5, max_cycles=60,
                       fused=False)
        rf = mixed_pcg(hier, pair, cfg, b, tol=1e-5, max_cycles=60,
                       fused=True)
        assert int(ru.iters) == int(rf.iters)
        assert float(ru.rel_resnorm) == float(rf.rel_resnorm)
        np.testing.assert_array_equal(
            np.asarray(ru.x), np.asarray(rf.x)
        )
        np.testing.assert_array_equal(
            np.asarray(ru.x_lo), np.asarray(rf.x_lo)
        )


class TestELLPairMixed:
    def test_ell_ds_pair_matvec_true_operator(self):
        """The unstructured (ELL) DS operator pair: ds_matvec reproduces
        the true f64 matrix applied to the f32 input to ~1e-12 relative —
        mixed precision for the matrix-from-file path."""
        from amg_jax.sparse.ell import ell_ds_pair

        prob = elasticity_beam(nx=10, ny=4, nz=4, bc="identity")
        pair = ell_ds_pair(prob.A)
        x = jnp.asarray(
            np.random.default_rng(0).standard_normal(prob.n), jnp.float32
        )
        y = ds_matvec(pair, DS(x, jnp.zeros_like(x)))
        got = np.asarray(y.hi, np.float64) + np.asarray(y.lo, np.float64)
        exact = prob.A.to_scipy() @ np.asarray(x, np.float64)
        assert np.linalg.norm(got - exact) / np.linalg.norm(exact) < 1e-12

    def test_mixed_pcg_on_algebraic_hierarchy(self):
        """mixed_pcg with an ELL pair + a classical (algebraic) f32
        hierarchy: the file-matrix route reaches a TRUE residual (1e-9)
        far beyond the plain-f32 floor. (Laplacian, not the beam —
        classical AMG without rigid-body candidates is a known-poor
        elasticity preconditioner; SA+RBM is that path's recipe.)"""
        from amg_jax.problems import laplacian_3d_27pt
        from amg_jax.setup.hierarchy import HierarchyParams, build_hierarchy
        from amg_jax.sparse.ell import ell_ds_pair

        prob = laplacian_3d_27pt(14)
        pair = ell_ds_pair(prob.A)
        params = HierarchyParams(
            smoother=SmootherType.L1_JACOBI, dtype=jnp.float32,
            keep_stencil_fine=False,
        )
        _, hier = build_hierarchy(prob.A, params)
        cfg = CycleConfig(
            cycle=CycleType.MULT, smoother=SmootherType.L1_JACOBI,
        )
        b64 = np.random.default_rng(0).random(prob.n)
        b64 /= np.linalg.norm(b64)
        # pass the f64 RHS (numpy) so mixed_pcg's hi/lo split keeps the
        # full-precision b — pre-casting to f32 would floor the TRUE
        # residual at eps32*||b|| ~ 3e-8
        res = mixed_pcg(hier, pair, cfg, b64, tol=1e-9, max_cycles=80)
        assert float(res.rel_resnorm) <= 1e-9
        x64 = np.asarray(res.x, np.float64) + np.asarray(res.x_lo, np.float64)
        true_rel = np.linalg.norm(b64 - prob.A @ x64)
        assert true_rel <= 2e-9
