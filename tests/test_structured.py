"""Structured (geometric) hierarchy + mixed-precision refinement tests."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from amg_jax.ops.ds import two_prod, two_sum
from amg_jax.problems import laplacian_2d_5pt, laplacian_3d_27pt, difconv_3d
from amg_jax.setup.structured import (
    StructuredProlong,
    StructuredRestrict,
    _csr_to_var_stencil,
    _structured_P_csr,
    build_structured_hierarchy,
    VarStencilOperator,
    _axis_transfer_np,
    _prolong_axis,
    _restrict_axis,
)
from amg_jax.smooth import SmootherType
from amg_jax.solve import CycleConfig, CycleType, solve
from amg_jax.solve.mixed import mixed_solve
from amg_jax.sparse.stencil import stencil_to_csr


class TestTransfers:
    @pytest.mark.parametrize("shape", [(7, 5), (8, 6), (9, 9, 7), (6, 8, 4)])
    def test_device_ops_match_assembled(self, shape):
        cshape = tuple((s + 1) // 2 for s in shape)
        P = _structured_P_csr(shape, cshape)
        Pd = StructuredProlong(fine_shape=shape, coarse_shape=cshape)
        Rd = StructuredRestrict(fine_shape=shape, coarse_shape=cshape)
        xc = np.random.default_rng(0).random(int(np.prod(cshape)))
        xf = np.random.default_rng(1).random(int(np.prod(shape)))
        np.testing.assert_allclose(
            np.asarray(Pd @ jnp.asarray(xc)), P @ xc, atol=1e-14
        )
        np.testing.assert_allclose(
            np.asarray(Rd @ jnp.asarray(xf)), P.transpose() @ xf, atol=1e-14
        )

    @pytest.mark.parametrize("sf,sc", [(7, 4), (8, 4), (6, 4), (10, 6), (3, 2)],
                             ids=["odd", "even", "graded", "graded10", "tiny"])
    @pytest.mark.parametrize("axis", [0, 1, 2])
    def test_axis_ops_match_transfer_matrix(self, sf, sc, axis):
        """The strided-slice restrict/prolong along one axis of a 3-D
        array equal S^T / S of the 1-D transfer matrix, including the
        graded end (sf = 2 sc - 2)."""
        S = _axis_transfer_np(sf, sc)
        rng = np.random.default_rng(axis)
        shape = [3, 4, 5]
        shape[axis] = sf
        g = rng.random(shape)
        want = np.moveaxis(
            np.tensordot(S.T, np.moveaxis(g, axis, 0), axes=1), 0, axis)
        got = _restrict_axis(jnp.asarray(g), axis, sf, sc)
        np.testing.assert_allclose(np.asarray(got), want, atol=1e-14)
        shape[axis] = sc
        c = rng.random(shape)
        want = np.moveaxis(
            np.tensordot(S, np.moveaxis(c, axis, 0), axes=1), 0, axis)
        got = _prolong_axis(jnp.asarray(c), axis, sf, sc)
        np.testing.assert_allclose(np.asarray(got), want, atol=1e-14)

    def test_prolong_preserves_constants_interior(self):
        shape = (9, 9)
        cshape = (5, 5)
        Pd = StructuredProlong(fine_shape=shape, coarse_shape=cshape)
        out = np.asarray(Pd @ jnp.ones(25)).reshape(shape)
        # interior fine points interpolate the constant exactly
        np.testing.assert_allclose(out[1:-1, 1:-1], 1.0, atol=1e-14)


class TestVarStencil:
    def test_csr_roundtrip(self):
        prob = laplacian_2d_5pt(6, 5)
        vs = _csr_to_var_stencil(prob.A, (6, 5), jnp.float64)
        x = np.random.default_rng(0).random(30)
        np.testing.assert_allclose(
            np.asarray(vs @ jnp.asarray(x)), prob.A @ x, atol=1e-13
        )
        np.testing.assert_allclose(
            np.asarray(vs.diagonal()), prob.A.diagonal()
        )


class TestStructuredSolve:
    @pytest.mark.parametrize(
        "gen,max_rate",
        [
            (lambda: laplacian_3d_27pt(25), 0.32),
            (lambda: laplacian_3d_27pt(24), 0.32),
            (lambda: laplacian_2d_5pt(33), 0.55),
            (lambda: difconv_3d(20, eps=1.0, atype=0), 0.7),
        ],
        ids=["27pt-odd", "27pt-even", "5pt", "difconv"],
    )
    def test_convergence(self, gen, max_rate):
        prob = gen()
        hh, hier = build_structured_hierarchy(
            prob.stencil, smoother=SmootherType.L1_JACOBI
        )
        b = jnp.asarray(np.random.default_rng(0).random(prob.n))
        cfg = CycleConfig(cycle=CycleType.MULT, smoother=SmootherType.L1_JACOBI)
        res = solve(hier, cfg, b, tol=1e-8, max_cycles=60)
        assert float(res.rel_resnorm) <= 1e-8
        h = res.history_list()
        rate = (h[-1] / h[1]) ** (1.0 / (len(h) - 2))
        assert rate < max_rate, f"rate {rate}"
        # recheck against the assembled matrix
        r = np.asarray(b) - prob.A @ np.asarray(res.x)
        assert np.linalg.norm(r) / np.linalg.norm(np.asarray(b)) < 1.1e-8

    def test_h_independence(self):
        """Geometric MG rate must not degrade with problem size."""
        rates = []
        for n in (16, 32):
            prob = laplacian_3d_27pt(n)
            hh, hier = build_structured_hierarchy(
                prob.stencil, smoother=SmootherType.L1_JACOBI
            )
            b = jnp.asarray(np.random.default_rng(0).random(prob.n))
            cfg = CycleConfig(
                cycle=CycleType.MULT, smoother=SmootherType.L1_JACOBI
            )
            res = solve(hier, cfg, b, tol=1e-8, max_cycles=60)
            h = res.history_list()
            rates.append((h[-1] / h[1]) ** (1.0 / (len(h) - 2)))
        assert rates[1] < rates[0] + 0.1


class TestErrorFreeTransforms:
    def test_two_sum_exact(self):
        rng = np.random.default_rng(0)
        a = jnp.asarray(rng.random(1000), jnp.float32)
        b = jnp.asarray(rng.random(1000) * 1e-6, jnp.float32)
        s, e = two_sum(a, b)
        exact = a.astype(jnp.float64) + b.astype(jnp.float64)
        got = s.astype(jnp.float64) + e.astype(jnp.float64)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(exact))

    def test_two_prod_exact(self):
        rng = np.random.default_rng(1)
        a = jnp.asarray(rng.random(1000) * 37.0, jnp.float32)
        b = jnp.asarray(rng.random(1000), jnp.float32)
        p, e = two_prod(a, b)
        exact = a.astype(jnp.float64) * b.astype(jnp.float64)
        got = p.astype(jnp.float64) + e.astype(jnp.float64)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(exact))


class TestMixedPrecision:
    def test_mixed_solve_cpu_f64_path(self):
        prob = laplacian_3d_27pt(12)
        hh, hier32 = build_structured_hierarchy(
            prob.stencil, smoother=SmootherType.L1_JACOBI, dtype=jnp.float32
        )
        from amg_jax.sparse.stencil import StencilOperator

        A64 = StencilOperator(
            weights=jnp.asarray(np.asarray(prob.stencil.weights), jnp.float64),
            offsets=prob.stencil.offsets,
            grid_shape=prob.stencil.grid_shape,
        )
        b = jnp.asarray(np.random.default_rng(0).random(prob.n))
        cfg = CycleConfig(cycle=CycleType.MULT, smoother=SmootherType.L1_JACOBI)
        res = mixed_solve(hier32, A64, cfg, b, tol=1e-9, max_cycles=60)
        r = np.asarray(b) - prob.A @ np.asarray(res.x, np.float64)
        assert np.linalg.norm(r) / np.linalg.norm(np.asarray(b)) < 2e-9

    @pytest.mark.parametrize("platform", ["cpu", "gpu"])
    def test_mixed_solve_takes_f64_refinement(self, platform, monkeypatch):
        """mixed_solve refines in float64 on both platforms: the f32 V-cycle
        state under an f64 iterate reaches 1e-9 (true residual in f64), and
        the iterate is float64."""
        prob = laplacian_3d_27pt(16)
        hh, hier32 = build_structured_hierarchy(
            prob.stencil, smoother=SmootherType.L1_JACOBI, dtype=jnp.float32
        )
        from amg_jax.sparse.stencil import StencilOperator

        A64 = StencilOperator(
            weights=jnp.asarray(np.asarray(prob.stencil.weights), jnp.float64),
            offsets=prob.stencil.offsets,
            grid_shape=prob.stencil.grid_shape,
        )
        b = jnp.asarray(np.random.default_rng(0).random(prob.n), jnp.float32)
        cfg = CycleConfig(cycle=CycleType.MULT, smoother=SmootherType.L1_JACOBI)
        monkeypatch.setattr(jax, "default_backend", lambda: platform)
        res = mixed_solve(hier32, A64, cfg, b, tol=1e-9, max_cycles=60)
        assert res.x.dtype == jnp.float64 and res.x_lo is None
        b64 = np.asarray(b, np.float64)
        r = b64 - prob.A @ np.asarray(res.x)
        assert np.linalg.norm(r) / np.linalg.norm(b64) < 2e-9


class TestMixedAlgebraic:
    def test_f64_refinement_on_ell_hierarchy(self):
        """Mixed precision works on the algebraic (ELL) path too: f32 AMG
        cycles under f64 refinement reach ~1e-9 true residual."""
        from amg_jax.setup.hierarchy import HierarchyParams, build_hierarchy
        from amg_jax.sparse.ell import ell_from_csr

        prob = laplacian_2d_5pt(24)
        params = HierarchyParams(
            smoother=SmootherType.L1_JACOBI, dtype=jnp.float32,
            keep_stencil_fine=False,
        )
        hh, hier32 = build_hierarchy(prob.A, params)
        b64 = np.random.default_rng(0).random(prob.n)
        cfg = CycleConfig(cycle=CycleType.MULT, smoother=SmootherType.L1_JACOBI)
        res = mixed_solve(
            hier32, ell_from_csr(prob.A, dtype=jnp.float64), cfg,
            jnp.asarray(b64), tol=1e-9, max_cycles=80,
        )
        r = b64 - prob.A @ np.asarray(res.x)
        assert np.linalg.norm(r) / np.linalg.norm(b64) < 5e-9


def test_runner_structured_distributed():
    """Structured (geometric) hierarchy sharded over the mesh through the
    CLI path — iteration count matches single device."""
    from amg_jax.utils.config import SolverOptions
    from amg_jax.utils.runner import run_experiment

    st1 = run_experiment(SolverOptions(
        problem="27pt", n=16, hierarchy="structured", solver="mult",
    ))
    st8 = run_experiment(SolverOptions(
        problem="27pt", n=16, hierarchy="structured", solver="mult",
        num_devices=8,
    ))
    assert st8.rel_resnorm <= 1e-8
    assert st8.cycles == st1.cycles


class TestConstCoarse:
    """Round-5: coarse_op='auto' stores constant StencilOperators on coarse
    levels with min side >= 32 (exact-RAP interior weights; the single
    outer shell is the only approximation) — the zero-coefficient-traffic
    production configuration of the deep fused struct cycle."""

    def test_auto_gates_by_level_size(self):
        from amg_jax.setup.structured import VarStencilOperator

        prob = laplacian_3d_27pt(64)  # levels 64, 32, 16, 8
        _, hier = build_structured_hierarchy(
            prob.stencil, smoother=SmootherType.L1_JACOBI,
            dtype=jnp.float64,
        )
        from amg_jax.sparse.stencil import StencilOperator

        kinds = [type(lv.A) for lv in hier.levels]
        assert kinds[0] is StencilOperator
        assert kinds[1] is StencilOperator  # 32^3: const
        assert kinds[2] is VarStencilOperator  # 16^3: exact RAP kept
        # const weights equal the exact RAP interior row
        _, hv = build_structured_hierarchy(
            prob.stencil, smoother=SmootherType.L1_JACOBI,
            dtype=jnp.float64, coarse_op="var",
        )
        c = np.asarray(hv.levels[1].A.coeffs)
        center = c[(slice(None),) + tuple(s // 2 for s in c.shape[1:])]
        np.testing.assert_allclose(
            np.asarray(hier.levels[1].A.weights), center
        )

    def test_const_convergence_matches_var(self):
        """The shell perturbation on >=32 levels costs at most one cycle
        (measured zero at 126^3)."""
        from amg_jax.solve import solve

        prob = laplacian_3d_27pt(40)
        b = jnp.asarray(np.random.default_rng(0).random(prob.n))
        cfg = CycleConfig(
            cycle=CycleType.MULT, smoother=SmootherType.L1_JACOBI
        )
        its = {}
        for co in ("var", "auto"):
            _, h = build_structured_hierarchy(
                prob.stencil, smoother=SmootherType.L1_JACOBI,
                dtype=jnp.float64, coarse_op=co,
            )
            res = solve(h, cfg, b, tol=1e-8, max_cycles=60)
            assert float(res.rel_resnorm) <= 1e-8
            its[co] = int(res.iters)
        assert its["auto"] <= its["var"] + 1
