"""Solver convergence tests — the convergence-history oracle of SURVEY.md §4.

Baseline config 1: 2D 5-pt Laplacian, synchronous AMG V-cycle to 1e-8."""

import numpy as np
import pytest

import jax.numpy as jnp

from amg_jax.problems import laplacian_2d_5pt, laplacian_3d_27pt
from amg_jax.setup.hierarchy import HierarchyParams, build_hierarchy
from amg_jax.smooth import SmootherType
from amg_jax.solve import CycleConfig, CycleType, solve
from amg_jax.solve.driver import cheby_setup


@pytest.fixture(scope="module")
def lap32():
    prob = laplacian_2d_5pt(32)
    params = HierarchyParams(smoother=SmootherType.L1_JACOBI)
    hh, hier = build_hierarchy(prob.A, params, fine_stencil=prob.stencil)
    b = jnp.asarray(np.random.default_rng(0).random(prob.n))
    return prob, hh, hier, b


def check_solution(prob, res, b, tol):
    r = np.asarray(b) - prob.A @ np.asarray(res.x)
    r0 = np.linalg.norm(np.asarray(b))
    assert np.linalg.norm(r) / r0 <= tol * 1.01, "residual recheck failed"


class TestMult:
    def test_vcycle_to_1e8(self, lap32):
        prob, hh, hier, b = lap32
        cfg = CycleConfig(cycle=CycleType.MULT, smoother=SmootherType.L1_JACOBI)
        res = solve(hier, cfg, b, tol=1e-8, max_cycles=60)
        assert res.num_iters() <= 25, f"too many V-cycles: {res.num_iters()}"
        check_solution(prob, res, b, 1e-8)
        # monotone history with sane rate
        h = res.history_list()
        rate = (h[-1] / h[1]) ** (1.0 / (len(h) - 2))
        assert rate < 0.45

    def test_zero_rhs_fixed_point(self, lap32):
        prob, hh, hier, b = lap32
        cfg = CycleConfig(cycle=CycleType.MULT, smoother=SmootherType.L1_JACOBI)
        res = solve(hier, cfg, jnp.zeros_like(b), tol=1e-8, max_cycles=5)
        assert float(jnp.max(jnp.abs(res.x))) == 0.0

    def test_hybrid_jgs_faster_than_jacobi(self):
        prob = laplacian_2d_5pt(24)
        b = jnp.asarray(np.random.default_rng(1).random(prob.n))
        iters = {}
        for sm in (SmootherType.L1_JACOBI, SmootherType.HYBRID_JGS):
            params = HierarchyParams(smoother=sm)
            hh, hier = build_hierarchy(prob.A, params, fine_stencil=prob.stencil)
            cfg = CycleConfig(cycle=CycleType.MULT, smoother=sm)
            res = solve(hier, cfg, b, tol=1e-8, max_cycles=60)
            iters[sm] = res.num_iters()
        assert iters[SmootherType.HYBRID_JGS] <= iters[SmootherType.L1_JACOBI]


class TestAdditive:
    def test_multadd_smoothed_transfers_standalone(self, lap32):
        """multadd with smoothed interpolants converges as a standalone
        iteration (the reference's headline solver)."""
        prob, hh, hier, b = lap32
        cfg = CycleConfig(
            cycle=CycleType.MULTADD,
            smoother=SmootherType.L1_JACOBI,
            use_smoothed_transfers=True,
        )
        res = solve(hier, cfg, b, tol=1e-8, max_cycles=100)
        assert res.num_iters() <= 60
        check_solution(prob, res, b, 1e-8)

    def test_multadd_cheby(self, lap32):
        prob, hh, hier, b = lap32
        cfg = CycleConfig(
            cycle=CycleType.MULTADD,
            smoother=SmootherType.L1_JACOBI,
            use_smoothed_transfers=True,
        )
        coeffs = cheby_setup(hier, cfg, num_iters=15)
        res = solve(
            hier, cfg, b, tol=1e-8, max_cycles=60, accel="cheby", cheby_coeffs=coeffs
        )
        assert res.num_iters() <= 25
        check_solution(prob, res, b, 1e-8)

    def test_afacx(self, lap32):
        prob, hh, hier, b = lap32
        cfg = CycleConfig(cycle=CycleType.AFACX, smoother=SmootherType.L1_JACOBI)
        res = solve(hier, cfg, b, tol=1e-8, max_cycles=60)
        assert res.num_iters() <= 40
        check_solution(prob, res, b, 1e-8)

    def test_bpx_pcg(self, lap32):
        prob, hh, hier, b = lap32
        cfg = CycleConfig(cycle=CycleType.BPX, smoother=SmootherType.L1_JACOBI)
        res = solve(hier, cfg, b, tol=1e-8, max_cycles=60, outer="pcg")
        assert res.num_iters() <= 40
        check_solution(prob, res, b, 1e-8)

    def test_multadd_pcg(self, lap32):
        prob, hh, hier, b = lap32
        cfg = CycleConfig(cycle=CycleType.MULTADD, smoother=SmootherType.L1_JACOBI)
        res = solve(hier, cfg, b, tol=1e-8, max_cycles=60, outer="pcg")
        assert res.num_iters() <= 30
        check_solution(prob, res, b, 1e-8)


class Test3D:
    def test_27pt_jacobi_cheby(self):
        """Baseline config 2 (small): 3D 27-pt, Jacobi + Chebyshev."""
        prob = laplacian_3d_27pt(10)
        params = HierarchyParams(smoother=SmootherType.JACOBI)
        hh, hier = build_hierarchy(prob.A, params, fine_stencil=prob.stencil)
        b = jnp.asarray(np.random.default_rng(2).random(prob.n))
        cfg = CycleConfig(cycle=CycleType.MULT, smoother=SmootherType.JACOBI)
        res = solve(hier, cfg, b, tol=1e-8, max_cycles=60)
        assert res.num_iters() <= 30
        r = np.asarray(b) - prob.A @ np.asarray(res.x)
        assert np.linalg.norm(r) / np.linalg.norm(np.asarray(b)) <= 1.1e-8


class TestLanczos:
    def test_lanczos_bounds_match_power(self):
        import jax.numpy as jnp

        from amg_jax.solve.accel import estimate_cycle_eigs, estimate_eigs_lanczos
        from amg_jax.solve.cycles import cycle_step

        prob = laplacian_2d_5pt(16)
        params = HierarchyParams(smoother=SmootherType.JACOBI)
        hh, hier = build_hierarchy(prob.A, params, fine_stencil=prob.stencil)
        A = prob.A.to_dense()
        d = prob.A.diagonal()
        op = lambda u: jnp.asarray(1.0 / d) * (hier.levels[0].A @ u)
        exact = np.linalg.eigvals(np.diag(1.0 / d) @ A).real
        lz = estimate_eigs_lanczos(op, prob.n, jnp.float64, num_iters=40)
        assert lz.beta >= exact.max() * 0.98
        assert lz.alpha <= exact.min() * 1.2 + 1e-6
        pw = estimate_cycle_eigs(op, prob.n, jnp.float64, num_iters=40)
        assert abs(lz.beta - pw.beta) / pw.beta < 0.1


class TestLOBPCG:
    def test_lobpcg_bounds_vs_dense(self):
        """Block LOBPCG (reference -cheby_eig hypre_lobpcg,
        src/SMEM_Cheby.cpp:255-408) brackets the dense spectrum of the
        Jacobi-preconditioned operator from one run."""
        import jax.numpy as jnp

        from amg_jax.solve.accel import estimate_eigs_lobpcg

        prob = laplacian_2d_5pt(16)
        params = HierarchyParams(smoother=SmootherType.JACOBI)
        hh, hier = build_hierarchy(prob.A, params, fine_stencil=prob.stencil)
        A = prob.A.to_dense()
        d = prob.A.diagonal()
        op = lambda u: jnp.asarray(1.0 / d) * (hier.levels[0].A @ u)
        exact = np.linalg.eigvals(np.diag(1.0 / d) @ A).real
        lb = estimate_eigs_lobpcg(op, prob.n, jnp.float64, num_iters=15)
        # bounds bracket the spectrum (with the built-in 0.95/1.05 margins)
        assert lb.beta >= exact.max() * 0.99
        assert lb.alpha <= exact.min() * 1.05 + 1e-6
        assert lb.alpha > 0
        # the Ritz extremes are SHARP at this subspace size, not just bounds
        assert lb.beta <= exact.max() * 1.10
        assert lb.alpha >= exact.min() * 0.80

    def test_cheby_eig_method_selector(self):
        """cheby_setup's method menu: all three estimators produce coeffs
        that accelerate the additive solve to tolerance."""
        from amg_jax.solve.driver import cheby_setup

        prob = laplacian_2d_5pt(24)
        params = HierarchyParams(smoother=SmootherType.L1_JACOBI)
        hh, hier = build_hierarchy(prob.A, params, fine_stencil=prob.stencil)
        b = jnp.asarray(np.random.default_rng(0).random(prob.n))
        cfg = CycleConfig(
            cycle=CycleType.MULTADD, smoother=SmootherType.L1_JACOBI,
            use_smoothed_transfers=True,
        )
        iters = {}
        for method in ("power", "lobpcg", "lanczos"):
            coeffs = cheby_setup(hier, cfg, num_iters=20, method=method)
            res = solve(hier, cfg, b, tol=1e-8, max_cycles=80,
                        accel="cheby", cheby_coeffs=coeffs)
            assert float(res.rel_resnorm) <= 1e-8, method
            iters[method] = res.num_iters()
        # similar-quality bounds -> similar accelerated iteration counts
        assert max(iters.values()) <= min(iters.values()) + 10, iters

    def test_cli_cheby_eig_aliases(self):
        """Reference spellings hypre_lobpcg/slepc map to the native
        estimators in the post-parse fixup (src/SMEM_Main.cpp:606-618)."""
        from amg_jax.utils.config import SolverOptions

        o = SolverOptions(cheby_eig="hypre_lobpcg").fixup()
        assert o.cheby_eig == "lobpcg"
        o = SolverOptions(cheby_eig="slepc").fixup()
        assert o.cheby_eig == "lanczos"


class TestMultMultadd:
    """MULT_MULTADD hybrid: multiplicative V-cycle with multadd as the
    coarse-grid solver below coarsest_mult_level (reference solver 4,
    src/DMEM_Main.cpp:714-719,847-852; src/DMEM_Add.cpp:215)."""

    def _setup(self, n=32):
        prob = laplacian_2d_5pt(n)
        params = HierarchyParams(smoother=SmootherType.L1_JACOBI)
        hh, hier = build_hierarchy(prob.A, params, fine_stencil=prob.stencil)
        b = jnp.asarray(np.random.default_rng(0).random(prob.n))
        return prob, hier, b

    def test_converges(self):
        prob, hier, b = self._setup()
        cfg = CycleConfig(
            cycle=CycleType.MULT_MULTADD, smoother=SmootherType.L1_JACOBI,
            use_smoothed_transfers=True, coarsest_mult_level=1,
            num_inner_cycles=2,
        )
        res = solve(hier, cfg, b, tol=1e-8, max_cycles=80)
        assert float(res.rel_resnorm) <= 1e-8
        assert res.num_iters() <= 40
        r = np.asarray(b) - prob.A @ np.asarray(res.x)
        assert np.linalg.norm(r) / np.linalg.norm(np.asarray(b)) <= 2e-8

    def test_degenerates_to_mult_at_coarsest(self):
        """coarsest_mult_level = L-1 with one inner cycle IS the plain
        multiplicative V-cycle (the inner additive solve on the one-level
        sub-hierarchy is exactly the dense coarse solve)."""
        prob, hier, b = self._setup(24)
        L = hier.num_levels
        cfg_m = CycleConfig(cycle=CycleType.MULT,
                            smoother=SmootherType.L1_JACOBI)
        cfg_h = CycleConfig(
            cycle=CycleType.MULT_MULTADD, smoother=SmootherType.L1_JACOBI,
            coarsest_mult_level=L - 1, num_inner_cycles=1,
        )
        res_m = solve(hier, cfg_m, b, tol=1e-8, max_cycles=60)
        res_h = solve(hier, cfg_h, b, tol=1e-8, max_cycles=60)
        assert int(res_h.iters) == int(res_m.iters)
        np.testing.assert_allclose(
            np.asarray(res_h.x), np.asarray(res_m.x), rtol=1e-12, atol=1e-15
        )

    def test_cli_solver(self):
        from amg_jax.utils.config import SolverOptions
        from amg_jax.utils.runner import run_experiment

        st = run_experiment(SolverOptions(
            problem="5pt", n=24, solver="mult_multadd",
            coarsest_mult_level=1, num_inner_cycles=2,
        ))
        assert st.rel_resnorm <= 1e-8


def test_no_resnorm_fixed_cycles():
    """-no_resnorm runs exactly num_cycles cycles without per-cycle norms
    (the reference's pure cycle-timing mode); the final iterate matches the
    norm-checked loop run for the same count."""
    import jax.numpy as jnp
    import numpy as np

    from amg_jax.problems import laplacian_2d_5pt
    from amg_jax.setup.hierarchy import HierarchyParams, build_hierarchy
    from amg_jax.smooth import SmootherType
    from amg_jax.solve import CycleConfig, CycleType, solve

    prob = laplacian_2d_5pt(16)
    hh, hier = build_hierarchy(
        prob.A, HierarchyParams(smoother=SmootherType.L1_JACOBI)
    )
    b = jnp.asarray(np.random.default_rng(0).random(prob.n))
    cfg = CycleConfig(cycle=CycleType.MULT, smoother=SmootherType.L1_JACOBI)
    fixed = solve(hier, cfg, b, tol=0.0, max_cycles=7, no_resnorm=True)
    ref = solve(hier, cfg, b, tol=0.0, max_cycles=7)
    assert int(fixed.iters) == 7
    np.testing.assert_allclose(np.asarray(fixed.x), np.asarray(ref.x),
                               rtol=1e-14, atol=1e-14)
    h = np.asarray(fixed.history)
    assert np.isnan(h[1:7]).all() and not np.isnan(h[7])
