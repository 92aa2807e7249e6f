"""Async bounded-staleness solver + extended-system tests.

Baseline config 3: single-chip asynchronous-smoothing AMG semantics."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from amg_jax.problems import laplacian_2d_5pt
from amg_jax.setup.hierarchy import HierarchyParams, build_hierarchy
from amg_jax.smooth import SmootherType
from amg_jax.solve import CycleConfig, CycleType
from amg_jax.solve.accel import estimate_cycle_eigs
from amg_jax.solve.async_sim import AsyncConfig, async_solve
from amg_jax.solve.extended import (
    build_extended_system,
    ext_matvec,
    ext_prolong,
    ext_restrict,
    ext_solve,
)


@pytest.fixture(scope="module")
def setup32():
    prob = laplacian_2d_5pt(32)
    params = HierarchyParams(smoother=SmootherType.L1_JACOBI)
    hh, hier = build_hierarchy(prob.A, params, fine_stencil=prob.stencil)
    b = jnp.asarray(np.random.default_rng(0).random(prob.n))
    return prob, hh, hier, b, params


def multadd_cfg():
    return CycleConfig(
        cycle=CycleType.MULTADD,
        smoother=SmootherType.L1_JACOBI,
        use_smoothed_transfers=True,
    )


class TestAsyncSim:
    def test_converges_with_staleness(self, setup32):
        prob, hh, hier, b, params = setup32
        acfg = AsyncConfig(read_type="sol", async_type="semi", sim_read_delay=4)
        res = async_solve(hier, multadd_cfg(), acfg, b, tol=1e-8, max_cycles=500)
        assert float(res.rel_resnorm) <= 1e-8
        r = np.asarray(b) - prob.A @ np.asarray(res.x)
        assert np.linalg.norm(r) / np.linalg.norm(np.asarray(b)) < 1.1e-8

    def test_staleness_degrades_convergence(self, setup32):
        prob, hh, hier, b, params = setup32
        iters = {}
        for delay in (0, 8):
            acfg = AsyncConfig(read_type="sol", async_type="full", sim_read_delay=delay)
            res = async_solve(
                hier, multadd_cfg(), acfg, b, tol=1e-8, max_cycles=800,
                key=jax.random.PRNGKey(7),
            )
            iters[delay] = int(res.iters)
            assert float(res.rel_resnorm) <= 1e-8
        assert iters[8] > iters[0]

    def test_grid_wait_stats_bounded(self, setup32):
        prob, hh, hier, b, params = setup32
        acfg = AsyncConfig(sim_read_delay=4)
        res = async_solve(hier, multadd_cfg(), acfg, b, tol=1e-6, max_cycles=300)
        gw = res.grid_wait.summary()
        L = hier.num_levels
        assert len(gw["mean"]) == L
        # every level applied at least once; waits are positive and bounded
        assert min(gw["num_correct"]) > 0
        assert all(0.0 <= m <= 4 * L for m in gw["mean"])

    def test_fault_injection_survives(self, setup32):
        """Transient failure of one grid group: solver still converges and the
        failed level records fewer corrections (reference -fail_one semantics,
        src/SMEM_Main.cpp:572-596)."""
        prob, hh, hier, b, params = setup32
        acfg = AsyncConfig(fail_level=1, fail_start=10, fail_duration=100)
        res = async_solve(hier, multadd_cfg(), acfg, b, tol=1e-8, max_cycles=800)
        assert float(res.rel_resnorm) <= 1e-8
        counts = res.grid_wait.summary()["num_correct"]
        others = [c for i, c in enumerate(counts) if i != 1]
        assert counts[1] < min(others)

    def test_deterministic_under_key(self, setup32):
        prob, hh, hier, b, params = setup32
        acfg = AsyncConfig()
        r1 = async_solve(hier, multadd_cfg(), acfg, b, tol=1e-6, max_cycles=200,
                         key=jax.random.PRNGKey(3))
        r2 = async_solve(hier, multadd_cfg(), acfg, b, tol=1e-6, max_cycles=200,
                         key=jax.random.PRNGKey(3))
        assert int(r1.iters) == int(r2.iters)
        np.testing.assert_array_equal(np.asarray(r1.x), np.asarray(r2.x))


class TestExtendedSystem:
    def test_implicit_equals_explicit(self, setup32):
        prob, hh, hier, b, params = setup32
        ext_i = build_extended_system(hh, params, explicit=False)
        ext_e = build_extended_system(hh, params, explicit=True)
        U = jnp.asarray(np.random.default_rng(1).random(ext_i.offsets[-1]))
        yi = ext_matvec(ext_i, hier.levels[0].A, U)
        ye = ext_matvec(ext_e, hier.levels[0].A, U)
        np.testing.assert_allclose(np.asarray(yi), np.asarray(ye), atol=1e-11)

    def test_galerkin_block_structure(self, setup32):
        """AA = C^T A0 C with C the prolongation chains."""
        prob, hh, hier, b, params = setup32
        ext = build_extended_system(hh, params, explicit=False)
        U = jnp.asarray(np.random.default_rng(2).random(ext.offsets[-1]))
        x = ext_prolong(ext, U)
        expect = ext_restrict(ext, jnp.asarray(prob.A @ np.asarray(x)))
        got = ext_matvec(ext, hier.levels[0].A, U)
        np.testing.assert_allclose(np.asarray(got), np.asarray(expect), atol=1e-11)

    def test_cheby_solve(self, setup32):
        prob, hh, hier, b, params = setup32
        ext = build_extended_system(hh, params, explicit=False)
        A0 = hier.levels[0].A
        cc = estimate_cycle_eigs(
            lambda u: ext.inv_wdiag * ext_matvec(ext, A0, u),
            ext.offsets[-1], jnp.float64, num_iters=30, range_start=True,
        )
        res = ext_solve(hier, ext, b, tol=1e-8, max_cycles=200, cheby_coeffs=cc)
        assert int(res.iters) <= 60
        r = np.asarray(b) - prob.A @ np.asarray(res.x)
        assert np.linalg.norm(r) / np.linalg.norm(np.asarray(b)) <= 1.1e-8

    def test_async_solve(self, setup32):
        prob, hh, hier, b, params = setup32
        ext = build_extended_system(hh, params, explicit=False)
        A0 = hier.levels[0].A
        cc = estimate_cycle_eigs(
            lambda u: ext.inv_wdiag * ext_matvec(ext, A0, u),
            ext.offsets[-1], jnp.float64, num_iters=30, range_start=True,
        )
        res = ext_solve(
            hier, ext, b, tol=1e-8, max_cycles=800, cheby_coeffs=cc,
            async_fire_prob=0.7, sim_read_delay=3,
        )
        assert float(res.rel_resnorm) <= 1e-8


class TestAsyncSmooth:
    def test_southwell_converges_and_balances(self, setup32):
        from amg_jax.solve.async_smooth import (
            AsyncSmoothConfig,
            async_smooth_solve,
            block_neighbor_mask,
        )
        from amg_jax.smooth import make_smoother_data
        from amg_jax.sparse.ell import ell_from_csr

        prob, hh, hier, b, params = setup32
        A = ell_from_csr(prob.A)
        sm = make_smoother_data(prob.A, SmootherType.L1_JACOBI, w=1.0)
        nbr = block_neighbor_mask(prob.A, 8)
        cfg = AsyncSmoothConfig(
            smoother=SmootherType.L1_JACOBI, num_blocks=8,
            method="southwell_exp", sps_alpha=0.5,
        )
        res = async_smooth_solve(A, sm, cfg, nbr, b, tol=1e-3, max_cycles=5000)
        assert float(res.rel_resnorm) <= 1e-3
        counts = np.asarray(res.block_updates)
        assert counts.min() > 0

    def test_fixed_prob_slower_than_always(self, setup32):
        from amg_jax.solve.async_smooth import (
            AsyncSmoothConfig,
            async_smooth_solve,
            block_neighbor_mask,
        )
        from amg_jax.smooth import make_smoother_data
        from amg_jax.sparse.ell import ell_from_csr

        prob, hh, hier, b, params = setup32
        A = ell_from_csr(prob.A)
        sm = make_smoother_data(prob.A, SmootherType.L1_JACOBI, w=1.0)
        nbr = block_neighbor_mask(prob.A, 8)
        iters = {}
        for p in (1.0, 0.5):
            cfg = AsyncSmoothConfig(
                smoother=SmootherType.L1_JACOBI, num_blocks=8,
                method="fixed", fire_prob=p,
            )
            res = async_smooth_solve(
                A, sm, cfg, nbr, b, tol=1e-2, max_cycles=4000,
                key=jax.random.PRNGKey(0),
            )
            iters[p] = int(res.iters)
        assert iters[0.5] > iters[1.0]


class TestResUpdateMode:
    def test_incremental_residual_converges(self, setup32):
        """READ_RES + LOCAL res_compute analog: the maintained residual
        (updated incrementally, never recomputed) still drives the solve to
        a TRUE small residual."""
        prob, hh, hier, b, params = setup32
        acfg = AsyncConfig(read_type="res", res_mode="update",
                           async_type="semi", sim_read_delay=3)
        res = async_solve(hier, multadd_cfg(), acfg, b, tol=1e-8, max_cycles=600)
        assert float(res.rel_resnorm) <= 1e-8
        r = np.asarray(b) - prob.A @ np.asarray(res.x)
        assert np.linalg.norm(r) / np.linalg.norm(np.asarray(b)) < 1e-7


class TestAsyncCoalescing:
    """comm_every in the single-program async solve: corrections publish to
    the shared state every Nth superstep, with each level seeing its own
    pending corrections immediately (reference -async_comm_save_divisor,
    src/DMEM_Add.cpp:375-383)."""

    def test_comm_every_converges_and_differs(self, setup32):
        prob, hh, hier, b, params = setup32
        cfg = multadd_cfg()
        key = jax.random.PRNGKey(3)
        res1 = async_solve(
            hier, cfg, AsyncConfig(omega=0.6, comm_every=1), b,
            key=key, tol=1e-8, max_cycles=400,
        )
        res4 = async_solve(
            hier, cfg, AsyncConfig(omega=0.6, comm_every=4), b,
            key=key, tol=1e-8, max_cycles=400,
        )
        assert float(res4.rel_resnorm) <= 1e-8
        # the flag must actually change the trajectory
        m = min(int(res1.iters), int(res4.iters))
        h1 = res1.history[:m]
        h4 = res4.history[:m]
        assert float(jnp.max(jnp.abs(h1 - h4))) > 0.0
        # shared state is frozen between publishes
        h = np.asarray(res4.history)
        assert h[1] == h[2] == h[3]  # steps 1-3 precede the first publish
        # returned x is consistent with the monitored norm
        r = b - hier.levels[0].A @ res4.x
        assert float(jnp.linalg.norm(r)) / float(jnp.linalg.norm(b - hier.levels[0].A @ jnp.zeros_like(b))) <= 2e-8

    def test_comm_every_res_read(self, setup32):
        prob, hh, hier, b, params = setup32
        cfg = multadd_cfg()
        res = async_solve(
            hier, cfg,
            AsyncConfig(omega=0.6, comm_every=3, read_type="res"), b,
            key=jax.random.PRNGKey(0), tol=1e-8, max_cycles=500,
        )
        assert float(res.rel_resnorm) <= 1e-8


class TestSpsMinProb:
    def test_min_prob_derived_alpha(self, setup32):
        """-sps_min_prob > 0 derives each block's alpha from its neighbor
        degree so the worst-ranked block fires with exactly min_prob
        (reference: src/DMEM_Setup.cpp:1168-1170). The derived-alpha run
        converges and takes a different trajectory than the fixed-alpha
        run with the same key."""
        from amg_jax.solve.async_smooth import (
            AsyncSmoothConfig,
            async_smooth_solve,
            block_neighbor_mask,
        )
        from amg_jax.smooth import make_smoother_data
        from amg_jax.sparse.ell import ell_from_csr

        prob, hh, hier, b, params = setup32
        A = ell_from_csr(prob.A)
        sm = make_smoother_data(prob.A, SmootherType.L1_JACOBI, w=1.0)
        nbr = block_neighbor_mask(prob.A, 8)
        key = jax.random.PRNGKey(2)
        base = AsyncSmoothConfig(
            smoother=SmootherType.L1_JACOBI, num_blocks=8,
            method="southwell_exp", sps_alpha=0.5,
        )
        derived = AsyncSmoothConfig(
            smoother=SmootherType.L1_JACOBI, num_blocks=8,
            method="southwell_exp", sps_min_prob=0.5,
        )
        r1 = async_smooth_solve(A, sm, base, nbr, b, key=key, tol=1e-3,
                                max_cycles=5000)
        r2 = async_smooth_solve(A, sm, derived, nbr, b, key=key, tol=1e-3,
                                max_cycles=5000)
        assert float(r2.rel_resnorm) <= 1e-3
        assert int(r2.iters) != int(r1.iters) or not np.allclose(
            np.asarray(r1.block_updates), np.asarray(r2.block_updates)
        )


class TestSimGridWait:
    def test_wait_counter_firing_converges(self, setup32):
        """sim_grid_wait > 0 switches firing to the reference's wait-counter
        model (grid_wait_list drawn uniform [0, w], src/SEQ_AMG.cpp:260):
        the run converges and takes a different trajectory than the
        Bernoulli model with the same key."""
        prob, hh, hier, b, params = setup32
        cfg = multadd_cfg()
        key = jax.random.PRNGKey(3)
        base = AsyncConfig(omega=0.4, fire_prob=0.5)
        waitm = AsyncConfig(omega=0.4, sim_grid_wait=3)
        r1 = async_solve(hier, cfg, base, b, key=key, tol=1e-8,
                         max_cycles=600)
        r2 = async_solve(hier, cfg, waitm, b, key=key, tol=1e-8,
                         max_cycles=600)
        assert float(r2.rel_resnorm) <= 1e-8
        assert int(r2.iters) != int(r1.iters) or not np.allclose(
            np.asarray(r1.history[:10]), np.asarray(r2.history[:10])
        )

    def test_wait_counter_mean_period(self, setup32):
        """With sim_grid_wait = w the mean grid-wait between a level's
        applies matches the uniform-[0, w] redraw model (expected period
        1 + w/2 supersteps)."""
        prob, hh, hier, b, params = setup32
        cfg = multadd_cfg()
        acfg = AsyncConfig(omega=0.4, sim_grid_wait=4)
        res = async_solve(hier, cfg, acfg, b, key=jax.random.PRNGKey(0),
                          tol=0.0, max_cycles=300)
        counts = np.asarray(res.grid_wait.count, dtype=float)
        # every level fires roughly every 3 supersteps (period 1 + 4/2)
        period = 300.0 / counts
        assert np.all(period > 2.0) and np.all(period < 4.5)


class TestAsyncAsymmetricAccel:
    """Round-5: the reference's asymmetric async Chebyshev/Richardson
    (DMEM_ChebyUpdate, src/DMEM_Misc.cpp:612-666) replacing the round-4
    scalar-omega approximation."""

    def _coeffs(self, hier, cfg):
        from amg_jax.solve.driver import cheby_setup

        return cheby_setup(hier, cfg, num_iters=20)

    def test_sync_limit_equals_sync_cheby(self, setup32):
        """With fire=1 and zero staleness the asymmetric recurrence must
        reproduce the synchronous Chebyshev solve trajectory exactly (the
        reference's async path degenerates to its sync path when no
        message is ever late)."""
        from amg_jax.solve import solve

        prob, hh, hier, b, params = setup32
        cfg = multadd_cfg()
        coeffs = self._coeffs(hier, cfg)
        res_sync = solve(
            hier, cfg, b, tol=1e-8, max_cycles=200, accel="cheby",
            cheby_coeffs=coeffs,
        )
        acfg = AsyncConfig(
            sim_read_delay=0, fire_prob=1.01, accel="cheby",
            cheby_mu=coeffs.mu, cheby_delta=coeffs.delta,
        )
        res_async = async_solve(hier, cfg, acfg, b, tol=1e-8, max_cycles=200)
        assert int(res_sync.iters) == int(res_async.iters)
        h1 = np.asarray(res_sync.history)
        h2 = np.asarray(res_async.history)
        m = ~np.isnan(h1)
        # identical algebra, different floating summation order (the sync
        # path folds the momentum through cheby_update's d, the async path
        # through total_c): trajectories agree to accumulated roundoff
        np.testing.assert_allclose(h1[m], h2[m], rtol=1e-6)

    def test_accel_beats_scalar_omega(self, setup32):
        """The asymmetric accel converges measurably faster than the
        round-4 scalar under-relaxation at the same staleness (SEMI
        per-level staleness — the DMEM comm model)."""
        prob, hh, hier, b, params = setup32
        cfg = multadd_cfg()
        coeffs = self._coeffs(hier, cfg)
        omega = 0.5 * 2.0 / (coeffs.alpha + coeffs.beta)
        key = jax.random.PRNGKey(0)
        base = dict(async_type="semi", sim_read_delay=2, fire_prob=0.5)
        r_scalar = async_solve(
            hier, cfg, AsyncConfig(omega=omega, **base), b, key=key,
            tol=1e-8, max_cycles=600,
        )
        r_accel = async_solve(
            hier, cfg,
            AsyncConfig(
                accel="cheby", cheby_mu=coeffs.mu,
                cheby_delta=coeffs.delta * 0.6, **base,
            ),
            b, key=key, tol=1e-8, max_cycles=600,
        )
        assert float(r_accel.rel_resnorm) <= 1e-8
        assert int(r_accel.iters) < int(r_scalar.iters)

    def test_richardson_accel_converges(self, setup32):
        prob, hh, hier, b, params = setup32
        cfg = multadd_cfg()
        coeffs = self._coeffs(hier, cfg)
        acfg = AsyncConfig(
            async_type="semi", sim_read_delay=2, fire_prob=0.5,
            accel="richardson", cheby_mu=coeffs.mu,
            cheby_delta=coeffs.delta * 0.6,
        )
        res = async_solve(hier, cfg, acfg, b, tol=1e-8, max_cycles=600)
        assert float(res.rel_resnorm) <= 1e-8
        r = np.asarray(b) - prob.A @ np.asarray(res.x)
        assert np.linalg.norm(r) / np.linalg.norm(np.asarray(b)) < 1.1e-8
