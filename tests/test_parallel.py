"""Multi-device tests on the virtual 8-device CPU mesh (SURVEY §4).

Includes the constant-vector correctness probe pattern of the reference's
DMEM_TestCorrect_LocalRes (reference: src/DMEM_Test.cpp:7-58): exercise the
correction/communication path with a constant vector and check exact counts.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from amg_jax.parallel import (
    assign_levels_to_devices,
    compute_level_work,
    make_row_mesh,
)
from amg_jax.parallel.dist import (
    build_dist_hierarchy,
    pad_vector,
    unpad_vector,
)
from amg_jax.problems import laplacian_2d_5pt
from amg_jax.setup.hierarchy import (
    HierarchyParams,
    build_hierarchy,
    build_host_hierarchy,
)
from amg_jax.smooth import SmootherType
from amg_jax.solve import CycleConfig, CycleType, solve
from amg_jax.solve.cycles import additive_correction, sync_additive_cycle


@pytest.fixture(scope="module")
def dist_setup():
    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    prob = laplacian_2d_5pt(32)
    params = HierarchyParams(
        smoother=SmootherType.L1_JACOBI, keep_stencil_fine=False
    )
    hh, hier = build_hierarchy(prob.A, params)
    mesh = make_row_mesh(8)
    hier_s, pad_info = build_dist_hierarchy(hh, params, mesh)
    b = jnp.asarray(np.random.default_rng(0).random(prob.n))
    return prob, hh, hier, hier_s, pad_info, mesh, b


class TestWorkModel:
    def test_work_fractions(self):
        prob = laplacian_2d_5pt(24)
        hh = build_host_hierarchy(prob.A, HierarchyParams())
        w = compute_level_work(hh)
        assert w.shape == (hh.num_levels,)
        assert abs(w.sum() - 1.0) < 1e-12
        assert (w > 0).all()
        # in async mode each level pays for its full restrict/prolong chain,
        # so work need not be monotone — but the coarsest level must be the
        # cheapest in rows-only terms and no level may dominate completely
        assert w.max() < 0.9

    def test_assignment_more_devices_than_levels(self):
        w = np.array([0.6, 0.25, 0.1, 0.05])
        a = assign_levels_to_devices(w, 8)
        # contiguous, complete cover, >= 1 device each
        assert a[0][0] == 0 and a[-1][1] == 8
        for k in range(1, len(a)):
            assert a[k][0] == a[k - 1][1]
        sizes = [hi - lo for lo, hi in a]
        assert min(sizes) >= 1
        assert sizes[0] == max(sizes)

    def test_assignment_fewer_devices_than_levels(self):
        w = np.array([0.5, 0.25, 0.15, 0.06, 0.04])
        a = assign_levels_to_devices(w, 2)
        devs = [lo for lo, hi in a]
        assert devs == sorted(devs)  # monotone level→device
        assert devs[0] == 0 and devs[-1] == 1


class TestDistSolve:
    def test_mult_matches_single_device(self, dist_setup):
        prob, hh, hier, hier_s, pad_info, mesh, b = dist_setup
        cfg = CycleConfig(cycle=CycleType.MULT, smoother=SmootherType.L1_JACOBI)
        res1 = solve(hier, cfg, b, tol=1e-8, max_cycles=60)
        b_s = pad_vector(b, pad_info, mesh)
        res8 = solve(hier_s, cfg, b_s, tol=1e-8, max_cycles=60)
        assert int(res1.iters) == int(res8.iters)
        x8 = unpad_vector(res8.x, pad_info)
        np.testing.assert_allclose(
            np.asarray(res1.x), np.asarray(x8), atol=1e-10
        )

    def test_output_sharded(self, dist_setup):
        prob, hh, hier, hier_s, pad_info, mesh, b = dist_setup
        cfg = CycleConfig(cycle=CycleType.MULT, smoother=SmootherType.L1_JACOBI)
        b_s = pad_vector(b, pad_info, mesh)
        res = solve(hier_s, cfg, b_s, tol=1e-6, max_cycles=20)
        spec = res.x.sharding.spec
        assert tuple(spec) == ("rows",)

    def test_multadd_distributed(self, dist_setup):
        prob, hh, hier, hier_s, pad_info, mesh, b = dist_setup
        cfg = CycleConfig(
            cycle=CycleType.MULTADD,
            smoother=SmootherType.L1_JACOBI,
            use_smoothed_transfers=True,
        )
        b_s = pad_vector(b, pad_info, mesh)
        res = solve(hier_s, cfg, b_s, tol=1e-8, max_cycles=100)
        assert float(res.rel_resnorm) <= 1e-8
        x = unpad_vector(res.x, pad_info)
        r = np.asarray(b) - prob.A @ np.asarray(x)
        assert np.linalg.norm(r) / np.linalg.norm(np.asarray(b)) < 1.1e-8


class TestCorrectionChannels:
    def test_constant_vector_probe(self, dist_setup):
        """The reference's comm-correctness probe: with P/R replaced by the
        identity action on a constant vector, each additive cycle must add
        exactly num_levels * alpha to every entry. Here: corrections of the
        constant residual through restrict/prolong chains must reproduce the
        same entry-counts invariant on the padded distributed hierarchy —
        every interior entry receives all levels' contributions
        (reference: DMEM_TestCorrect_LocalRes, src/DMEM_Test.cpp:7-58)."""
        prob, hh, hier, hier_s, pad_info, mesh, b = dist_setup
        cfg = CycleConfig(cycle=CycleType.BPX, smoother=SmootherType.L1_JACOBI)
        r = pad_vector(jnp.ones(prob.n), pad_info, mesh)
        total_s = jnp.zeros_like(r)
        for k in range(hier_s.num_levels):
            total_s = total_s + additive_correction(hier_s, cfg, r, k)
        # same on the single-device hierarchy: results must agree exactly
        total_1 = jnp.zeros(prob.n)
        for k in range(hier.num_levels):
            total_1 = total_1 + additive_correction(hier, cfg, jnp.ones(prob.n), k)
        np.testing.assert_allclose(
            np.asarray(unpad_vector(total_s, pad_info)),
            np.asarray(total_1),
            atol=1e-12,
        )
        # padding rows (if any) receive nothing
        if pad_info[1] > prob.n:
            assert float(jnp.max(jnp.abs(total_s[prob.n :]))) == 0.0


class TestGraftEntry:
    def test_dryrun_multichip(self):
        import __graft_entry__ as ge

        ge.dryrun_multichip(8)

    def test_entry_compiles(self):
        import __graft_entry__ as ge

        fn, args = ge.entry()
        out = jax.jit(fn)(*args)
        assert out.shape == args[0].shape


class TestDistAsync:
    def test_async_additive_on_sharded_hierarchy(self, dist_setup):
        """The bounded-staleness async additive solve (config 5 semantics)
        runs unchanged on the row-sharded hierarchy: corrections accumulate
        through XLA collectives, staleness/firing per level group."""
        from amg_jax.solve.async_sim import AsyncConfig, async_solve

        prob, hh, hier, hier_s, pad_info, mesh, b = dist_setup
        cfg = CycleConfig(
            cycle=CycleType.MULTADD,
            smoother=SmootherType.L1_JACOBI,
            use_smoothed_transfers=True,
        )
        acfg = AsyncConfig(read_type="sol", async_type="semi", sim_read_delay=4)
        b_s = pad_vector(b, pad_info, mesh)
        res = async_solve(hier_s, cfg, acfg, b_s, tol=1e-8, max_cycles=500)
        assert float(res.rel_resnorm) <= 1e-8
        assert tuple(res.x.sharding.spec) == ("rows",)
        x = unpad_vector(res.x, pad_info)
        r = np.asarray(b) - prob.A @ np.asarray(x)
        assert np.linalg.norm(r) / np.linalg.norm(np.asarray(b)) < 1.1e-8
        assert min(res.grid_wait.summary()["num_correct"]) > 0


class TestDistStructured:
    def test_sharded_structured_solve_matches(self):
        """GSPMD-sharded structured hierarchy: the pad+shift stencil matvec
        gets compiler-inserted halo exchanges; solve is iteration-identical
        to single-device."""
        from amg_jax.parallel.dist import shard_structured_hierarchy, shard_vector
        from amg_jax.problems import laplacian_3d_27pt
        from amg_jax.setup.structured import build_structured_hierarchy

        prob = laplacian_3d_27pt(32)
        hh, hier = build_structured_hierarchy(
            prob.stencil, smoother=SmootherType.L1_JACOBI
        )
        mesh = make_row_mesh(8)
        hier_s = shard_structured_hierarchy(hier, mesh)
        b = jnp.asarray(np.random.default_rng(0).random(prob.n))
        b_s = shard_vector(b, mesh)
        cfg = CycleConfig(cycle=CycleType.MULT, smoother=SmootherType.L1_JACOBI)
        res1 = solve(hier, cfg, b, tol=1e-8, max_cycles=40)
        res8 = solve(hier_s, cfg, b_s, tol=1e-8, max_cycles=40)
        assert int(res1.iters) == int(res8.iters)
        np.testing.assert_allclose(
            np.asarray(res1.x), np.asarray(res8.x), atol=1e-12
        )
        assert tuple(res8.x.sharding.spec) == ("rows",)
