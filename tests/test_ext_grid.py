"""Grid-mapped extended system: level blocks sharded onto device groups.

The flattened multilevel system AA U = C^T r with blocks padded to shard
boundaries (pad_extended_layout) is the realization of the reference's
AssignProcs split applied to the PAR_BPX extended system (reference:
src/DMEM_Setup.cpp:1638-1759, src/SMEM_ExtendedSystem.cpp:9-907)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from amg_jax.parallel import make_row_mesh
from amg_jax.parallel.dist import pad_extended_layout
from amg_jax.parallel.partition import (
    assign_levels_to_devices,
    compute_level_work,
)
from amg_jax.problems import laplacian_2d_5pt
from amg_jax.setup.hierarchy import HierarchyParams, build_hierarchy
from amg_jax.smooth import SmootherType
from amg_jax.solve.accel import estimate_cycle_eigs
from amg_jax.solve.extended import (
    build_extended_system,
    build_sharded_extended_system,
    ext_matvec,
    ext_solve,
)


class TestPadExtendedLayout:
    def test_blocks_on_assigned_shards(self):
        sizes = [1000, 260, 70, 20]
        work = np.array([0.55, 0.25, 0.12, 0.08])
        D = 8
        assignment = assign_levels_to_devices(work, D)
        p_off, p_total, row_owner = pad_extended_layout(sizes, assignment, D)
        assert p_total % D == 0
        S = p_total // D
        for k, (s, e) in enumerate(assignment):
            rows = np.flatnonzero(row_owner == k)
            assert rows.size == sizes[k]
            # every data row of level k lives in its assigned device range
            devs = rows // S
            assert devs.min() >= s and devs.max() < max(e, s + 1), (
                k, assignment, S,
            )

    def test_fewer_devices_than_levels_packs(self):
        sizes = [400, 120, 40, 12, 6]
        work = np.array([0.5, 0.25, 0.13, 0.07, 0.05])
        D = 2
        assignment = assign_levels_to_devices(work, D)
        p_off, p_total, row_owner = pad_extended_layout(sizes, assignment, D)
        S = p_total // D
        for k, (s, e) in enumerate(assignment):
            rows = np.flatnonzero(row_owner == k)
            assert (rows // S == s).all()
        # offsets monotone, cover all data rows
        assert (np.asarray(row_owner) >= 0).sum() == sum(sizes)


@pytest.fixture(scope="module")
def ext_setup():
    prob = laplacian_2d_5pt(24)
    params = HierarchyParams(
        smoother=SmootherType.L1_JACOBI, keep_stencil_fine=False
    )
    hh, hier = build_hierarchy(prob.A, params)
    b = jnp.asarray(np.random.default_rng(0).random(prob.n))
    return prob, hh, hier, params, b


class TestShardedExtendedSystem:
    def test_matvec_matches_unsharded(self, ext_setup):
        """Padded+sharded AA applies identically to the unpadded explicit
        system on the embedded block rows."""
        prob, hh, hier, params, b = ext_setup
        mesh = make_row_mesh(8)
        ext_s = build_sharded_extended_system(hh, params, mesh)
        ext_u = build_extended_system(hh, params, explicit=True)
        # embed a random unpadded U into the padded layout
        rng = np.random.default_rng(3)
        U_u = rng.random(ext_u.offsets[-1])
        U_s = np.zeros(ext_s.offsets[-1])
        L = hh.num_levels
        sizes = [lv.A.n_rows for lv in hh.levels]
        for k in range(L):
            U_s[ext_s.offsets[k] : ext_s.offsets[k] + sizes[k]] = U_u[
                ext_u.offsets[k] : ext_u.offsets[k] + sizes[k]
            ]
        A0 = hier.levels[0].A
        y_u = np.asarray(ext_matvec(ext_u, A0, jnp.asarray(U_u)))
        y_s = np.asarray(ext_matvec(ext_s, A0, jnp.asarray(U_s)))
        for k in range(L):
            np.testing.assert_allclose(
                y_s[ext_s.offsets[k] : ext_s.offsets[k] + sizes[k]],
                y_u[ext_u.offsets[k] : ext_u.offsets[k] + sizes[k]],
                rtol=1e-12, atol=1e-12,
            )
        # padding rows: unit diagonal only → y = U there (identity)
        owner = np.full(ext_s.offsets[-1], -1)
        for k in range(L):
            owner[ext_s.offsets[k] : ext_s.offsets[k] + sizes[k]] = k
        pad = owner < 0
        np.testing.assert_allclose(y_s[pad], U_s[pad], atol=1e-15)

    def test_sharded_solve_converges(self, ext_setup):
        prob, hh, hier, params, b = ext_setup
        mesh = make_row_mesh(8)
        ext = build_sharded_extended_system(hh, params, mesh)
        A0 = hier.levels[0].A
        coeffs = estimate_cycle_eigs(
            lambda u: ext.inv_wdiag * ext_matvec(ext, A0, u),
            ext.offsets[-1], b.dtype, range_start=True,
        )
        res = ext_solve(
            hier, ext, b, tol=1e-8, max_cycles=300, cheby_coeffs=coeffs
        )
        assert float(res.rel_resnorm) <= 1e-8
        r = np.asarray(b) - prob.A @ np.asarray(res.x)
        assert np.linalg.norm(r) / np.linalg.norm(np.asarray(b)) <= 2e-8
        # AA really is row-sharded over the mesh
        sh = ext.AA.vals.sharding
        assert not sh.is_fully_replicated

    def test_sharded_async_solve(self, ext_setup):
        """Async firing + staleness on the sharded extended system (the
        device-group realization of the async PAR_BPX solve)."""
        prob, hh, hier, params, b = ext_setup
        mesh = make_row_mesh(8)
        ext = build_sharded_extended_system(hh, params, mesh)
        A0 = hier.levels[0].A
        coeffs = estimate_cycle_eigs(
            lambda u: ext.inv_wdiag * ext_matvec(ext, A0, u),
            ext.offsets[-1], b.dtype, range_start=True,
        )
        res = ext_solve(
            hier, ext, b, tol=1e-8, max_cycles=800, cheby_coeffs=coeffs,
            async_fire_prob=0.7, sim_read_delay=2,
            key=jax.random.PRNGKey(5),
        )
        assert float(res.rel_resnorm) <= 1e-8


def test_runner_ext_grid_parallel():
    from amg_jax.utils.config import SolverOptions
    from amg_jax.utils.runner import run_experiment

    st = run_experiment(SolverOptions(
        problem="5pt", n=24, solver="explicit_ext_bpx", num_devices=8,
    ))
    assert st.rel_resnorm <= 1e-8
