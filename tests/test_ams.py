"""Auxiliary-space (AMS/Hiptmair) Maxwell solver: exact-sequence structure,
preconditioner SPD-ness, and the curl-curl solve that plain AMG stalls on
(BASELINE config 5's problem, reference src/Maxwell.cpp:50-208)."""

import numpy as np
import jax
import jax.numpy as jnp

from amg_jax.problems.maxwell import maxwell_curlcurl
from amg_jax.setup.hierarchy import HierarchyParams, _format_converter
from amg_jax.solve.ams import ams_precondition, build_ams, solve_ams_pcg


def test_exact_sequence_gradient():
    """A @ G = sigma*vol*G: the curl term annihilates gradients."""
    n, sigma = 6, 2.0
    p = maxwell_curlcurl(n=n, sigma=sigma)
    As = p.A.to_scipy()
    Gs = p.aux["G"].to_scipy()
    vol = (1.0 / n) ** 3
    assert abs(As @ Gs - sigma * vol * Gs).max() < 1e-12


def test_gradient_maps_interior_potentials():
    p = maxwell_curlcurl(n=5)
    G = p.aux["G"]
    assert G.shape[0] == p.A.n_rows
    assert G.shape[1] == (5 - 1) ** 3  # interior nodes only


def test_ams_preconditioner_spd():
    p = maxwell_curlcurl(n=5)
    ams, cfg = build_ams(p.A, p.aux["G"])
    n = p.A.n_rows
    rng = np.random.default_rng(0)
    V = rng.standard_normal((n, 6))
    MV = np.stack(
        [np.asarray(ams_precondition(ams, cfg, jnp.asarray(v))) for v in V.T],
        axis=1,
    )
    S = V.T @ MV
    np.testing.assert_allclose(S, S.T, atol=1e-10)
    assert (np.linalg.eigvalsh((S + S.T) / 2) > 0).all()


def test_maxwell_ams_solve():
    p = maxwell_curlcurl(n=10, sigma=1.0)
    ams, cfg = build_ams(p.A, p.aux["G"])
    conv = _format_converter(HierarchyParams())
    A_dev = conv(p.A, jnp.float64)
    res = solve_ams_pcg(A_dev, ams, cfg, jnp.asarray(p.rhs), tol=1e-8)
    assert float(res.rel_resnorm) < 1e-8
    assert int(res.iters) < 60  # plain AMG-PCG: >200 and stalls


def test_maxwell_ams_small_sigma():
    """Robustness as sigma -> 0 (the regime where the gradient kernel
    dominates and nodal AMG fails completely)."""
    p = maxwell_curlcurl(n=8, sigma=1e-3)
    ams, cfg = build_ams(p.A, p.aux["G"])
    conv = _format_converter(HierarchyParams())
    A_dev = conv(p.A, jnp.float64)
    res = solve_ams_pcg(A_dev, ams, cfg, jnp.asarray(p.rhs), tol=1e-8)
    assert float(res.rel_resnorm) < 1e-8
    assert int(res.iters) < 60


class TestShardedAMS:
    """Round-4 (BASELINE config 5 as specified): Maxwell DISTRIBUTED —
    edge operator, discrete gradient, and nodal hierarchy all row-sharded
    with halo-segment comm (reference: src/Maxwell.cpp:50-208 +
    src/DMEM_Comm.cpp halo engine). Multi-PROCESS execution of the same
    program is covered by tests/test_multiprocess.py."""

    def _setup(self, n=10, sigma=1.0, D=8):
        import jax

        from amg_jax.parallel import make_row_mesh
        from amg_jax.solve.ams import build_sharded_ams, solve_sharded_ams_pcg

        p = maxwell_curlcurl(n=n, sigma=sigma)
        mesh = make_row_mesh(D)
        A_halo, ams, cfg, pad_e, pad_n = build_sharded_ams(
            p.A, p.aux["G"], mesh
        )
        return p, mesh, A_halo, ams, cfg, pad_e

    def test_sharded_matches_single_device(self):
        from amg_jax.solve.ams import solve_sharded_ams_pcg

        p, mesh, A_halo, ams, cfg, pad_e = self._setup()
        res8 = solve_sharded_ams_pcg(
            A_halo, ams, cfg, jnp.asarray(p.rhs), mesh, pad_e, tol=1e-8
        )
        assert float(res8.rel_resnorm) < 1e-8
        # single-device reference
        ams1, cfg1 = build_ams(p.A, p.aux["G"])
        conv = _format_converter(HierarchyParams())
        res1 = solve_ams_pcg(
            conv(p.A, jnp.float64), ams1, cfg1, jnp.asarray(p.rhs), tol=1e-8
        )
        # same Krylov trajectory up to halo-layout roundoff: iteration
        # counts within 2 and solutions agree through the operator
        assert abs(int(res8.iters) - int(res1.iters)) <= 2
        r = np.asarray(p.rhs) - p.A.to_scipy() @ np.asarray(res8.x)
        assert np.linalg.norm(r) / np.linalg.norm(np.asarray(p.rhs)) < 2e-8

    def test_no_allgather_in_sharded_ams(self):
        """The full jitted AMS-PCG program ships only boundary segments:
        no all-gather in the compiled HLO (the coarse dense solve is the
        replicated exception, as in the halo V-cycle)."""
        import jax

        from amg_jax.parallel.dist import pad_vector
        from amg_jax.solve.ams import ams_precondition
        from amg_jax.solve.krylov import pcg

        p, mesh, A_halo, ams, cfg, pad_e = self._setup()
        b_pad = pad_vector(jnp.asarray(p.rhs), pad_e, mesh)
        fn = jax.jit(
            lambda A_, ams_, b_: pcg(
                lambda v: A_ @ v,
                lambda r: ams_precondition(ams_, cfg, r),
                b_,
                jnp.zeros_like(b_),
                tol=1e-8,
                max_iters=40,
            )
        )
        txt = fn.lower(A_halo, ams, b_pad).compile().as_text()
        assert "collective-permute" in txt or "all-to-all" in txt
        # the coarse-grid dense solve legitimately gathers its (tiny)
        # coarse vector; no FINE-size all-gather may appear
        import re

        for m in re.finditer(r"all-gather[^=]*=\s*\S+\s+f64\[(\d+)", txt):
            assert int(m.group(1)) <= 1024, (
                f"fine-size all-gather in AMS HLO: {m.group(0)}"
            )

    def test_additive_node_cycle(self):
        """The node correction runs through the ADDITIVE cycle family too
        (cfg.cycle=multadd) — the async-additive model of the reference's
        config-5 path (src/DMEM_Add.cpp:20-178) driving the Maxwell
        preconditioner."""
        from amg_jax.solve import CycleConfig, CycleType
        from amg_jax.smooth import SmootherType
        from amg_jax.solve.ams import solve_sharded_ams_pcg

        p, mesh, A_halo, ams, cfg, pad_e = self._setup()
        cfg_add = CycleConfig(
            cycle=CycleType.MULTADD, smoother=SmootherType.L1_JACOBI,
        )
        res = solve_sharded_ams_pcg(
            A_halo, ams, cfg_add, jnp.asarray(p.rhs), mesh, pad_e,
            tol=1e-8, max_iters=120,
        )
        assert float(res.rel_resnorm) < 1e-8
        r = np.asarray(p.rhs) - p.A.to_scipy() @ np.asarray(res.x)
        assert np.linalg.norm(r) / np.linalg.norm(np.asarray(p.rhs)) < 2e-8


class TestAsyncAdditiveAMS:
    """The literal config-5 composition: async additive auxiliary-space
    Maxwell (edge-smoother + node-level + Pi-level groups firing
    independently against bounded-staleness iterates; reference
    src/Maxwell.cpp + src/DMEM_Add.cpp). Round-5: the full Hiptmair-Xu
    decomposition (Pi space) + auto-omega takes the contraction from
    0.9885/cycle (round-4 two-space, tested only to 1e-4) to ~0.93 —
    tested to 1e-6 with a rate assertion."""

    def _setup(self, with_pi=True):
        p = maxwell_curlcurl(n=8, sigma=1.0)
        ams, _ = build_ams(
            p.A, p.aux["G"], Pi=p.aux["Pi"] if with_pi else None
        )
        A = _format_converter(HierarchyParams())(p.A, jnp.float64)
        return p, ams, A, jnp.asarray(p.rhs)

    def test_synchronous_limit_converges(self):
        from amg_jax.solve.ams import ams_async_additive_solve

        p, ams, A, b = self._setup()
        res = ams_async_additive_solve(
            A, ams, b, sim_read_delay=0, tol=1e-6, max_cycles=800,
        )
        assert float(res.rel_resnorm) <= 1e-6
        r = np.asarray(b) - p.A.to_scipy() @ np.asarray(res.x)
        assert np.linalg.norm(r) / np.linalg.norm(np.asarray(b)) <= 2e-6

    def test_bounded_staleness_converges_1e6(self):
        """Async reads up to 2 supersteps stale, full-AMS groups,
        auto-omega: contraction well below the round-4 0.97 — asserted
        <= 0.95/cycle asymptotically — and tolerance 1e-6 reached."""
        from amg_jax.solve.ams import ams_async_additive_solve

        p, ams, A, b = self._setup()
        res = ams_async_additive_solve(
            A, ams, b, sim_read_delay=2, tol=1e-6, max_cycles=600,
        )
        assert float(res.rel_resnorm) <= 1e-6
        h = np.asarray(res.history)
        h = h[~np.isnan(h)]
        rate = (h[-1] / h[10]) ** (1.0 / (len(h) - 11))
        assert rate <= 0.95
        r = np.asarray(b) - p.A.to_scipy() @ np.asarray(res.x)
        assert np.linalg.norm(r) / np.linalg.norm(np.asarray(b)) <= 2e-6

    def test_pi_space_required_for_rate(self):
        """Without the Pi groups the additive operator's smallest
        eigenvalue collapses (kappa ~46 vs ~2 ideal) and the async solve
        contracts at >= 0.97 — the round-4 behavior, kept as a negative
        control."""
        from amg_jax.solve.ams import ams_async_additive_solve

        p, ams, A, b = self._setup(with_pi=False)
        res = ams_async_additive_solve(
            A, ams, b, sim_read_delay=2, tol=1e-6, max_cycles=200,
        )
        h = np.asarray(res.history)
        h = h[~np.isnan(h)]
        rate = (h[-1] / h[10]) ** (1.0 / (len(h) - 11))
        assert rate >= 0.95  # structurally slow without Pi


class TestPiInterpolation:
    """Nedelec nodal interpolation Pi (the second AMS auxiliary space,
    problems/maxwell.py aux['Pi']; hypre AMS's Pi operator analog)."""

    def test_pi_reproduces_constant_fields(self):
        """Pi maps a constant vector field to its exact edge dofs: the
        d-aligned unit field gives tangential value 1 on every d-edge and
        0 on others (the partition-of-unity property the HX decomposition
        needs). Checked away from the PEC boundary where the constrained
        nodal dofs truncate the stencil."""
        p = maxwell_curlcurl(n=6)
        Pi = p.aux["Pi"].to_scipy().tocsr()
        G = p.aux["G"].to_scipy().tocsr()
        n_e = Pi.shape[0]
        # interior edges (full 2-node support): both endpoint dofs kept ->
        # row sum of Pi over the x-block is 1 for x-edges with both
        # endpoints interior; use rows with exactly 2 nonzeros
        nnz_per_row = np.diff(Pi.indptr)
        full = nnz_per_row == 2
        assert full.sum() > 0
        rowsum = np.asarray(Pi.sum(axis=1)).ravel()
        np.testing.assert_allclose(rowsum[full], 1.0)

    def test_pi_improves_pcg(self):
        """Full HX decomposition must not be slower than the two-space
        variant under PCG (measured 26 vs 29 at n=8)."""
        p = maxwell_curlcurl(n=8)
        A = _format_converter(HierarchyParams())(p.A, jnp.float64)
        b = jnp.asarray(p.rhs)
        ams2, cfg2 = build_ams(p.A, p.aux["G"])
        ams3, cfg3 = build_ams(p.A, p.aux["G"], Pi=p.aux["Pi"])
        r2 = solve_ams_pcg(A, ams2, cfg2, b, tol=1e-8)
        r3 = solve_ams_pcg(A, ams3, cfg3, b, tol=1e-8)
        assert float(r3.rel_resnorm) <= 1e-8
        assert int(r3.iters) <= int(r2.iters)


class TestAMSGridParallel:
    """Round-5 (verdict item 2): the config-5 composition ASSEMBLED —
    async additive Maxwell through the grid-parallel engine over the
    device mesh, owned storage, ACCUMULATE psum exchange (reference:
    src/Maxwell.cpp fed into src/DMEM_Add.cpp over DMEM_Comm.cpp)."""

    def _setup(self):
        p = maxwell_curlcurl(n=8, sigma=1.0)
        ams, _ = build_ams(p.A, p.aux["G"], Pi=p.aux["Pi"])
        A = _format_converter(HierarchyParams())(p.A, jnp.float64)
        b = jnp.asarray(p.rhs / np.linalg.norm(p.rhs))
        return p, ams, A, b

    def test_matches_single_program_and_converges_1e6(self):
        from amg_jax.parallel import make_row_mesh
        from amg_jax.solve.ams import (
            ams_async_additive_solve,
            ams_grid_parallel_solve,
        )

        p, ams, A, b = self._setup()
        key = jax.random.PRNGKey(0)
        ref = ams_async_additive_solve(
            A, ams, b, key=key, tol=1e-6, max_cycles=600
        )
        mesh = make_row_mesh(8)
        res, owned = ams_grid_parallel_solve(
            A, ams, mesh, b, key=key, tol=1e-6, max_cycles=600
        )
        assert float(res.rel_resnorm) <= 1e-6
        assert int(res.iters) == int(ref.iters)
        np.testing.assert_allclose(
            np.asarray(res.x), np.asarray(ref.x), atol=1e-10
        )
        r = np.asarray(b) - p.A.to_scipy() @ np.asarray(res.x)
        assert np.linalg.norm(r) / np.linalg.norm(np.asarray(b)) <= 2e-6

    def test_owned_bytes_track_assignment(self):
        """Per-device operator bytes are proportional to the groups the
        device owns, not the full AMS ensemble (redistributed gridk
        ownership, src/DMEM_Setup.cpp:216-334)."""
        from amg_jax.parallel.grid import pack_device_pools
        from amg_jax.solve.ams import _ams_owned_rows, plan_ams_groups
        from amg_jax.solve.cycles import CycleConfig, CycleType
        from amg_jax.smooth import SmootherType

        p, ams, A, b = self._setup()
        cfg_add = CycleConfig(
            cycle=CycleType.MULTADD, smoother=SmootherType.L1_JACOBI,
            use_smoothed_transfers=True,
        )
        groups_of, _ = plan_ams_groups(ams, 8)
        _, _, owned = pack_device_pools(
            _ams_owned_rows(ams, groups_of, cfg_add)
        )
        total = sum(owned)
        # the edge-only device must be far lighter than a full replica
        edge_dev = [d for d, gs in enumerate(groups_of) if gs == (0,)]
        assert edge_dev, "work model should isolate the edge group"
        assert owned[edge_dev[0]] < 0.02 * total
        # no device carries more than ~60% of the ensemble
        assert max(owned) < 0.6 * total


class TestShardedFullAMS:
    """Round-5: the sharded AMS with BOTH auxiliary spaces (Pi sharded
    exactly like G — HaloELL boundary segments only)."""

    def test_sharded_pi_matches_single_device(self):
        from amg_jax.parallel import make_row_mesh
        from amg_jax.solve.ams import build_sharded_ams, solve_sharded_ams_pcg

        p = maxwell_curlcurl(n=10)
        mesh = make_row_mesh(8)
        A_halo, ams, cfg, pad_e, pad_n = build_sharded_ams(
            p.A, p.aux["G"], mesh, Pi=p.aux["Pi"]
        )
        assert ams.pi_hier is not None
        res8 = solve_sharded_ams_pcg(
            A_halo, ams, cfg, jnp.asarray(p.rhs), mesh, pad_e, tol=1e-8
        )
        assert float(res8.rel_resnorm) < 1e-8
        ams1, cfg1 = build_ams(p.A, p.aux["G"], Pi=p.aux["Pi"])
        conv = _format_converter(HierarchyParams())
        res1 = solve_ams_pcg(
            conv(p.A, jnp.float64), ams1, cfg1, jnp.asarray(p.rhs), tol=1e-8
        )
        assert abs(int(res8.iters) - int(res1.iters)) <= 2
        r = np.asarray(p.rhs) - p.A.to_scipy() @ np.asarray(res8.x)
        assert np.linalg.norm(r) / np.linalg.norm(np.asarray(p.rhs)) < 2e-8


def test_grid_parallel_empty_device_branch():
    """Round-5 bug fix: a device whose group list is EMPTY must still
    trace a varying-typed branch output — at n>=24 the work model leaves
    devices group-less and lax.switch rejected the replicated/varying
    branch mismatch ('varying manual axes do not match'). Reproduced
    here cheaply by passing an explicit assignment with an empty device."""
    from amg_jax.parallel import make_row_mesh
    from amg_jax.problems.maxwell import maxwell_curlcurl
    from amg_jax.setup.hierarchy import HierarchyParams, _format_converter
    from amg_jax.solve.ams import build_ams, ams_grid_parallel_solve

    p = maxwell_curlcurl(n=8, sigma=1.0)
    ams, _ = build_ams(p.A, p.aux["G"], Pi=p.aux["Pi"])
    A = _format_converter(HierarchyParams())(p.A, jnp.float64)
    b = jnp.asarray(p.rhs / np.linalg.norm(p.rhs))
    mesh = make_row_mesh(8)
    from amg_jax.solve.ams import plan_ams_groups

    groups_of, gscale = plan_ams_groups(ams, 8)
    # squeeze every group onto the first 7 devices; device 7 owns NOTHING
    packed = [list(gs) for gs in groups_of]
    if packed[7]:
        packed[6] = packed[6] + packed[7]
        packed[7] = []
    res, owned = ams_grid_parallel_solve(
        A, ams, mesh, b, tol=1e-5, max_cycles=600,
        groups_of=tuple(tuple(g) for g in packed), group_scale=gscale,
    )
    assert float(res.rel_resnorm) <= 1e-5


def test_grid_parallel_empty_level_device():
    """Same varying-axes hazard in the grid-parallel LEVEL engine
    (parallel/grid.py): a device owning no levels must not break the
    switch."""
    from amg_jax.parallel import make_row_mesh
    from amg_jax.parallel.grid import grid_parallel_solve, plan_grid_levels
    from amg_jax.problems import laplacian_2d_5pt
    from amg_jax.setup.hierarchy import (
        HierarchyParams, build_host_hierarchy, device_hierarchy,
    )
    from amg_jax.smooth import SmootherType
    from amg_jax.solve import CycleConfig, CycleType
    from amg_jax.solve.async_sim import AsyncConfig

    prob = laplacian_2d_5pt(16)
    params = HierarchyParams(
        smoother=SmootherType.L1_JACOBI, keep_stencil_fine=False
    )
    hh = build_host_hierarchy(prob.A, params)
    hier = device_hierarchy(hh, params)
    mesh = make_row_mesh(8)
    _, levels_of, lscale = plan_grid_levels(hh, 8)
    packed = [list(ls) for ls in levels_of]
    if packed[7]:
        packed[6] = packed[6] + packed[7]
        packed[7] = []
    cfg = CycleConfig(
        cycle=CycleType.MULTADD, smoother=SmootherType.L1_JACOBI,
        use_smoothed_transfers=True,
    )
    acfg = AsyncConfig(omega=0.7, fire_prob=0.8, sim_read_delay=1,
                       async_type="semi")
    b = jnp.asarray(np.random.default_rng(0).random(prob.n))
    res = grid_parallel_solve(
        hier, cfg, acfg, tuple(tuple(ls) for ls in packed), lscale, mesh,
        b, tol=1e-6, max_cycles=300,
    )
    assert float(res.rel_resnorm) <= 1e-6
