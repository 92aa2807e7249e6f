"""AFACj with the ideal interpolant (round-1 verdict item 8).

The hypre patch's P_array_afacj is realized as the diagonal-Schur ideal
interpolant P_id = [-D_ff^-1 A_fc; I] (one-point Jacobi approximation of
[-A_ff^-1 A_fc; I]); the AFACj cycle runs its chains through it with a
standard final hop (reference: DMEM_SyncAFACCycle,
src/DMEM_Mult.cpp:453-612)."""

import numpy as np
import pytest

import jax.numpy as jnp

from amg_jax.problems import difconv_3d, laplacian_2d_5pt
from amg_jax.setup.hierarchy import HierarchyParams, build_hierarchy
from amg_jax.setup.coarsen import C_PT
from amg_jax.smooth import SmootherType
from amg_jax.solve import CycleConfig, CycleType, solve
from amg_jax.solve.driver import cheby_setup
from amg_jax.sparse.ell import ell_from_csr


def test_pid_structure():
    """P_id = [-D_ff^-1 A_fc; I]: identity on C rows, -a_ic/a_ii on F rows."""
    prob = laplacian_2d_5pt(12)
    hh, _ = build_hierarchy(
        prob.A, HierarchyParams(smoother=SmootherType.L1_JACOBI)
    )
    hl = hh.levels[0]
    P = hl.P_id.to_scipy().toarray()
    A = hl.A.to_scipy().toarray()
    cf = hl.cf
    crows = np.flatnonzero(cf == C_PT)
    cmap = {c: j for j, c in enumerate(crows)}
    for j, c in enumerate(crows):
        row = np.zeros(P.shape[1])
        row[j] = 1.0
        np.testing.assert_allclose(P[c], row)
    frows = np.flatnonzero(cf != C_PT)
    for i in frows[:20]:
        expect = np.zeros(P.shape[1])
        for c in crows:
            if A[i, c] != 0.0:
                expect[cmap[c]] = -A[i, c] / A[i, i]
        np.testing.assert_allclose(P[i], expect, atol=1e-15)
    # R_id is the exact transpose
    R = hl.R_id.to_scipy().toarray()
    np.testing.assert_allclose(R, P.T)


def test_afacj_converges_and_beats_injection():
    """The verdict's done-criterion: ideal-interpolant AFACj beats the
    injection-interpolant variant on a difconv case."""
    prob = difconv_3d(12, 12, 12, eps=0.1)
    params = HierarchyParams(smoother=SmootherType.L1_JACOBI)
    hh, hier = build_hierarchy(prob.A, params, fine_stencil=prob.stencil)
    b = jnp.asarray(np.random.default_rng(0).random(prob.n))
    cfg = CycleConfig(cycle=CycleType.AFACJ, smoother=SmootherType.L1_JACOBI)

    def run(h):
        coeffs = cheby_setup(h, cfg)
        return solve(h, cfg, b, tol=1e-8, max_cycles=400,
                     accel="cheby", cheby_coeffs=coeffs)

    res_ideal = run(hier)
    assert float(res_ideal.rel_resnorm) <= 1e-8
    # swap the ideal interpolants for pure C-point injection (the round-1
    # approximation) — must be measurably worse
    levels_inj = []
    for k, lv in enumerate(hier.levels):
        if lv.R_inj is not None:
            hl = hh.levels[k]
            P_inj = ell_from_csr(hl.R_inj.transpose(), dtype=params.dtype)
            levels_inj.append(lv._replace(P_id=P_inj, R_id=lv.R_inj))
        else:
            levels_inj.append(lv)
    hier_inj = hier._replace(levels=tuple(levels_inj))
    res_inj = run(hier_inj)
    assert int(res_ideal.iters) < 0.7 * int(res_inj.iters), (
        int(res_ideal.iters), int(res_inj.iters),
    )


def test_afacj_defaults_cli():
    from amg_jax.utils.config import SolverOptions
    from amg_jax.utils.runner import run_experiment

    st = run_experiment(SolverOptions(problem="5pt", n=32, solver="afacj"))
    assert st.rel_resnorm <= 1e-8
    st = run_experiment(
        SolverOptions(problem="5pt", n=24, solver="async_afacx")
    )
    assert st.rel_resnorm <= 1e-8


def test_afacj_level_depth_knob():
    """-afacj_level controls how far from the target grid chain hops switch
    to the ideal interpolant (reference: `my_grid - level > afacj_level`,
    src/DMEM_Setup.cpp:308). A large depth makes AFACj's chains all-standard;
    both settings converge, with different trajectories on deep grids."""
    import jax.numpy as jnp
    import numpy as np

    from amg_jax.problems import laplacian_2d_5pt
    from amg_jax.setup.hierarchy import HierarchyParams, build_hierarchy
    from amg_jax.smooth import SmootherType
    from amg_jax.solve import CycleConfig, CycleType, solve

    prob = laplacian_2d_5pt(32)
    params = HierarchyParams(smoother=SmootherType.L1_JACOBI,
                             max_coarse_size=16)
    hh, hier = build_hierarchy(prob.A, params)
    assert hh.num_levels >= 4
    b = jnp.asarray(np.random.default_rng(0).random(prob.n))
    from amg_jax.solve.driver import cheby_setup

    out = {}
    for depth in (1, 99):
        cfg = CycleConfig(cycle=CycleType.AFACJ,
                          smoother=SmootherType.L1_JACOBI,
                          afacj_level=depth)
        coeffs = cheby_setup(hier, cfg)
        res = solve(hier, cfg, b, tol=1e-8, max_cycles=400, accel="cheby",
                    cheby_coeffs=coeffs)
        assert float(res.rel_resnorm) <= 1e-8, depth
        out[depth] = np.asarray(res.history)
    h1, h99 = out[1], out[99]
    m = min(len(h1), len(h99))
    assert not np.allclose(h1[:m][~np.isnan(h1[:m])][:5],
                           h99[:m][~np.isnan(h99[:m])][:5])


def test_add_tr_truncates_smoothed_transfers():
    """-add_tr sparsifies the additive smoothed transfers (hypre
    add_trunc_factor, src/DMEM_Setup.cpp:589-593) while multadd still
    converges."""
    import jax.numpy as jnp
    import numpy as np

    from amg_jax.problems import laplacian_2d_5pt
    from amg_jax.setup.hierarchy import HierarchyParams, build_hierarchy
    from amg_jax.smooth import SmootherType
    from amg_jax.solve import CycleConfig, CycleType, solve

    prob = laplacian_2d_5pt(32)
    dense = HierarchyParams(smoother=SmootherType.L1_JACOBI)
    trunc = HierarchyParams(smoother=SmootherType.L1_JACOBI,
                            add_trunc_factor=0.2)
    hh0, _ = build_hierarchy(prob.A, dense)
    hh1, hier1 = build_hierarchy(prob.A, trunc)
    assert hh1.levels[0].P_s.nnz < hh0.levels[0].P_s.nnz
    b = jnp.asarray(np.random.default_rng(0).random(prob.n))
    from amg_jax.solve.driver import cheby_setup

    cfg = CycleConfig(cycle=CycleType.MULTADD,
                      smoother=SmootherType.L1_JACOBI,
                      use_smoothed_transfers=True)
    coeffs = cheby_setup(hier1, cfg)
    res = solve(hier1, cfg, b, tol=1e-8, max_cycles=200, accel="cheby",
                cheby_coeffs=coeffs)
    assert float(res.rel_resnorm) <= 1e-8
