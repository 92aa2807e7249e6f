"""Parity odds-and-ends: nonsymmetric difconv solves, divergence guard,
checkpoint/resume round-trip."""

import os

import numpy as np
import pytest

import jax.numpy as jnp

from amg_jax.problems import difconv_3d
from amg_jax.setup.hierarchy import HierarchyParams, build_hierarchy
from amg_jax.smooth import SmootherType
from amg_jax.solve import CycleConfig, CycleType, solve


@pytest.mark.parametrize("atype,eps", [(0, 1.0), (2, 0.1)])
def test_difconv_solve(atype, eps):
    """Nonsymmetric diffusion-convection systems (the reference's -difconv
    problems, src/BuildHypreMatrix.cpp:14-292) through classical AMG."""
    p = difconv_3d(12, eps=eps, atype=atype)
    params = HierarchyParams(
        smoother=SmootherType.HYBRID_JGS,
        keep_stencil_fine=False,
        build_smoothed_transfers=False,
    )
    hh, hier = build_hierarchy(p.A, params)
    cfg = CycleConfig(cycle=CycleType.MULT, smoother=SmootherType.HYBRID_JGS)
    b = jnp.asarray(np.random.default_rng(0).random(p.n))
    res = solve(hier, cfg, b, tol=1e-8, max_cycles=100)
    assert float(res.rel_resnorm) < 1e-8
    assert int(res.iters) < 60


def test_divergence_guard_stops_early():
    """Convection-dominated upwind flow amplifies under this cycle — the
    loop must bail instead of spinning to max_cycles."""
    p = difconv_3d(12, eps=0.01, atype=3)
    params = HierarchyParams(
        smoother=SmootherType.HYBRID_JGS,
        keep_stencil_fine=False,
        build_smoothed_transfers=False,
    )
    hh, hier = build_hierarchy(p.A, params)
    cfg = CycleConfig(cycle=CycleType.MULT, smoother=SmootherType.HYBRID_JGS)
    b = jnp.asarray(np.random.default_rng(0).random(p.n))
    res = solve(hier, cfg, b, tol=1e-8, max_cycles=500)
    if float(res.rel_resnorm) > 1.0:  # diverged: must have stopped early
        assert int(res.iters) < 500


def test_checkpoint_roundtrip(tmp_path):
    from amg_jax.utils.checkpoint import load_solve_state, save_solve_state

    from amg_jax.problems import laplacian_2d_5pt

    p = laplacian_2d_5pt(16)
    params = HierarchyParams()
    hh, hier = build_hierarchy(p.A, params)
    cfg = CycleConfig(cycle=CycleType.MULT)
    b = jnp.asarray(np.random.default_rng(0).random(p.n))
    res1 = solve(hier, cfg, b, tol=1e-4)
    path = os.path.join(tmp_path, "state.npz")
    save_solve_state(
        path, res1.x, b, iters=int(res1.iters), history=res1.history,
        meta={"problem": "5pt", "n": p.n},
    )
    st = load_solve_state(path)
    assert st["meta"]["n"] == p.n
    # resume from the checkpointed x (tol is relative to the warm r0, so
    # the resumed solve reaches a much smaller *absolute* residual)
    bb = jnp.asarray(st["b"])
    res2 = solve(hier, cfg, bb, x0=jnp.asarray(st["x"]), tol=1e-8)
    res_cold = solve(hier, cfg, b, tol=1e-8)
    A0 = hier.levels[0].A
    abs2 = float(jnp.linalg.norm(bb - A0 @ res2.x))
    abs_cold = float(jnp.linalg.norm(b - A0 @ res_cold.x))
    assert abs2 < abs_cold
    assert float(res2.rel_resnorm) < 1e-8


def test_difconv_anisotropic_diffusion_matches_7pt():
    """cx/cy/cz per-axis diffusion (reference -cx/-cy/-cz): with zero
    convection, difconv is the anisotropic 7-pt Laplacian scaled by 1/h^2."""
    import numpy as np

    from amg_jax.problems import laplacian_3d_7pt

    n = 6
    h = 1.0 / (n + 1)
    p = difconv_3d(n, eps=1.0, ax=0.0, ay=0.0, az=0.0,
                   cx=2.0, cy=1.0, cz=0.25)
    lap = laplacian_3d_7pt(n, cx=2.0, cy=1.0, cz=0.25)
    np.testing.assert_allclose(
        p.A.to_dense() * h * h, lap.A.to_dense(), rtol=1e-13, atol=1e-13
    )


def test_difconv_cli_coefficient_flags():
    from amg_jax.utils.cli import build_parser
    from amg_jax.utils.config import SolverOptions

    args = build_parser().parse_args(
        "-problem difconv -n 8 -ax 0.5 -cy 3.0".split()
    )
    o = SolverOptions(**{k: (tuple(v) if isinstance(v, list) else v)
                         for k, v in vars(args).items()})
    assert o.ax == 0.5 and o.cy == 3.0 and o.cx == 1.0


def test_num_smooth_sweeps_sets_all_phases():
    """-num_smooth_sweeps N is the reference's one-knob spelling for all
    sweep counts (src/DMEM_Main.cpp:489-497)."""
    from amg_jax.utils.config import SolverOptions

    o = SolverOptions(num_smooth_sweeps=3).fixup()
    assert (o.num_pre_smooth_sweeps, o.num_post_smooth_sweeps,
            o.num_fine_smooth_sweeps, o.num_coarse_smooth_sweeps) == (3,) * 4


def test_cli_reference_aliases_parse():
    from amg_jax.utils.cli import build_parser

    args = build_parser().parse_args(
        "-problem vardifconv -n 8 -vardifconv_eps 0.1 -num_func 2 "
        "-cheby_eig_max_iters 7 -delay_all -fail_one 5 "
        "-assign_procs scalar -assign_procs_scalar 0.25".split()
    )
    assert args.eps == 0.1
    assert args.num_functions == 2
    assert args.cheby_power_iters == 7
    assert args.delay_type == "all"
    assert args.fail_iter == 5
    assert args.assign_procs == "scalar"


def test_assign_procs_scalar_policy():
    """ASSIGN_PROCS_SCALAR: geometric decay of group sizes, remainder on the
    coarsest grid (reference: src/DMEM_Setup.cpp:1684-1685)."""
    import numpy as np

    from amg_jax.parallel.partition import assign_levels_to_devices

    work = np.full(4, 0.25)
    ranges = assign_levels_to_devices(work, 8, policy="scalar", scalar=0.5)
    counts = [e - s for s, e in ranges]
    assert counts == [4, 2, 1, 1]
    assert ranges[0] == (0, 4) and ranges[-1] == (7, 8)
    # repair path: decay leaves devices over → coarsest absorbs them
    ranges = assign_levels_to_devices(work, 12, policy="scalar", scalar=0.25)
    counts = [e - s for s, e in ranges]
    assert sum(counts) == 12 and all(c >= 1 for c in counts)


def test_delay_some_resolution_in_runner():
    """-delay_some frac resolves to a random fraction of level groups; the
    delayed levels fire with -delay_prob (reference DELAY_SOME,
    src/SMEM_Solve.cpp:116-126)."""
    from amg_jax.utils.config import SolverOptions
    from amg_jax.utils.runner import run_experiment

    o = SolverOptions(problem="5pt", n=16, solver="async_multadd",
                      delay_frac=0.5, delay_prob=0.1, num_cycles=400,
                      print_grid_wait=True)
    stats = run_experiment(o)
    assert stats.rel_resnorm <= 1e-8
    # delayed levels fire ~5x less often than the fire_prob=0.5 groups
    counts = np.asarray(stats.grid_wait["num_correct"], dtype=float)
    assert counts.min() < 0.45 * counts.max()
