"""Generate golden convergence histories for the 5 BASELINE configs.

Run once (deterministic: seeded PRNGs, fixed setup); the outputs under
tests/golden/ are asserted exactly by tests/test_golden.py, so any
regression in cycle count, residual trajectory, or hierarchy shape fails CI
(the convergence-history oracle of SURVEY.md §4; reference:
src/SMEM_Solve.cpp:95-103 -print_reshist).

    XLA_FLAGS=--xla_force_host_platform_device_count=8 python tools/gen_golden.py
"""

import sys, os
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import jax as _jax

_jax.config.update("jax_platforms", "cpu")

import json

GOLDEN_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "tests", "golden",
)

# the 5 BASELINE.md configs, sized for CI
CONFIGS = {
    # 1: 2D 5-pt Laplacian, sequential synchronous V-cycle to 1e-8
    "config1_5pt_mult": dict(problem="5pt", n=32, solver="mult"),
    # 2: 3D 27-pt, single-chip sync, Jacobi + Chebyshev
    "config2_27pt_jacobi_cheby": dict(
        problem="27pt", n=12, solver="mult", smoother="jacobi", accel="cheby",
    ),
    # 3: 3D async (SMEM bounded-staleness semantics)
    "config3_27pt_async_multadd": dict(
        problem="27pt", n=12, solver="async_multadd", seed=0,
    ),
    # 4: elasticity, multi-chip single-host row-partitioned V-cycle w/ halos
    "config4_elasticity_dist": dict(
        problem="elasticity", nx=16, ny=4, solver="mult",
        smoother="l1_jacobi", outer_solver="pcg", num_devices=8,
        comm="halo", device_format="ell", setup_type="classical",
    ),
    # elasticity at bare CLI defaults (round-3 fixup: SA on rigid-body
    # candidates under PCG) — pins the production single-device recipe
    "config8_elasticity_sa_pcg": dict(problem="elasticity", nx=16, ny=4),
    # 5: Maxwell curl-curl through the auxiliary-space (AMS) solver — the
    # convergent path for curl-curl (classical AMG stalls at rho~0.99 on it,
    # as expected without gradient-space handling); multi-host execution of
    # the distributed programs is validated by tests/test_multiprocess.py
    "config5_maxwell_ams": dict(
        problem="maxwell", nx=6, solver="mult", outer_solver="ams_pcg",
    ),
    # round-2 distributed paths, pinned beyond the 5 BASELINE configs:
    # grid (level) parallelism over 8 devices and the halo-exchange V-cycle
    "config6_grid_async_multadd": dict(
        problem="5pt", n=32, solver="async_multadd", num_devices=8, seed=0,
    ),
    "config7_halo_dist_mult": dict(
        problem="27pt", n=12, solver="mult", num_devices=8, comm="halo",
        device_format="ell",
    ),
    # round-4 MEDIUM-SCALE goldens (round-3 verdict item 2): the toy-sized
    # configs above cannot see scale-dependent failures (the round-3
    # config-4 f32 stall appeared only >=100k dofs). These pin a 110k-dof
    # 6-level 27-pt solve and the 49k-dof DIA elasticity beam through the
    # production mixed-precision DS-PCG path.
    "config9_27pt_medium": dict(problem="27pt", n=48, solver="mult"),
    "config10_elasticity_dia_mixed": dict(
        problem="elasticity", nx=96, ny=12, nz=12, elast_bc="identity",
        hierarchy="structured", mixed_precision=True, tol=1e-5,
        num_cycles=60,
    ),
    # round-4 production recipe: hybrid-JGS smoothing on the DIA levels
    # under the mixed-precision DS-PCG (the bench config of record — 14
    # iterations at 157k vs 20 for L1-Jacobi)
    "config11_elasticity_jgs_mixed": dict(
        problem="elasticity", nx=96, ny=12, nz=12, elast_bc="identity",
        hierarchy="structured", smoother="hybrid_jgs",
        mixed_precision=True, tol=1e-5, num_cycles=60,
    ),
    # round-5: config 5 ASSEMBLED — asynchronous additive Maxwell driven
    # through the grid-parallel engine over 8 devices (AMS correction
    # groups with owned operator storage; reference: src/Maxwell.cpp fed
    # into src/DMEM_Add.cpp over the ACCUMULATE channels)
    "config12_maxwell_async_ams_grid": dict(
        problem="maxwell", nx=8, solver="async_ams", num_devices=8,
        tol=1e-6, num_cycles=600, seed=0,
    ),
    # round-5 MEDIUM async golden (verdict item 6): the async additive
    # goldens topped out at n~2k; this pins a 33k-dof async multadd run
    # through the accelerated (asymmetric cheby) production path
    "config13_27pt_medium_async": dict(
        problem="27pt", n=32, solver="async_multadd", seed=0,
        accel="cheby",
    ),
}


def main():
    from amg_jax.utils.config import SolverOptions
    from amg_jax.utils.runner import run_experiment

    only = set(sys.argv[1:])  # regenerate a subset: gen_golden.py config9...
    os.makedirs(GOLDEN_DIR, exist_ok=True)
    for name, kw in CONFIGS.items():
        if only and not any(name.startswith(o) for o in only):
            continue
        st = run_experiment(SolverOptions(**kw))
        rec = {
            "config": kw,
            "cycles": st.cycles,
            "rel_resnorm": st.rel_resnorm,
            "history": st.history,
            "level_n": st.level_n,
            "level_nnz": st.level_nnz,
            "num_levels": st.num_levels,
            "operator_complexity": st.operator_complexity,
        }
        path = os.path.join(GOLDEN_DIR, name + ".json")
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        print(f"{name}: cycles={st.cycles} rel={st.rel_resnorm:.3e} "
              f"levels={st.num_levels}")


if __name__ == "__main__":
    main()
