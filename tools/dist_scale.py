"""At-scale distributed convergence record (round-4, verdict missing item 2).

Round-3's distributed correctness artifacts were all toy-sized (goldens
<= 1728 dofs at level 0, 24^2 multiprocess solve). This tool runs the
distributed paths at >= 1M dofs and records the convergence numbers:

  1. 8-device GSPMD-sharded structured hierarchy, 3D 27-pt Laplacian at
     102^3 = 1.06M dofs, V-cycle MULT to 1e-8 (f64 on the virtual CPU
     mesh; boundary-plane halo exchange inserted by GSPMD).
  2. 8-device sharded DIA elasticity beam at 1.26M dofs
     (nx=384, ny=32, nz=32 -> 385*33*33*3 = 1,258,092), V(2,2)-PCG.
  3. 8-device halo-ELL (explicit boundary-segment comm) 3D 7-pt at
     96x96x112 = 1.03M dofs, V-cycle MULT.

Run:
  XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python tools/dist_scale.py [--quick]

--quick shrinks every problem ~8x (CI-sized smoke of the same code
paths). Results are appended as a JSON line; the committed record lives
in DIST_SCALE.md.

(This records CONVERGENCE of the genuinely-sharded programs, which is
what the reference's DMEM runs validate first, src/DMEM_Main.cpp:12-948;
it times nothing.)
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402


def main(quick=False):
    import jax.numpy as jnp

    from amg_jax.parallel import make_row_mesh
    from amg_jax.parallel.dist import (
        build_dist_hierarchy,
        pad_vector,
        shard_structured_hierarchy,
        unpad_vector,
    )
    from amg_jax.problems import laplacian_3d_7pt, laplacian_3d_27pt
    from amg_jax.problems.elasticity import elasticity_beam
    from amg_jax.setup.hierarchy import (
        HierarchyParams,
        build_host_hierarchy,
    )
    from amg_jax.setup.structured import (
        build_dia_structured_hierarchy,
        build_structured_hierarchy,
    )
    from amg_jax.smooth import SmootherType
    from amg_jax.solve import CycleConfig, CycleType, solve

    D = 8
    assert len(jax.devices()) >= D, "need 8 (virtual) devices"
    mesh = make_row_mesh(D)
    out = {}

    # --- 1) GSPMD structured 27-pt at 1.06M dofs --------------------------
    n_side = 48 if quick else 102  # 102^3 = 1,061,208 (div by 8)
    t0 = time.time()
    prob = laplacian_3d_27pt(n_side)
    _, hier = build_structured_hierarchy(
        prob.stencil, smoother=SmootherType.L1_JACOBI
    )
    hier = shard_structured_hierarchy(hier, mesh)
    cfg = CycleConfig(cycle=CycleType.MULT, smoother=SmootherType.L1_JACOBI)
    b = jnp.asarray(np.random.default_rng(0).random(prob.n))
    res = solve(hier, cfg, b, tol=1e-8, max_cycles=40)
    jax.block_until_ready(res.x)
    out["struct_27pt"] = {
        "n": prob.n,
        "devices": D,
        "cycles": int(res.iters),
        "rel_res": float(res.rel_resnorm),
        "wtime_s": round(time.time() - t0, 1),
    }
    print("struct_27pt:", out["struct_27pt"], flush=True)

    # --- 2) sharded DIA elasticity at 1.08M dofs --------------------------
    nx, ny, nz = (48, 12, 12) if quick else (384, 32, 32)
    t0 = time.time()
    pe = elasticity_beam(nx=nx, ny=ny, nz=nz, bc="identity")
    _, hier_e = build_dia_structured_hierarchy(
        pe.A, (nx + 1, ny + 1, nz + 1), num_functions=3,
    )
    hier_e = shard_structured_hierarchy(hier_e, mesh)
    cfg_e = CycleConfig(
        cycle=CycleType.MULT, smoother=SmootherType.L1_JACOBI,
        num_pre_sweeps=2, num_post_sweeps=2,
    )
    be = jnp.asarray(np.asarray(pe.rhs) / np.linalg.norm(pe.rhs))
    res_e = solve(hier_e, cfg_e, be, tol=1e-8, max_cycles=60, outer="pcg")
    jax.block_until_ready(res_e.x)
    out["dia_elasticity"] = {
        "n": pe.n,
        "devices": D,
        "cycles": int(res_e.iters),
        "rel_res": float(res_e.rel_resnorm),
        "wtime_s": round(time.time() - t0, 1),
    }
    print("dia_elasticity:", out["dia_elasticity"], flush=True)

    # --- 3) halo-ELL 7-pt at 1.03M dofs (explicit boundary segments) ------
    t0 = time.time()
    p7 = (
        laplacian_3d_7pt(32)
        if quick
        else laplacian_3d_7pt(96, 96, 112)  # 1,032,192 dofs
    )
    params = HierarchyParams(
        smoother=SmootherType.L1_JACOBI, keep_stencil_fine=False,
        device_format="ell",
    )
    hh = build_host_hierarchy(p7.A, params)
    hier_h, pad_info = build_dist_hierarchy(hh, params, mesh, comm="halo")
    b7 = pad_vector(
        jnp.asarray(np.random.default_rng(1).random(p7.n)), pad_info, mesh
    )
    res_h = solve(hier_h, cfg, b7, tol=1e-8, max_cycles=80)
    jax.block_until_ready(res_h.x)
    x7 = np.asarray(unpad_vector(res_h.x, pad_info))
    true_rel = float(
        np.linalg.norm(
            np.asarray(b7)[: p7.n] - p7.A.to_scipy() @ x7
        )
        / np.linalg.norm(np.asarray(b7)[: p7.n])
    )
    out["halo_7pt"] = {
        "n": p7.n,
        "devices": D,
        "cycles": int(res_h.iters),
        "rel_res": float(res_h.rel_resnorm),
        "true_rel": true_rel,
        "wtime_s": round(time.time() - t0, 1),
    }
    print("halo_7pt:", out["halo_7pt"], flush=True)

    # --- 4) ASYNC grid-parallel additive at 110k dofs (round-5, verdict
    # item 6: the three records above are all synchronous; the reference's
    # headline experiments are async at scale, src/DMEM_Add.cpp:20-178).
    # 8 device groups own multigrid levels, bounded-staleness reads,
    # ACCUMULATE psum exchange, asymmetric async Chebyshev acceleration,
    # grid-wait (staleness) statistics captured.
    t0 = time.time()
    n_as = 24 if quick else 48  # 48^3 = 110,592 dofs
    pa = laplacian_3d_27pt(n_as)
    params_a = HierarchyParams(
        smoother=SmootherType.L1_JACOBI, keep_stencil_fine=False
    )
    from amg_jax.parallel.grid import grid_parallel_solve, plan_grid_levels
    from amg_jax.setup.hierarchy import build_hierarchy
    from amg_jax.solve.async_sim import AsyncConfig
    from amg_jax.solve.driver import cheby_setup

    hh_a, hier_a = build_hierarchy(pa.A, params_a)
    cfg_a = CycleConfig(
        cycle=CycleType.MULTADD, smoother=SmootherType.L1_JACOBI,
        use_smoothed_transfers=True,
    )
    coeffs = cheby_setup(hier_a, cfg_a, num_iters=20)
    acfg = AsyncConfig(
        fire_prob=0.5, sim_read_delay=2, async_type="semi",
        accel="cheby", cheby_mu=coeffs.mu, cheby_delta=coeffs.delta * 0.6,
    )
    _, levels_of, lscale = plan_grid_levels(hh_a, D)
    ba = jnp.asarray(np.random.default_rng(2).random(pa.n))
    res_a = grid_parallel_solve(
        hier_a, cfg_a, acfg, levels_of, lscale, mesh, ba,
        tol=1e-8, max_cycles=800,
    )
    jax.block_until_ready(res_a.x)
    true_rel_a = float(
        np.linalg.norm(np.asarray(ba) - pa.A.to_scipy() @ np.asarray(res_a.x))
        / np.linalg.norm(np.asarray(ba))
    )
    gw = res_a.grid_wait.summary()
    out["grid_async_multadd"] = {
        "n": pa.n,
        "devices": D,
        "levels_of": [list(ls) for ls in levels_of],
        "supersteps": int(res_a.iters),
        "rel_res": float(res_a.rel_resnorm),
        "true_rel": true_rel_a,
        "grid_wait_mean": [round(v, 2) for v in gw["mean"]],
        "grid_wait_max": gw["max"],
        "accel": "cheby (asymmetric, delta x0.6)",
        "wtime_s": round(time.time() - t0, 1),
    }
    print("grid_async_multadd:", out["grid_async_multadd"], flush=True)
    print("RECORD " + json.dumps(out), flush=True)


if __name__ == "__main__":
    main(quick="--quick" in sys.argv)
