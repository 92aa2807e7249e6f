"""Weak-scaling harness: the distributed V-cycle at 1..N devices.

Run on a host of GPUs, or on the virtual CPU mesh for plumbing checks:
    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
    python tools/bench_scaling.py --devices 1 2 4 8 --base-n 16

Weak scaling: the per-device problem size is constant (base_n^3 rows per
device, grown along z). Reports, per device count:
  * nnz/s and wall-clock weak efficiency vs 1 device — meaningful on real
    multi-chip hardware; on an oversubscribed virtual CPU mesh (D devices
    time-sharing few cores) the wall numbers measure the host, not the
    design, and are flagged as such;
  * per-device comm bytes per V-cycle (exact, traced from the halo
    patterns) and its growth vs 1 device — the architectural weak-scaling
    guarantee: constant per-device comm volume + constant per-device
    compute ⇒ constant per-device cycle time on real hardware;
  * a roofline efficiency model from those volumes (HBM-bound compute vs
    NVLink-bound comm, overlappable).
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--base-n", type=int, default=16)
    ap.add_argument("--cycles", type=int, default=10)
    ap.add_argument("--comm", default="halo", choices=["halo", "gspmd"])
    ap.add_argument(
        "--hbm-gbps", type=float, default=3350.0,
        help="per-card HBM bandwidth for the roofline model (GB/s; H100 "
        "SXM data sheet)",
    )
    ap.add_argument(
        "--link-gbps", type=float, default=450.0,
        help="per-card NVLink bandwidth each way for the roofline model "
        "(GB/s; H100 SXM data sheet)",
    )
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np

    from amg_jax.parallel import make_row_mesh
    from amg_jax.parallel.dist import build_dist_hierarchy, pad_vector
    from amg_jax.parallel.spcomm import comm_trace
    from amg_jax.problems import laplacian_3d_27pt
    from amg_jax.setup.hierarchy import HierarchyParams, build_host_hierarchy
    from amg_jax.smooth import SmootherType
    from amg_jax.solve import CycleConfig, CycleType
    from amg_jax.solve.cycles import mult_vcycle

    n_phys = os.cpu_count() or 1
    from amg_jax.dtypes import platform

    oversub = platform() == "cpu"
    results = []
    base_rate = None
    base_comm = None
    for nd in args.devices:
        if nd > len(jax.devices()):
            print(f"# skipping {nd} devices (have {len(jax.devices())})")
            continue
        n = args.base_n
        # weak scaling: grow along the SLOWEST-varying grid axis so the
        # contiguous row partition stays a fixed-surface slab decomposition
        prob = laplacian_3d_27pt(n * nd, n, n)
        params = HierarchyParams(
            smoother=SmootherType.L1_JACOBI, keep_stencil_fine=False,
            device_format="ell",
        )
        hh = build_host_hierarchy(prob.A, params)
        mesh = make_row_mesh(nd)
        hier, pad_info = build_dist_hierarchy(
            hh, params, mesh, comm=args.comm
        )
        b = pad_vector(
            jnp.asarray(np.random.default_rng(0).random(prob.n)), pad_info, mesh
        )
        cfg = CycleConfig(cycle=CycleType.MULT, smoother=SmootherType.L1_JACOBI)
        vc = jax.jit(lambda h, x, b: mult_vcycle(h, cfg, x, b))
        x = jnp.zeros_like(b)

        # exact per-device comm volume per cycle, from the halo patterns
        comm_bytes = 0
        if args.comm == "halo":
            with comm_trace() as log:
                jax.eval_shape(lambda h, xx, bb: mult_vcycle(h, cfg, xx, bb),
                               hier, x, b)
            comm_bytes = int(sum(log))
        else:
            # gspmd all-gathers the full (sharded) vector per matvec: count
            # matvecs from a traced halo-free estimate — n bytes per matvec
            comm_bytes = -1  # not statically determined; O(n) per matvec

        z = vc(hier, x, b)
        jax.block_until_ready(z)

        def run(k):
            zz = x
            t0 = time.perf_counter()
            for _ in range(k):
                zz = vc(hier, zz, b)
            jax.block_until_ready(zz)
            return time.perf_counter() - t0

        t1 = min(run(1) for _ in range(2))
        tk = min(run(args.cycles + 1) for _ in range(2))
        per = (tk - t1) / args.cycles
        nnz = sum(hh.stats()["nnz"])
        rate = nnz / per
        if base_rate is None:
            base_rate = rate / nd
        if base_comm is None and nd > 1 and comm_bytes > 0:
            base_comm = comm_bytes  # first point with real halo traffic
        eff_wall = rate / (nd * base_rate)
        comm_growth = (
            comm_bytes / base_comm if (base_comm and comm_bytes > 0) else None
        )
        # roofline model: per-device compute traffic = 3 passes over local
        # nnz (vals+cols+gather) + vectors; comm rides NVLink and overlaps
        local_bytes = (nnz / nd) * (8 + 4 + 8)
        t_hbm = local_bytes / (args.hbm_gbps * 1e9)
        t_link = (
            comm_bytes / (args.link_gbps * 1e9) if comm_bytes > 0 else 0.0
        )
        eff_model = t_hbm / max(t_hbm, t_link) if nd > 1 else 1.0
        results.append({
            "devices": nd, "rows": prob.n, "nnz_per_s": rate,
            "ms_per_cycle": per * 1e3,
            "weak_efficiency_wall": eff_wall,
            "wall_meaningful": (not oversub) or nd <= n_phys,
            "comm_bytes_per_device_per_cycle": comm_bytes,
            "comm_growth_vs_1dev": comm_growth,
            "weak_efficiency_model": eff_model,
        })
        print(json.dumps(results[-1]))
    return results


if __name__ == "__main__":
    main()
