"""Micro-benchmark: ELL vs BSR SpMV on unstructured matrices.

Measures marginal cost per matvec (chained dependent applies, value-fetch
timed) for the device formats on AMG-relevant matrices:
  - 3D 27-pt Laplacian treated as unstructured (no stencil fast path)
  - native Q1 elasticity beam (3 dofs/node, ~81 nnz/row)
  - a coarse AMG level of the 27-pt hierarchy (ext+i, HMIS)

Usage: python tools/bench_formats.py [n_side]
"""

import sys
import time

import numpy as np


def marginal(apply_fn, x0, k0=1, k1=101, reps=3):
    import jax
    import jax.numpy as jnp

    z = apply_fn(x0)
    jax.block_until_ready(z)
    float(jnp.sum(z))

    def chained(k):
        zz = x0
        t0 = time.perf_counter()
        for _ in range(k):
            zz = apply_fn(zz)
        jax.block_until_ready(zz)
        float(jnp.sum(zz))
        return time.perf_counter() - t0

    t0 = min(chained(k0) for _ in range(reps))
    t1 = min(chained(k1) for _ in range(reps))
    return max((t1 - t0) / (k1 - k0), 1e-12)


def bench_matrix(
    name, csr, dtype, bsr_shapes=((8, 8), (8, 16), (16, 8), (16, 16), (8, 32))
):
    import jax
    import jax.numpy as jnp

    from amg_jax.sparse.bsr import bsr_fill_stats, bsr_from_csr, bsr_spmv
    from amg_jax.sparse.ell import ell_from_csr, ell_spmv

    n, m = csr.shape
    rng = np.random.default_rng(0)
    # chained timing needs output feeding back into input: for rectangular
    # operators slice/pad the state vector around the apply
    x0 = jnp.asarray(rng.random(n), dtype=dtype)

    def feedback(spmv, a):
        def f(x):
            y = spmv(a, x[:m] if m <= n else jnp.pad(x, (0, m - n)))
            return y[:n] if y.shape[0] >= n else jnp.pad(y, (0, n - y.shape[0])) + x * 0.5
        return jax.jit(lambda x: f(x) * 0.01 + x)

    t_ell = marginal(feedback(ell_spmv, ell_from_csr(csr, dtype=dtype)), x0)
    a_ell = ell_from_csr(csr, dtype=dtype)
    print(
        f"{name:28s} n={n:8d} nnz={csr.nnz:9d} "
        f"ELL k={a_ell.k:3d}: {t_ell*1e3:8.3f} ms  "
        f"{csr.nnz/t_ell/1e9:7.2f} Gnnz/s"
    )
    for bm, bn in bsr_shapes:
        st = bsr_fill_stats(csr, bm=bm, bn=bn)
        a_bsr = bsr_from_csr(csr, bm=bm, bn=bn, dtype=dtype)
        t_bsr = marginal(feedback(bsr_spmv, a_bsr), x0)
        print(
            f"{'':28s} BSR {bm:2d}x{bn:3d} kb={st['kb']:3d} "
            f"blowup={st['blowup']:5.1f}: {t_bsr*1e3:8.3f} ms  "
            f"{csr.nnz/t_bsr/1e9:7.2f} Gnnz/s  ({t_ell/t_bsr:4.1f}x vs ELL)"
        )


def main():
    import jax
    import jax.numpy as jnp

    n_side = int(sys.argv[1]) if len(sys.argv) > 1 else 48
    from amg_jax import dtypes

    dtype = dtypes.default_solve_dtype()
    print(
        f"platform={dtypes.platform()} device={jax.devices()[0].device_kind} "
        f"dtype={jnp.dtype(dtype).name} n_side={n_side}"
    )

    from amg_jax.problems import laplacian_3d_27pt
    from amg_jax.problems.elasticity import elasticity_beam

    prob = laplacian_3d_27pt(n_side)
    bench_matrix("27pt (as unstructured)", prob.A, dtype)

    eprob = elasticity_beam(2 * n_side, n_side // 2, n_side // 2)
    bench_matrix("elasticity beam Q1", eprob.A, dtype)

    from amg_jax.setup.hierarchy import HierarchyParams, build_host_hierarchy

    hh = build_host_hierarchy(
        prob.A, HierarchyParams(build_smoothed_transfers=False)
    )
    if hh.num_levels > 1:
        bench_matrix("27pt coarse level 1 (RAP)", hh.levels[1].A, dtype)
        pmat = hh.levels[0].P
        bench_matrix("27pt P (level 0->1)", pmat, dtype)


if __name__ == "__main__":
    main()
