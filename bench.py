"""Benchmark: the solver's kernels and solves on one NVIDIA GPU.

    python bench.py

Prints one JSON line per metric; the LAST line is the headline, the 27-point
SpMV+smoother rate (BASELINE.md's north-star metric: sustained nnz/s of the
weighted-Jacobi relaxation, the reference's production smoother,
src/DMEM_Setup.cpp:77-87). Every record names the device as JAX reports it
and the card's name and power limit as nvidia-smi reports them.

Rates are set against two yardsticks: the published peak of the card
(PEAKS, keyed by JAX's device_kind) and the copy bandwidth measured in the
same run (`copy_bytes_per_s`). Bytes are the least traffic an operation
needs, computed from its shapes; where a neighbour is not held in cache the
real traffic is larger.

Without a GPU, or on a device kind missing from PEAKS, the run fails, and a
metric that fails fails the run. Every kernel is the plain jnp/lax form that
XLA compiles.
"""

import json
import subprocess
import sys
import time

import numpy as np

# Published peaks, dense, without sparsity, at the full power limit.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_bytes_per_s": 3.35e12,
        "f32_flops_per_s": 67e12,
        "bf16_flops_per_s": 989e12,
        "source": "NVIDIA H100 Tensor Core GPU data sheet, SXM5, 700 W",
    },
}


def peaks_for(kind: str) -> dict:
    """The PEAKS entry of a device kind; an unknown kind is an error."""
    if kind not in PEAKS:
        raise KeyError(
            f"no published peaks recorded for device kind {kind!r}; add it "
            "to bench.PEAKS with its source"
        )
    return PEAKS[kind]


def fori_slope(run, k0, k1, reps=3):
    """Seconds per step: the median over `reps` of the slope between two
    trip counts of one jitted fori_loop. Each call pays a fixed cost
    (dispatch, synchronisation, reading back a scalar); the slope removes
    it, leaving the device time of one step."""
    slopes = []
    for _ in range(reps):
        ta = min(run(k0) for _ in range(2))
        tb = min(run(k1) for _ in range(2))
        slopes.append(max((tb - ta) / (k1 - k0), 1e-12))
    slopes.sort()
    return slopes[len(slopes) // 2]


def loop_runner(step, *operands):
    """run(k) for fori_slope: k applications of step(*operands[:-1], v),
    starting from v = operands[-1], inside one jitted fori_loop. Operands
    are jit arguments, not compile-time constants."""
    import jax
    import jax.numpy as jnp

    loop = jax.jit(
        lambda ops, k: jax.lax.fori_loop(
            0, k, lambda _, v: step(*ops[:-1], v), ops[-1]
        )
    )

    def run(k):
        t0 = time.perf_counter()
        float(jnp.sum(loop(operands, jnp.asarray(k, jnp.int32))))
        return time.perf_counter() - t0

    run(1)  # compile
    return run


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


class Recorder:
    """Prints records tagged with the device, the card and the yardsticks."""

    def __init__(self, device, peaks, card):
        self.device = device
        self.peaks = peaks
        self.card = card
        self.copy_bw = None

    def rate(self, metric, seconds, nbytes, **extra):
        rec = {
            "metric": metric,
            "seconds": seconds,
            "bytes": nbytes,
            "bytes_per_s": nbytes / seconds,
            "peak_share": nbytes / seconds / self.peaks["hbm_bytes_per_s"],
        }
        if self.copy_bw:
            rec["copy_share"] = nbytes / seconds / self.copy_bw
        rec.update(extra)
        return self.emit(rec)

    def emit(self, rec):
        rec.update(device=self.device, card=self.card)
        print(json.dumps(rec), flush=True)
        return rec


def bench_copy(rec, n=1 << 28):
    """A large elementwise pass: read and write n float32 (1 GiB each)."""
    import jax.numpy as jnp

    x = jnp.ones(n, jnp.float32)
    per = fori_slope(loop_runner(lambda v: v * 0.5 + 0.5, x), 2, 22)
    out = rec.rate("copy_bytes_per_s", per, 8 * n, n=n)
    rec.copy_bw = out["bytes_per_s"]


def bench_stencil(rec, n_side=192):
    """27-point matvec and weighted-Jacobi sweep. Returns the sweep record,
    the headline."""
    import jax.numpy as jnp

    from amg_jax.problems import laplacian_3d_27pt
    from amg_jax.sparse.stencil import StencilOperator

    st = laplacian_3d_27pt(n_side).stencil
    A = StencilOperator(
        weights=jnp.asarray(np.asarray(st.weights), jnp.float32),
        offsets=st.offsets, grid_shape=st.grid_shape,
    )
    n = int(np.prod(st.grid_shape))
    nnz = st.nnz_exact()
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.random(n), jnp.float32)
    b = jnp.asarray(rng.random(n), jnp.float32)
    # A/52 has spectral radius <= 1, so the chained matvec stays finite
    per_mv = fori_slope(
        loop_runner(lambda a, v: (a @ v) * (1.0 / 52.0), A, x), 10, 110
    )
    rec.rate("stencil27_matvec", per_mv, 8 * n, n=n, nnz=nnz,
             nnz_per_s=nnz / per_mv)
    alpha = (2.0 / 3.0) / 26.0
    per_sw = fori_slope(
        loop_runner(lambda a, f, v: v + alpha * (f - a @ v), A, b, x),
        10, 110,
    )
    return rec.rate("spmv_smoother_nnz_per_s", per_sw, 12 * n, n=n,
                    nnz=nnz, value=nnz / per_sw, unit="nnz/s")


def bench_vcycle(rec, n_side=192, tol=3e-4):
    """One multiplicative V(1,1) L1-Jacobi cycle on the structured
    hierarchy, and the solve to a tolerance above the float32 floor."""
    import jax.numpy as jnp

    from amg_jax.problems import laplacian_3d_27pt
    from amg_jax.setup.structured import build_structured_hierarchy
    from amg_jax.smooth import SmootherType
    from amg_jax.solve import CycleConfig, CycleType, solve
    from amg_jax.solve.cycles import cycle_step

    prob = laplacian_3d_27pt(n_side)
    t0 = time.perf_counter()
    _, hier = build_structured_hierarchy(
        prob.stencil, smoother=SmootherType.L1_JACOBI, dtype=jnp.float32
    )
    setup_s = time.perf_counter() - t0
    cfg = CycleConfig(cycle=CycleType.MULT, smoother=SmootherType.L1_JACOBI)
    b = jnp.asarray(np.random.default_rng(0).random(prob.n), jnp.float32)
    per = fori_slope(
        loop_runner(lambda h, f, v: cycle_step(h, cfg, v, f), hier, b,
                    jnp.zeros_like(b)),
        2, 22,
    )
    solve_s = []
    for _ in range(4):  # the first call compiles
        t0 = time.perf_counter()
        res = solve(hier, cfg, b, tol=tol, max_cycles=60)
        res.x.block_until_ready()
        solve_s.append(time.perf_counter() - t0)
    # fine-level passes of one V(1,1): each sweep reads u, b and writes u
    # (3), the residual 3, restrict 1, prolong-add 2; coarse levels (<= 1/7
    # more) are left out, so the bound is an under-estimate
    passes = 3 * cfg.num_pre_sweeps + 3 + 1 + 2 + 3 * cfg.num_post_sweeps
    rec.rate("vcycle_ms", per, passes * 4 * prob.n, n=prob.n,
             value=per * 1e3, unit="ms/cycle", levels=hier.num_levels,
             setup_s=setup_s, solve_s=min(solve_s[1:]), tol=tol,
             cycles=int(res.iters), rel_res=float(res.rel_resnorm))


def bench_dia(rec, nx, ny, nz, suffix=""):
    """DIA (99-diagonal) matvec and L1-Jacobi sweep of the elasticity beam."""
    import jax.numpy as jnp

    from amg_jax.problems.elasticity import elasticity_beam
    from amg_jax.setup.structured import csr_to_dia_stencil
    from amg_jax.smooth import SmootherType, make_smoother_data, smooth

    prob = elasticity_beam(nx=nx, ny=ny, nz=nz, bc="identity")
    vs = csr_to_dia_stencil(prob.A, prob.grid_shape, jnp.float32)
    n, m = prob.n, len(vs.offsets)
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.random(n), jnp.float32)
    f = jnp.asarray(rng.random(n), jnp.float32)
    inv_norm = 1.0 / float(abs(prob.A.to_scipy()).sum(axis=1).max())
    per_mv = fori_slope(
        loop_runner(lambda a, v: (a @ v) * inv_norm, vs, x), 10, 210
    )
    rec.rate("dia_spmv_nnz_per_s" + suffix, per_mv, 4 * (m * n + 2 * n),
             n=n, diagonals=m, value=prob.A.nnz / per_mv, unit="nnz/s")
    sm = make_smoother_data(prob.A, SmootherType.L1_JACOBI, w=1.0,
                            dtype=jnp.float32)
    per_sw = fori_slope(
        loop_runner(
            lambda a, s, f_, v: smooth(a, s, SmootherType.L1_JACOBI, v, f_),
            vs, sm, f, x,
        ),
        10, 210,
    )
    rec.rate("dia_sweep_nnz_per_s" + suffix, per_sw, 4 * (m * n + 4 * n),
             n=n, diagonals=m, value=prob.A.nnz / per_sw, unit="nnz/s")


def bench_elasticity(rec, nx=144, ny=18, nz=18):
    """BASELINE config 4 (157k dofs): the double-single PCG with a V(2,2)
    hybrid-JGS preconditioner on the all-DIA geometric hierarchy, and one
    V(2,2) cycle."""
    import jax.numpy as jnp

    from amg_jax.problems.elasticity import elasticity_beam
    from amg_jax.setup.structured import (
        build_dia_structured_hierarchy,
        csr_to_dia_stencil,
    )
    from amg_jax.smooth import SmootherType
    from amg_jax.solve import CycleConfig, CycleType
    from amg_jax.solve.cycles import cycle_step
    from amg_jax.solve.mixed import mixed_pcg

    prob = elasticity_beam(nx=nx, ny=ny, nz=nz, bc="identity")
    _, hier = build_dia_structured_hierarchy(
        prob.A, (nx + 1, ny + 1, nz + 1), num_functions=3,
        dtype=jnp.float32, smoother=SmootherType.HYBRID_JGS,
    )
    cfg = CycleConfig(
        cycle=CycleType.MULT, smoother=SmootherType.HYBRID_JGS,
        num_pre_sweeps=2, num_post_sweeps=2,
    )
    b = jnp.asarray(np.asarray(prob.rhs) / np.linalg.norm(prob.rhs),
                    jnp.float32)
    pair = csr_to_dia_stencil(prob.A, prob.grid_shape, jnp.float32,
                              return_lo=True)
    solve_s = []
    for _ in range(4):  # the first call compiles
        t0 = time.perf_counter()
        res = mixed_pcg(hier, pair, cfg, b, tol=1e-5, max_cycles=60)
        res.x.block_until_ready()
        solve_s.append(time.perf_counter() - t0)
    rec.emit({
        "metric": "elasticity_mixed_solve_s", "value": min(solve_s[1:]),
        "unit": "s", "timing": "best of 3 warm calls",
        "cycles": int(res.iters), "rel_res": float(res.rel_resnorm),
        "n": prob.n,
    })
    per = fori_slope(
        loop_runner(lambda h, f, v: cycle_step(h, cfg, v, f), hier, b,
                    jnp.zeros_like(b)),
        2, 22,
    )
    # per fine-level operator application the coefficient planes stream
    # once (4 sweeps + 1 residual) and each JGS sweep streams one direction
    # of the block-inverse factors; coarse levels are left out
    m = len(hier.levels[0].A.offsets)
    jgs = int(np.asarray(hier.levels[0].sm.block_inv).size) * 4
    rec.rate("elasticity_vcycle_ms", per, 5 * m * prob.n * 4 + 4 * jgs,
             n=prob.n, value=per * 1e3, unit="ms/cycle")


def bench_unstructured(rec):
    """Gather-bound SpMV of the 48x12x12 elasticity beam: ELL and 8x8 BSR
    from the generated CSR, and 8x8 BSR of the same matrix written in the
    reference's binary-triplet format and loaded back with RCM reordering."""
    import os
    import tempfile

    import jax.numpy as jnp

    from amg_jax.problems.elasticity import elasticity_beam
    from amg_jax.problems.io import problem_from_file, write_binary_triplets
    from amg_jax.sparse.bsr import bsr_from_csr
    from amg_jax.sparse.ell import ell_from_csr

    src = elasticity_beam(nx=48, ny=12, nz=12)
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "mat.bin")
        write_binary_triplets(path, src.A)
        loaded = problem_from_file(path, reorder=True)
    for name, prob, fmt in (
        ("ell_spmv_nnz_per_s", src, "ell"),
        ("bsr_spmv_nnz_per_s", src, "bsr"),
        ("file_bsr_spmv_nnz_per_s", loaded, "bsr"),
    ):
        if fmt == "ell":
            A = ell_from_csr(prob.A, dtype=jnp.float32)
            stored = A.vals.size * 8  # f32 value + i32 column per slot
        else:
            A = bsr_from_csr(prob.A, bm=8, bn=8, dtype=jnp.float32)
            stored = A.blocks.size * 4 + A.block_cols.size * 4
        x = jnp.asarray(np.random.default_rng(0).random(prob.n), jnp.float32)
        inv_norm = 1.0 / float(abs(prob.A.to_scipy()).sum(axis=1).max())
        per = fori_slope(
            loop_runner(lambda a, v: (a @ v) * inv_norm, A, x), 20, 420
        )
        rec.rate(name, per, stored + 8 * prob.n, n=prob.n,
                 nnz=prob.A.nnz, value=prob.A.nnz / per, unit="nnz/s",
                 format=fmt)


def main() -> int:
    import jax

    import amg_jax  # noqa: F401  (enables float64 before any JAX work)
    from amg_jax.dtypes import enable_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: no GPU (JAX platform {dev.platform!r})",
              file=sys.stderr)
        return 2
    rec = Recorder(
        {"platform": dev.platform, "kind": dev.device_kind,
         "count": len(jax.devices())},
        peaks_for(dev.device_kind),
        card_line(),
    )
    enable_compile_cache()
    bench_copy(rec)
    bench_vcycle(rec)
    bench_dia(rec, 144, 18, 18)
    bench_dia(rec, 192, 24, 24, suffix="_362k")
    bench_elasticity(rec)
    bench_unstructured(rec)
    bench_stencil(rec)  # the headline prints last
    return 0


if __name__ == "__main__":
    sys.exit(main())
