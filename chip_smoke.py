"""Smoke test of the solver's main paths on one NVIDIA GPU.

    python chip_smoke.py               # phases A-G on one card
    python chip_smoke.py --multichip   # the four-card paths, and only those
    python chip_smoke.py [--multichip] --phase NAME [--phase NAME ...]

Every phase drives the package through the entry point a user calls
(`amg_jax.utils.runner.run_experiment`, the engine of `python -m
amg_jax.utils.cli`) at a real size, and checks what comes out on the host in
float64 with scipy against the assembled matrix. Any failed check raises; the
script then exits non-zero and prints no result. It also exits non-zero when
JAX finds no GPU. The last line of a passing run is one JSON object:

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

Phases (one card):
  A  a GPU is present; its name and power limit (nvidia-smi).
  B  27-point Laplacian, 192^3 (7.1M unknowns), structured hierarchy,
     multiplicative V(1,1) with L1-Jacobi in float32; the 27-point matvec,
     the Jacobi sweep and the structured restrict/prolong against the host
     CSR and the assembled P/R at the same size.
  C  the same problem with -mixed_precision to 1e-8 (float32 cycles under
     float64 refinement).
  D  the Q1 elasticity beam at 362k dofs in DIA form: matvec against the
     host CSR, then the V(2,2) hybrid-JGS double-single PCG to 1e-6 (the
     double-single residual floors near 1e-7 on this beam; see PERF.md).
  E  the error-free transforms of amg_jax.ops.ds (TwoSum, TwoProd) stay
     exact on the card, and the compensated dot keeps its accuracy.
  F  algebraic classical AMG (27-point, 64^3) with -solver mult and
     -solver async_multadd.
  G  the curl-curl (Maxwell) problem with -outer_solver ams_pcg.

Four cards (--multichip), each compared with the same configuration on one
card: the row-sharded DIA elasticity solve (parallel/dist.py, 156k-dof
beam), the grid-parallel async multadd (parallel/grid.py, 27-point 128^3,
2.1M unknowns) and the grid-parallel async AMS
(solve/ams.py::ams_grid_parallel_solve, 92k edges).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import traceback

import numpy as np

# Phase sizes of the full run; the tests call the phases at small sizes.
# `expect` is the iteration count read on one H100 (float32, NVIDIA H100
# 80GB HBM3) at that size; a phase fails when its count leaves
# band(expect), so a convergence regression on the card shows here.
FULL = {
    "B": dict(n=192, expect=8),
    "C": dict(n=192, expect=18),
    "D": dict(nx=192, ny=24, nz=24, expect=14),
    "E": dict(n=1_000_000),
    "F": dict(n=64, expect={"mult": 16, "async_multadd": 107}),
    "G": dict(n=32, expect=58),
    "dist_elasticity": dict(nx=143, ny=18, nz=18, expect=40),
    "grid_multadd": dict(n=128, expect=152),
    "async_ams": dict(n=32, expect=3344),
}
SINGLE_PHASES = ("B", "C", "D", "E", "F", "G")
MULTICHIP_PHASES = ("dist_elasticity", "grid_multadd", "async_ams")
MULTICHIP_DEVICES = 4


class CheckFailed(AssertionError):
    """A phase's result disagrees with its host reference."""


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)


def band(expect: int) -> tuple:
    """Accepted iteration counts around a reading: 25% either way, and at
    least one iteration. Tighter than a convergence failure, looser than
    the few iterations a change of summation order moves."""
    m = max(1, round(0.25 * expect))
    return expect - m, expect + m


def check_band(name: str, count: int, expect: int) -> None:
    lo, hi = band(expect)
    check(lo <= count <= hi,
          f"{name}: {count} iterations outside [{lo}, {hi}] "
          f"(reading {expect})")


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def rel_diff(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-300))


def host_rel_residual(A, stats) -> float:
    """||b - A x|| / ||b|| in float64 on the host (scipy CSR)."""
    r = stats.rhs - A.to_scipy() @ stats.solution
    return float(np.linalg.norm(r) / np.linalg.norm(stats.rhs))


def _run(**kw):
    from amg_jax.utils.config import SolverOptions
    from amg_jax.utils.runner import build_problem, run_experiment

    opts = SolverOptions(**kw)
    stats = run_experiment(opts)
    return stats, build_problem(opts)


def _report(name, **vals) -> None:
    print(json.dumps({"phase": name, **vals}), flush=True)


# the double-single PCG's target on the elasticity beam (see phase_d)
DS_ELASTICITY_TOL = 1e-6

# float32 on the device: a 27-term float32 sum is accurate to a few ulps of
# its largest term, so 1e-5 norm-wise relative is a bound with margin
F32_RTOL = 1e-5


def phase_b(n: int, expect: int) -> dict:
    """27-point structured solve in float32, plus the operator checks."""
    import jax
    import jax.numpy as jnp

    from amg_jax.dtypes import default_solve_dtype
    from amg_jax.setup.structured import (
        StructuredProlong,
        StructuredRestrict,
        _structured_P_csr,
    )
    from amg_jax.smooth import SmootherType, make_smoother_data, smooth
    from amg_jax.sparse.stencil import StencilOperator

    # float32 state stagnates at a relative residual that grows like n^2
    # (CPU float32: 1.2e-5 at 64^3, 2.5e-5 at 96^3). At 192^3 one H100
    # stalls at 1.05e-4 from cycle 11 on (host residual 1.02e-4, 60
    # cycles at tol 0); 3e-4 sits ~3x above it, so the count is meaningful
    tol = 1e-5 if n <= 48 else 3e-4
    stats, prob = _run(
        problem="27pt", n=n, hierarchy="structured", solver="mult",
        smoother="l1_jacobi", tol=tol, num_cycles=60,
    )
    rel = host_rel_residual(prob.A, stats)
    # float32 iterate: the host residual may exceed the device's own f32
    # residual by its rounding, which is below the floor; 1.5x covers it
    check(rel <= 1.5 * tol, f"B: host residual {rel:.3e} > 1.5*{tol:g}")
    check_band("B", stats.cycles, expect)

    dtype = default_solve_dtype()
    rng = np.random.default_rng(0)
    A_host = prob.A.to_scipy()
    st = prob.stencil
    A_dev = StencilOperator(
        weights=jnp.asarray(np.asarray(st.weights), dtype),
        offsets=st.offsets, grid_shape=st.grid_shape,
    )
    x = rng.random(prob.n).astype(np.float32).astype(np.float64)
    y = jax.jit(lambda a, v: a @ v)(A_dev, jnp.asarray(x, dtype))
    e_mv = rel_diff(y, A_host @ x)
    check(e_mv <= F32_RTOL, f"B: matvec rel err {e_mv:.2e}")

    sm = make_smoother_data(prob.A, SmootherType.L1_JACOBI, w=0.7, dtype=dtype)
    f = rng.random(prob.n).astype(np.float32).astype(np.float64)
    u1 = jax.jit(
        lambda a, s, u_, f_: smooth(a, s, SmootherType.L1_JACOBI, u_, f_, 1)
    )(A_dev, sm, jnp.asarray(x, dtype), jnp.asarray(f, dtype))
    scale = np.asarray(sm.inv_wscale, np.float64)
    e_sw = rel_diff(u1, x + scale * (f - A_host @ x))
    check(e_sw <= F32_RTOL, f"B: Jacobi sweep rel err {e_sw:.2e}")

    fs = tuple(st.grid_shape)
    cs = tuple((s + 1) // 2 for s in fs)
    P = _structured_P_csr(fs, cs).to_scipy()
    R_dev = StructuredRestrict(fine_shape=fs, coarse_shape=cs)
    P_dev = StructuredProlong(fine_shape=fs, coarse_shape=cs)
    xc = rng.random(P.shape[1]).astype(np.float32).astype(np.float64)
    e_r = rel_diff(jax.jit(lambda v: R_dev @ v)(jnp.asarray(x, dtype)),
                   P.T @ x)
    e_p = rel_diff(jax.jit(lambda v: P_dev @ v)(jnp.asarray(xc, dtype)),
                   P @ xc)
    check(e_r <= F32_RTOL, f"B: restrict rel err {e_r:.2e}")
    check(e_p <= F32_RTOL, f"B: prolong rel err {e_p:.2e}")
    return dict(n=prob.n, cycles=stats.cycles, host_rel=rel,
                solve_s=stats.solve_wtime, setup_s=stats.setup_wtime,
                matvec_err=e_mv, sweep_err=e_sw, restrict_err=e_r,
                prolong_err=e_p)


def phase_c(n: int, expect: int) -> dict:
    """Mixed precision: float32 cycles under float64 refinement."""
    tol = 1e-8
    stats, prob = _run(
        problem="27pt", n=n, hierarchy="structured", solver="mult",
        smoother="l1_jacobi", mixed_precision=True, tol=tol, num_cycles=60,
    )
    rel = host_rel_residual(prob.A, stats)
    # the loop's residual is float64 on the device; the host's differs
    # only by summation order (~1e-16 of |A||x|, far below 1e-3 of tol)
    check(rel <= tol * 1.001, f"C: host residual {rel:.3e} > {tol:g}")
    check_band("C", stats.cycles, expect)
    return dict(n=prob.n, cycles=stats.cycles, host_rel=rel,
                solve_s=stats.solve_wtime, setup_s=stats.setup_wtime)


def phase_d(nx: int, ny: int, nz: int, expect: int) -> dict:
    """Elasticity beam in DIA form: matvec check, then the DS-PCG."""
    import jax
    import jax.numpy as jnp

    from amg_jax.dtypes import default_solve_dtype
    from amg_jax.problems.elasticity import elasticity_beam
    from amg_jax.setup.structured import csr_to_dia_stencil

    dtype = default_solve_dtype()
    prob = elasticity_beam(nx=nx, ny=ny, nz=nz, bc="identity")
    vs = csr_to_dia_stencil(prob.A, prob.grid_shape, dtype)
    x = np.random.default_rng(1).random(prob.n)
    x = x.astype(np.float32).astype(np.float64)
    y = jax.jit(lambda a, v: a @ v)(vs, jnp.asarray(x, dtype))
    e_mv = rel_diff(y, prob.A.to_scipy() @ x)
    check(e_mv <= F32_RTOL, f"D: DIA matvec rel err {e_mv:.2e}")
    del vs

    # The double-single residual is exact to ~eps32^2 * ||A|| ||x||, which
    # on this beam (kappa ~1e8) floors the refinement near 1e-7: measured
    # on the CPU, 6.9e-8 at 49k dofs and 1.6e-7 at 157k. 1e-6 sits above
    # the floor at 362k; 1e-8 needs native float64 (ROADMAP S4/D3).
    tol = DS_ELASTICITY_TOL
    stats, prob = _run(
        problem="elasticity", nx=nx, ny=ny, nz=nz, elast_bc="identity",
        hierarchy="structured", smoother="hybrid_jgs", num_smooth_sweeps=2,
        mixed_precision=True, tol=tol, num_cycles=120,
    )
    rel = host_rel_residual(prob.A, stats)
    # the DS-measured residual and the host's float64 one differ by the
    # floor above (<1e-7 of ||b||), so 1.2x covers it
    check(rel <= tol * 1.2, f"D: host residual {rel:.3e} > 1.2*{tol:g}")
    check_band("D", stats.cycles, expect)
    return dict(n=prob.n, matvec_err=e_mv, iters=stats.cycles,
                host_rel=rel, solve_s=stats.solve_wtime,
                setup_s=stats.setup_wtime)


def phase_e(n: int) -> dict:
    """Error-free transforms and the compensated dot on the device."""
    import jax
    import jax.numpy as jnp

    from amg_jax.ops.ds import DS, ds_dot, two_prod, two_sum

    rng = np.random.default_rng(0)
    a = jnp.asarray(rng.random(n), jnp.float32)
    b = jnp.asarray(rng.random(n) * 1e-6, jnp.float32)
    s, e = jax.jit(two_sum)(a, b)
    exact = np.asarray(a, np.float64) + np.asarray(b, np.float64)
    got = np.asarray(s, np.float64) + np.asarray(e, np.float64)
    check(np.array_equal(got, exact), "E: two_sum is not exact")

    a = jnp.asarray(rng.random(n) * 37.0, jnp.float32)
    b = jnp.asarray(rng.random(n), jnp.float32)
    p, e = jax.jit(two_prod)(a, b)
    exact = np.asarray(a, np.float64) * np.asarray(b, np.float64)
    got = np.asarray(p, np.float64) + np.asarray(e, np.float64)
    check(np.array_equal(got, exact), "E: two_prod is not exact")

    def to_ds(v):
        hi = v.astype(np.float32)
        return DS(hi=jnp.asarray(hi),
                  lo=jnp.asarray((v - hi.astype(np.float64)).astype(np.float32)))

    a64 = rng.standard_normal(50_000) * 1e3
    b64 = rng.standard_normal(50_000)
    want = float(a64 @ b64)
    got_dot = float(jax.jit(ds_dot)(to_ds(a64), to_ds(b64)))
    scale = float(np.abs(a64 * b64).sum())
    err = abs(got_dot - want) / scale
    # the same bound as tests/test_mixed_pcg.py::TestDSOps
    check(err < 1e-8, f"E: ds_dot error {err:.2e} of the absolute scale")
    return dict(n=n, ds_dot_err=err)


def phase_f(n: int, expect: dict) -> dict:
    """Algebraic classical AMG, synchronous and asynchronous."""
    from amg_jax.dtypes import auto_device_format

    # float32 floor at 64^3 is 1.2e-5 (the GPU's -solver mult stalls there
    # at 200 cycles); 5e-5 sits above it
    tol = 1e-5 if n <= 24 else 5e-5
    out = {"format": auto_device_format()}
    for solver, max_cycles in (("mult", 60), ("async_multadd", 600)):
        stats, prob = _run(
            problem="27pt", n=n, hierarchy="algebraic", solver=solver,
            tol=tol, num_cycles=max_cycles, seed=0,
        )
        rel = host_rel_residual(prob.A, stats)
        # float32 iterate (see phase B): 1.5x the solver's tolerance
        check(rel <= 1.5 * tol,
              f"F: {solver} host residual {rel:.3e} > 1.5*{tol:g}")
        check_band(f"F {solver}", stats.cycles, expect[solver])
        out[solver] = dict(cycles=stats.cycles, host_rel=rel,
                           solve_s=stats.solve_wtime)
    out["n"] = prob.n
    return out


def phase_g(n: int, expect: int) -> dict:
    """Curl-curl with the auxiliary-space (AMS) preconditioned CG."""
    # float32 CG: the true residual stalls near 1e-5 at n=16 (CPU float32,
    # 10.8k edges) while the recursive one keeps falling; 1e-4 at n >= 24
    # keeps the two together (8.8e-5 true at n=24)
    tol = 1e-6 if n <= 8 else 1e-4
    stats, prob = _run(
        problem="maxwell", nx=n, solver="mult", outer_solver="ams_pcg",
        tol=tol, num_cycles=200,
    )
    rel = host_rel_residual(prob.A, stats)
    check(rel <= 1.5 * tol, f"G: host residual {rel:.3e} > 1.5*{tol:g}")
    check_band("G", stats.cycles, expect)
    return dict(n=prob.n, iters=stats.cycles, host_rel=rel,
                solve_s=stats.solve_wtime)


def _compare_devices(name, tol, rel_band, expect, **kw) -> dict:
    """Run one configuration on MULTICHIP_DEVICES devices and on one, and
    check both against the host matrix and the iteration band."""
    out = {}
    for nd in (MULTICHIP_DEVICES, 1):
        stats, prob = _run(num_devices=nd, tol=tol, **kw)
        rel = host_rel_residual(prob.A, stats)
        check(rel <= rel_band * tol,
              f"{name}: {nd} device(s) host residual {rel:.3e} > "
              f"{rel_band:g}*{tol:g}")
        check_band(f"{name} on {nd} device(s)", stats.cycles, expect)
        out[nd] = dict(cycles=stats.cycles, host_rel=rel,
                       solve_s=stats.solve_wtime)
    return dict(n=prob.n, **{f"dev{k}": v for k, v in out.items()})


def phase_dist_elasticity(nx: int, ny: int, nz: int, expect: int) -> dict:
    """Row-sharded DIA elasticity (BASELINE config 4, the 156k-dof beam of
    bench.py's elasticity cell), mixed-precision PCG. nx+1 nodes must make
    n divisible by the device count, or the runner falls back to a
    replicated run."""
    n_dofs = 3 * (nx + 1) * (ny + 1) * (nz + 1)
    check(n_dofs % MULTICHIP_DEVICES == 0,
          f"dist_elasticity: {n_dofs} dofs do not divide over the devices")
    out = _compare_devices(
        "dist_elasticity", DS_ELASTICITY_TOL, 1.2, expect,
        problem="elasticity", nx=nx, ny=ny, nz=nz, elast_bc="identity",
        hierarchy="structured", smoother="hybrid_jgs", num_smooth_sweeps=2,
        mixed_precision=True, num_cycles=120,
    )
    # the same arithmetic in another order: the PCG count may move by a few
    check(abs(out["dev4"]["cycles"] - out["dev1"]["cycles"]) <= 3,
          "dist_elasticity: sharded and single-card iteration counts differ")
    return out


def phase_grid_multadd(n: int, expect: int) -> dict:
    """Level-parallel asynchronous multadd over the device mesh against the
    single-device bounded-staleness simulator."""
    # above the float32 floor, which grows like n^2: phase F's 1.2e-5 at
    # 64^3; 1.2e-4 at 128^3 (the single-device simulator on one H100 stalls
    # there after 180 cycles; four H100s reach 3e-4 at cycle 152)
    tol = 1e-5 if n <= 24 else 5e-5 if n <= 64 else 3e-4
    return _compare_devices(
        "grid_multadd", tol, 1.5, expect, problem="27pt", n=n,
        solver="async_multadd", num_cycles=600, seed=0,
    )


def phase_async_ams(n: int, expect: int) -> dict:
    """Asynchronous additive AMS: the grid-parallel engine against the
    single-device simulator."""
    # the float32 floor of phase G; at n=32 the single-device simulator
    # on one H100 takes 3344 supersteps to 1e-4 (host residual 9.9e-5)
    tol = 1e-5 if n <= 8 else 1e-4
    return _compare_devices(
        "async_ams", tol, 1.5, expect, problem="maxwell", nx=n,
        solver="async_ams", num_cycles=4500, seed=0,
    )


PHASE_FNS = {
    "B": phase_b, "C": phase_c, "D": phase_d, "E": phase_e, "F": phase_f,
    "G": phase_g, "dist_elasticity": phase_dist_elasticity,
    "grid_multadd": phase_grid_multadd, "async_ams": phase_async_ams,
}


def phases_for(multichip: bool):
    return MULTICHIP_PHASES if multichip else SINGLE_PHASES


def select_phases(multichip: bool, names=None):
    """The phases to run: the whole set of the mode, or the named ones of
    it, in the set's order."""
    every = phases_for(multichip)
    if not names:
        return every
    unknown = sorted(set(names) - set(every))
    if unknown:
        raise SystemExit(
            f"chip_smoke: {', '.join(unknown)} not among "
            f"{', '.join(every)}{' (--multichip)' if multichip else ''}")
    return tuple(p for p in every if p in names)


def run_phases(names, sizes=FULL) -> None:
    for name in names:
        t0 = time.perf_counter()
        vals = PHASE_FNS[name](**sizes[name])
        _report(name, seconds=round(time.perf_counter() - t0, 3), **vals)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument(
        "--multichip", action="store_true",
        help=f"run only the {MULTICHIP_DEVICES}-card paths",
    )
    ap.add_argument(
        "--phase", action="append", metavar="NAME",
        help="run only this phase of the chosen set (repeatable)",
    )
    args = ap.parse_args(argv)
    phases = select_phases(args.multichip, args.phase)

    import jax

    import amg_jax  # noqa: F401  (enables float64 before any JAX work)
    from amg_jax.dtypes import enable_compile_cache

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {devs[0].platform!r})",
              file=sys.stderr)
        return 2
    need = MULTICHIP_DEVICES if args.multichip else 1
    if len(devs) < need:
        print(f"chip_smoke: needs {need} GPUs, found {len(devs)}",
              file=sys.stderr)
        return 2
    enable_compile_cache()
    t0 = time.perf_counter()
    print(card_line(), flush=True)
    _report("A", seconds=round(time.perf_counter() - t0, 3),
            kind=devs[0].device_kind, count=len(devs))
    try:
        run_phases(phases)
    except Exception:
        traceback.print_exc()
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": need,
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
