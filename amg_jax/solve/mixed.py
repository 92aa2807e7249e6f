"""Mixed-precision iterative refinement: f32 cycles under an f64 outer loop.

Pure-f32 V-cycles stagnate near relative residual ~1e-5/1e-6 (roundoff
floor), but the reference's convergence targets are 1e-8 in double
(everything in the reference is C++ double). Iterative refinement is the
standard mixed-precision MG construction:

    x (f64);  repeat:  r = b - A x   (f64 fine-grid residual)
                       e = V_32(r)   (one f32 V-cycle from zero guess)
                       x += e        (f64 accumulation)

The contraction rate is the f32 cycle's rate until the f64 floor, while all
per-cycle heavy lifting runs at f32 width (f64 appears only in one residual
+ axpy per cycle).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from amg_jax.solve.cycles import CycleConfig, cycle_step


class MixedSolveResult(NamedTuple):
    x: jnp.ndarray  # f64, or the f32 hi part of a double-single iterate
    iters: jnp.ndarray
    rel_resnorm: jnp.ndarray
    history: jnp.ndarray
    x_lo: Optional[jnp.ndarray] = None  # double-single low part

    def num_iters(self) -> int:
        return int(self.iters)

    def history_list(self):
        import numpy as np

        h = np.asarray(self.history)
        return h[~np.isnan(h)].tolist()


def mixed_solve(
    hier32,
    A64,
    cfg: CycleConfig,
    b: jnp.ndarray,
    x0: Optional[jnp.ndarray] = None,
    tol: float = 1e-8,
    max_cycles: int = 200,
) -> MixedSolveResult:
    """Solve A x = b to ~f64 accuracy with f32 cycles.

    hier32: hierarchy built with dtype=float32; A64: fine operator with
    f64 weights, against which the outer residual is taken."""
    b = jnp.asarray(b).astype(jnp.float64)
    if x0 is None:
        x0 = jnp.zeros_like(b)
    x0 = jnp.asarray(x0).astype(jnp.float64)
    fn = jax.jit(_loop_f64, static_argnames=("cfg", "tol", "max_cycles"))
    return fn(hier32, A64, cfg, b, x0, tol, max_cycles)


def _ds_true_residual(A_acc, b_ds, x_ds):
    """Jitted compensated true residual r = b - A x in double-single."""
    from amg_jax.ops.ds import ds_residual, ds_to_float

    r = ds_residual(A_acc, b_ds, x_ds)
    return r, jnp.linalg.norm(ds_to_float(r))


def mixed_pcg(
    hier32,
    A_acc,
    cfg: CycleConfig,
    b: jnp.ndarray,
    x0: Optional[jnp.ndarray] = None,
    tol: float = 1e-5,
    max_cycles: int = 120,
    inner_tol: float = 2.5e-2,
    inner_iters: Optional[int] = None,
    A_inner=None,
    fused: Optional[bool] = None,
) -> MixedSolveResult:
    """Mixed-precision AMG-PCG: double-single iterative refinement around
    AMG-preconditioned PCG whose matvec applies the DS operator pair.

    On severely ill-conditioned operators (the 157k-dof elasticity beam,
    kappa ~ 1e8: f32 PCG stalls at relative residual ~1e-1 while f64 PCG
    converges in ~19 iterations — reference outer loop:
    src/DMEM_Mult.cpp:13-93 with hypre PCG,
    src/DMEM_Setup.cpp:129-167), two separate f32 rounding effects block
    convergence to 1e-5:
      (a) the Krylov recurrences' vector roundoff: with kappa*eps_f32 >~ 1
          even the FIRST f32 correction has no correct digits, so neither
          plain f32 PCG nor f32-inner refinement can converge — cured by
          running the inner PCG entirely in DOUBLE-SINGLE state
          (krylov.ds_pcg: DS x/r/p, compensated axpys and dots);
      (b) the OPERATOR's own f32 coefficient rounding (1e-7 relative per
          entry): an inner solve against the rounded operator stagnates at
          ||dA||*||x|| — cured by applying the operator as a DOUBLE-SINGLE
          COEFFICIENT PAIR (A_hi, A_lo) inside ds_pcg's matvec
          (ops/ds.py::ds_matvec), accurate to ~1e-14.
    The preconditioner (one f32 V-cycle on hier32) needs neither fix —
    its quality only affects the iteration count, never the attainable
    accuracy. The outer refinement loop remains as a cheap safety wrapper
    (DS-measured true residual, restart on leftover gap).

        x (double-single); repeat:
            r  = b - A x            (compensated DS residual, ops/ds.py,
                                     using the (A_hi, A_lo) pair)
            e  = ds_pcg(A, M=V-cycle_f32, r)   to inner_tol
            x += e                  (DS accumulation)

    A_acc: operator for the accurate outer residual and inner matvec — an
    (A_hi, A_lo) pair (preferred; each supporting the compensated matvec
    dispatch of ops/ds.py: VarStencilOperator / ELL / BSR /
    StencilOperator) or a single operator (then accuracy is wrt the
    rounded operator). A_inner: optional override pair for the inner
    matvec; defaults to A_acc.
    The same DS implementation runs on every platform, so the CPU tests
    exercise the device code path exactly.

    fused=None asks the platform policy (amg_jax.dtypes): on the GPU the
    WHOLE refinement runs as ONE jitted program (outer lax.while_loop
    around the inner ds_pcg while_loop) — identical restart/stagnation
    logic, one launch instead of ~2 per restart; the history then carries
    one point per restart instead of per iteration. The CPU runs the
    unfused loop (detailed stitched history — what the goldens pin).
    """
    import numpy as np

    from amg_jax.ops.ds import DS, ds_add
    from amg_jax.solve.cycles import cycle_step
    from amg_jax.solve.krylov import ds_pcg

    if A_inner is None:
        A_inner = A_acc
    b64 = np.asarray(b, dtype=np.float64)
    b_ds = DS(
        hi=jnp.asarray(b64.astype(np.float32)),
        lo=jnp.asarray((b64 - b64.astype(np.float32)).astype(np.float32)),
    )
    if x0 is None:
        x_ds = DS(hi=jnp.zeros_like(b_ds.hi), lo=jnp.zeros_like(b_ds.hi))
    else:
        x64 = np.asarray(x0, dtype=np.float64)
        xh = x64.astype(np.float32)
        x_ds = DS(hi=jnp.asarray(xh),
                  lo=jnp.asarray((x64 - xh).astype(np.float32)))
    if inner_iters is None:
        inner_iters = max(8, min(40, max_cycles // 3))
    if fused is None:
        from amg_jax.dtypes import mixed_pcg_single_program

        fused = mixed_pcg_single_program()
    if fused:
        fn = jax.jit(
            _mixed_pcg_fused_loop,
            static_argnames=("cfg", "tol", "max_cycles", "inner_tol",
                             "inner_iters"),
        )
        x, x_lo, total, rel, hist = fn(
            hier32, A_acc, A_inner, cfg, b_ds, x_ds, tol, max_cycles,
            inner_tol, inner_iters,
        )
        return MixedSolveResult(
            x=x, iters=total, rel_resnorm=rel, history=hist, x_lo=x_lo
        )

    def _inner(h_, Ai_, r_ds):
        zero = DS(jnp.zeros_like(r_ds.hi), jnp.zeros_like(r_ds.hi))
        return ds_pcg(
            Ai_,
            lambda rr: cycle_step(h_, cfg, jnp.zeros_like(rr), rr),
            r_ds,
            zero,
            tol=inner_tol,
            max_iters=inner_iters,
        )

    inner = jax.jit(_inner)
    tres = jax.jit(_ds_true_residual)
    r, rn = tres(A_acc, b_ds, x_ds)
    r0n = float(rn)
    safe_r0 = r0n if r0n > 0.0 else 1.0
    rel = r0n / safe_r0  # 1.0 (or 0 for zero RHS)
    hist = [1.0]
    total = 0
    while rel > tol and total < max_cycles:
        res = inner(hier32, A_inner, r)
        x_ds = ds_add(x_ds, DS(hi=res.x[0], lo=res.x[1]))
        total += int(res.iters)
        # inner per-iteration history, rescaled to the OUTER residual norm
        # (drop the leading 1.0 — it duplicates the previous outer point)
        inner_h = np.asarray(res.history)
        inner_h = inner_h[~np.isnan(inner_h)][1:]
        prev_rel = rel
        r, rn = tres(A_acc, b_ds, x_ds)
        rel = float(rn) / safe_r0
        if inner_h.size:
            # inner history is relative to its own r0 = the outer residual,
            # so outer-relative = inner_h * prev_rel; the final point is
            # replaced by the DS-measured outer rel (the honest number)
            hist.extend(float(v) * prev_rel for v in inner_h[:-1])
        hist.append(rel)
        if rel > 0.9 * prev_rel:
            break  # refinement stagnated: report honestly
    h = np.full(max_cycles + 1, np.nan, dtype=np.float32)
    h[: min(len(hist), max_cycles + 1)] = hist[: max_cycles + 1]
    return MixedSolveResult(
        x=x_ds.hi,
        iters=jnp.asarray(total, jnp.int32),
        rel_resnorm=jnp.asarray(rel, jnp.float32),
        history=jnp.asarray(h),
        x_lo=x_ds.lo,
    )


def _mixed_pcg_fused_loop(
    hier32, A_acc, A_inner, cfg, b_ds, x0_ds, tol, max_cycles,
    inner_tol, inner_iters,
):
    """Single-program mixed_pcg: outer DS-refinement lax.while_loop around
    the inner ds_pcg while_loop — the same restart/stagnation semantics
    as the unfused host loop, one device launch total."""
    from amg_jax.ops.ds import DS, ds_add, ds_residual, ds_to_float
    from amg_jax.solve.cycles import cycle_step
    from amg_jax.solve.krylov import ds_pcg

    f32 = jnp.float32
    r0 = ds_residual(A_acc, b_ds, x0_ds)
    r0n = jnp.linalg.norm(ds_to_float(r0))
    safe_r0 = jnp.where(r0n == 0.0, f32(1.0), r0n)
    max_outer = max(2, -(-max_cycles // max(inner_iters, 1)) + 1)
    hist0 = jnp.full((max_outer + 1,), jnp.nan, dtype=f32)
    hist0 = hist0.at[0].set(1.0)

    def cond(st):
        x, r, rel, prev_rel, total, o, hist = st
        return (
            (total < max_cycles) & (rel > tol) & (rel <= 0.9 * prev_rel)
        )

    def body(st):
        x, r, rel, prev_rel, total, o, hist = st
        zero = DS(jnp.zeros_like(r.hi), jnp.zeros_like(r.hi))
        res = ds_pcg(
            A_inner,
            lambda rr: cycle_step(hier32, cfg, jnp.zeros_like(rr), rr),
            r,
            zero,
            tol=inner_tol,
            max_iters=inner_iters,
        )
        x = ds_add(x, DS(hi=res.x[0], lo=res.x[1]))
        r_new = ds_residual(A_acc, b_ds, x)
        rel_new = jnp.linalg.norm(ds_to_float(r_new)) / safe_r0
        hist = hist.at[o + 1].set(rel_new)
        return (x, r_new, rel_new, rel, total + res.iters, o + 1, hist)

    st0 = (
        x0_ds, r0, r0n / safe_r0, jnp.asarray(jnp.inf, f32),
        jnp.asarray(0, jnp.int32), jnp.asarray(0, jnp.int32), hist0,
    )
    x, _, rel, _, total, _, hist = jax.lax.while_loop(cond, body, st0)
    return x.hi, x.lo, total, rel, hist


def _loop_f64(hier32, A64, cfg, b, x0, tol, max_cycles):
    r0 = b - A64 @ x0
    r0n = jnp.linalg.norm(r0)
    safe_r0 = jnp.where(r0n == 0.0, 1.0, r0n)
    hist0 = jnp.full((max_cycles + 1,), jnp.nan, dtype=jnp.float64)
    hist0 = hist0.at[0].set(1.0)

    def body(state):
        x, k, relnorm, hist = state
        r = b - A64 @ x
        r32 = r.astype(jnp.float32)
        e32 = cycle_step(hier32, cfg, jnp.zeros_like(r32), r32)
        x = x + e32.astype(jnp.float64)
        r_new = b - A64 @ x
        relnorm = jnp.linalg.norm(r_new) / safe_r0
        hist = hist.at[k + 1].set(relnorm)
        return (x, k + 1, relnorm, hist)

    def cond(state):
        _, k, relnorm, _ = state
        return (k < max_cycles) & (relnorm > tol)

    state = (x0, jnp.asarray(0, jnp.int32), jnp.asarray(jnp.inf, jnp.float64), hist0)
    x, it, relnorm, hist = jax.lax.while_loop(cond, body, state)
    return MixedSolveResult(x=x, iters=it, rel_resnorm=relnorm, history=hist)
