"""Solve driver: tolerance loop, residual history, outer acceleration.

The native analog of the reference's solve loops (reference:
src/DMEM_Mult.cpp:13-93, src/DMEM_Add.cpp:20-178, src/SMEM_Solve.cpp:11-240):
run cycles until the relative residual 2-norm meets tol or max_cycles is hit,
recording the per-cycle residual history (the reference's -print_reshist
convergence oracle, src/SMEM_Solve.cpp:95-103).

The whole loop is one jitted lax.while_loop; the residual norm is computed on
device each cycle and the history written into a fixed-size (nan-padded)
array, so a solve is a single XLA program launch.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from amg_jax.ops.vector import residual
from amg_jax.solve.accel import (
    ChebyCoeffs,
    cheby_init,
    cheby_update,
)
from amg_jax.solve.cycles import CycleConfig, CycleType, cycle_step
from amg_jax.solve.krylov import pcg


class SolveResult(NamedTuple):
    x: jnp.ndarray
    iters: jnp.ndarray
    rel_resnorm: jnp.ndarray
    history: jnp.ndarray  # relative residual per cycle, nan-padded

    def num_iters(self) -> int:
        return int(self.iters)

    def history_list(self):
        import numpy as np

        h = np.asarray(self.history)
        return h[~np.isnan(h)].tolist()


def _solve_loop(hier, cfg: CycleConfig, b, x0, tol, max_cycles, accel,
                coeffs, no_resnorm=False):
    A0 = hier.levels[0].A
    r0 = residual(A0, x0, b)
    r0norm = jnp.linalg.norm(r0)
    safe_r0 = jnp.where(r0norm == 0.0, 1.0, r0norm)
    hist0 = jnp.full((max_cycles + 1,), jnp.nan, dtype=b.dtype)
    hist0 = hist0.at[0].set(1.0)
    cheby0 = cheby_init(b.shape[0], b.dtype)

    if no_resnorm:
        # pure-timing mode: exactly max_cycles cycles with NO per-cycle
        # residual norm (the reference's -no_resnorm,
        # src/DMEM_Main.cpp — used to measure cycle cost without the
        # norm's reduction); the true norm is computed once at the end
        def body_fixed(_, st):
            x, ch = st
            x_new = cycle_step(hier, cfg, x, b)
            if accel in ("cheby", "richardson"):
                u = x_new - x
                ch = cheby_update(
                    ch, u, coeffs, richardson=(accel == "richardson")
                )
                x_new = x + ch.d
            return (x_new, ch)

        x, _ = jax.lax.fori_loop(0, max_cycles, body_fixed, (x0, cheby0))
        relnorm = jnp.linalg.norm(residual(A0, x, b)) / safe_r0
        hist = hist0.at[max_cycles].set(relnorm)
        return SolveResult(
            x=x, iters=jnp.asarray(max_cycles, jnp.int32),
            rel_resnorm=relnorm, history=hist,
        )

    def cond(state):
        x, ch, it, relnorm, hist = state
        # divergence guard: stop once the residual has grown 1e3x above its
        # starting norm (e.g. convection-dominated problems where the cycle
        # amplifies — the reference just spins to num_cycles; we bail with
        # the diverged norm reported honestly)
        return (it < max_cycles) & (relnorm > tol) & (relnorm < 1e3)

    def body(state):
        x, ch, it, relnorm, hist = state
        x_new = cycle_step(hier, cfg, x, b)
        if accel in ("cheby", "richardson"):
            u = x_new - x  # the cycle's raw additive correction
            ch = cheby_update(ch, u, coeffs, richardson=(accel == "richardson"))
            x_new = x + ch.d
        r = residual(A0, x_new, b)
        relnorm = jnp.linalg.norm(r) / safe_r0
        hist = hist.at[it + 1].set(relnorm)
        return (x_new, ch, it + 1, relnorm, hist)

    state = (x0, cheby0, jnp.asarray(0, jnp.int32), jnp.asarray(1.0, b.dtype), hist0)
    x, _, it, relnorm, hist = jax.lax.while_loop(cond, body, state)
    return SolveResult(x=x, iters=it, rel_resnorm=relnorm, history=hist)


def solve(
    hier,
    cfg: CycleConfig,
    b: jnp.ndarray,
    x0: Optional[jnp.ndarray] = None,
    tol: float = 1e-8,
    max_cycles: int = 200,
    accel: Optional[str] = None,  # None | "cheby" | "richardson"
    cheby_coeffs: Optional[ChebyCoeffs] = None,
    outer: Optional[str] = None,  # None | "pcg"
    no_resnorm: bool = False,  # fixed max_cycles cycles, no per-cycle norm
) -> SolveResult:
    """Solve A x = b with the configured cycle (optionally accelerated or
    wrapped in PCG). Compiles once per (hierarchy shapes, cfg, options)."""
    if x0 is None:
        x0 = jnp.zeros_like(b)
    if accel in ("cheby", "richardson") and cheby_coeffs is None:
        raise ValueError("accelerated solve needs cheby_coeffs (see cheby_setup)")
    if outer == "pcg":
        # hier must be a jit *argument* (not a closure): closed-over device
        # arrays are embedded as HLO constants and shipped with the program
        res = jax.jit(
            lambda h_, b_, x0_: pcg(
                lambda v: h_.levels[0].A @ v,
                lambda r: cycle_step(h_, cfg, jnp.zeros_like(r), r),
                b_,
                x0_,
                tol=tol,
                max_iters=max_cycles,
            )
        )(hier, b, x0)
        return SolveResult(
            x=res.x, iters=res.iters, rel_resnorm=res.rel_resnorm, history=res.history
        )
    fn = jax.jit(
        _solve_loop,
        static_argnames=(
            "cfg", "tol", "max_cycles", "accel", "coeffs", "no_resnorm"
        ),
    )
    return fn(hier, cfg, b, x0, tol, max_cycles, accel, cheby_coeffs,
              no_resnorm)


def cheby_setup(
    hier, cfg: CycleConfig, num_iters: int = 20, seed: int = 0,
    method: str = "power",
) -> ChebyCoeffs:
    """Estimate eigenvalue bounds of the cycle-preconditioned operator.

    method selects the estimator (the reference's -cheby_eig menu,
    src/SMEM_Main.cpp:606-618 → CHEBY_EIG_POWER/HYPRE_LOBPCG/SLEPC):
      power   — power + shifted power (reference ChebySetup →
                DMEM_PowerMult, src/DMEM_Eig.cpp:10-104)
      lobpcg  — block LOBPCG Rayleigh-Ritz (reference hypre_lobpcg,
                src/SMEM_Cheby.cpp:255-408)
      lanczos — Lanczos extreme Ritz values (the Krylov analog of the
                reference's SLEPc Arnoldi path, src/SMEM_Cheby.cpp:62-200)
    """
    from amg_jax.solve.accel import (
        estimate_cycle_eigs,
        estimate_eigs_lanczos,
        estimate_eigs_lobpcg,
    )

    A0 = hier.levels[0].A
    n = A0.shape[0]
    dtype = hier.levels[0].sm.inv_wscale.dtype

    def apply_MinvA(u):
        f = A0 @ u
        return cycle_step(hier, cfg, jnp.zeros_like(f), f)

    if method == "lobpcg":
        return estimate_eigs_lobpcg(
            apply_MinvA, n, dtype, num_iters=max(num_iters // 2, 6),
            seed=seed,
        )
    if method == "lanczos":
        return estimate_eigs_lanczos(
            apply_MinvA, n, dtype, num_iters=num_iters, seed=seed
        )
    if method != "power":
        raise ValueError(f"unknown cheby_eig method {method!r}")
    return estimate_cycle_eigs(apply_MinvA, n, dtype, num_iters=num_iters, seed=seed)
