"""Cycle algorithms: multiplicative V-cycle and the additive family.

Native re-implementations of the reference's solver taxonomy (reference:
src/DMEM_Mult.cpp:95-261, src/DMEM_Add.cpp:180-329, src/DMEM_Smooth.cpp:574-638,
src/SMEM_Sync_AMG.cpp:8-621):

  MULT      classic multiplicative V-cycle: smooth → residual → restrict →
            … → dense coarse solve → prolong+correct → smooth (adjoint sweep).
  MULTADD   every level k computes, from the same fine residual r,
              c_k = P_0…P_{k-1} · S~_k · R_{k-1}…R_0 · r
            with S~_k one symmetrized smoother sweep (zero guess) and the
            coarsest level a direct solve; corrections are summed. The
            smoothed-interpolant variant uses P~/R~ chains with a plain sweep.
  AFACX     level k smooths at level k+1 first, prolongs, re-residualizes at
            level k and smooths there — its correction is the level-k band
            only (coarser bands come from coarser groups).
  BPX       pure additive preconditioner: one diagonal (w-Jacobi) scaling per
            level between the restrict/prolong chains.

Every level's additive correction is an independent function of r — that
independence is what the asynchronous solvers exploit (they compute c_k from
*stale* residuals; see amg_jax.solve.async_sim and amg_jax.parallel).

All functions are pure and jittable; levels are unrolled at trace time (the
hierarchy depth is static).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import jax
import jax.numpy as jnp

from amg_jax.setup.hierarchy import Hierarchy
from amg_jax.ops.vector import residual
from amg_jax.smooth import SmootherType, smooth, smooth_transpose


class CycleType(enum.Enum):
    MULT = "mult"
    MULTADD = "multadd"
    AFACX = "afacx"
    AFACJ = "afacj"
    BPX = "bpx"
    # multiplicative on levels [0, coarsest_mult_level), multadd as the
    # coarse-grid solver below (reference solver MULT_MULTADD)
    MULT_MULTADD = "mult_multadd"


@dataclass(frozen=True)
class CycleConfig:
    """Static cycle knobs (hashable; safe as a jit static argument).
    Mirrors the reference's solver flags (src/DMEM_Main.cpp:161-710)."""

    cycle: CycleType = CycleType.MULT
    smoother: SmootherType = SmootherType.L1_JACOBI
    num_pre_sweeps: int = 1
    num_post_sweeps: int = 1
    num_fine_sweeps: int = 2  # AFACx fine-level sweeps
    num_coarse_sweeps: int = 2  # AFACx coarse-level sweeps
    num_add_sweeps: int = 1  # multadd per-level sweeps
    use_smoothed_transfers: bool = False  # multadd ONE_INTERPOLANT mode
    simple_add_smoother: bool = False  # skip symmetrization (simple_jacobi)
    # MULT_MULTADD hybrid: multiplicative above this level, additive below
    # (reference -coarsest_mult_level, src/DMEM_Main.cpp:435-437,714-719;
    # the additive machinery roots its chains there via
    # finest_level = coarsest_mult_level, src/DMEM_Add.cpp:215)
    coarsest_mult_level: int = 1
    # additive cycles per coarse solve (reference -num_inner_cycles)
    num_inner_cycles: int = 2
    # AFACj ideal-interpolant depth: a chain hop at level `lvl` targeting
    # grid k uses the ideal interpolant only when k - lvl > afacj_level
    # (reference -afacj_level, default 1: `my_grid - level > afacj_level`,
    # src/DMEM_Setup.cpp:308, src/DMEM_Main.cpp:439-441)
    afacj_level: int = 1


def coarse_solve(hier: Hierarchy, r: jnp.ndarray) -> jnp.ndarray:
    """Dense inverse applied by one matmul — the counterpart of the gathered
    Gaussian elimination coarse solve (reference: src/DMEM_Mult.cpp:207).
    HIGHEST: without it a float32 product may run in TF32 on the GPU."""
    return jnp.matmul(
        hier.coarse_Ainv, r, precision=jax.lax.Precision.HIGHEST
    )


def mult_vcycle(
    hier: Hierarchy, cfg: CycleConfig, x: jnp.ndarray, b: jnp.ndarray
) -> jnp.ndarray:
    """One multiplicative V(pre,post) cycle (reference: DMEM_MultCycle,
    src/DMEM_Mult.cpp:95-261)."""
    L = hier.num_levels
    fs = [b]
    xs = [x]
    # down sweep
    for k in range(L - 1):
        lv = hier.levels[k]
        u = smooth(
            lv.A, lv.sm, cfg.smoother, xs[k], fs[k],
            num_sweeps=cfg.num_pre_sweeps, zero_guess=(k > 0),
        )
        xs[k] = u
        r = residual(lv.A, u, fs[k])
        fs.append(lv.R @ r)
        xs.append(None)  # coarse initial guess is zero (zero_guess path)
    # coarsest
    xs[L - 1] = coarse_solve(hier, fs[L - 1])
    # up sweep
    for k in reversed(range(L - 1)):
        lv = hier.levels[k]
        u = xs[k] + lv.P @ xs[k + 1]
        xs[k] = smooth_transpose(
            lv.A, lv.sm, cfg.smoother, u, fs[k], num_sweeps=cfg.num_post_sweeps
        )
    return xs[0]


def _chain_R(hier, cfg, lvl):
    lv = hier.levels[lvl]
    if cfg.use_smoothed_transfers and lv.R_s is not None:
        return lv.R_s
    return lv.R


def _chain_P(hier, cfg, lvl):
    lv = hier.levels[lvl]
    if cfg.use_smoothed_transfers and lv.P_s is not None:
        return lv.P_s
    return lv.P


def _restrict_chain(hier, cfg, r, k):
    """r_k = R_{k-1} … R_0 r (reference: src/DMEM_Add.cpp:224-255)."""
    rk = r
    for lvl in range(k):
        rk = _chain_R(hier, cfg, lvl) @ rk
    return rk


def _prolong_chain(hier, cfg, e, k):
    """c = P_0 … P_{k-1} e (reference: src/DMEM_Add.cpp:273-317)."""
    c = e
    for lvl in reversed(range(k)):
        c = _chain_P(hier, cfg, lvl) @ c
    return c


def _add_level_smooth(hier, cfg, k, rk):
    """The per-level additive smoother: one (symmetrized) sweep from zero
    guess (reference: DMEM_AddSmooth, src/DMEM_Smooth.cpp:574-638)."""
    lv = hier.levels[k]
    if cfg.simple_add_smoother or cfg.use_smoothed_transfers:
        stype = {
            SmootherType.SYM_JACOBI: SmootherType.JACOBI,
            SmootherType.SYM_L1_JACOBI: SmootherType.L1_JACOBI,
        }.get(cfg.smoother, cfg.smoother)
    else:
        stype = {
            SmootherType.JACOBI: SmootherType.SYM_JACOBI,
            SmootherType.L1_JACOBI: SmootherType.SYM_L1_JACOBI,
        }.get(cfg.smoother, cfg.smoother)
    return smooth(
        lv.A, lv.sm, stype, jnp.zeros_like(rk), rk,
        num_sweeps=cfg.num_add_sweeps, zero_guess=True,
    )


def additive_correction(
    hier: Hierarchy, cfg: CycleConfig, r: jnp.ndarray, k: int
) -> jnp.ndarray:
    """Level-k additive correction c_k(r), prolongated to level 0.

    This is the unit of work one 'grid group' owns in the reference's
    async model (reference: src/DMEM_Add.cpp:180-329); the async solvers
    evaluate it against stale residuals.
    """
    L = hier.num_levels
    cyc = cfg.cycle
    if cyc == CycleType.AFACJ:
        # AFACj (reference: DMEM_SyncAFACCycle, src/DMEM_Mult.cpp:453-612):
        # level k smooths ITS OWN chained residual; a chain hop at level lvl
        # runs through the ideal interpolant (P_array_afacj =
        # [-D_ff^-1 A_fc; I] semantics, see setup) when its distance from
        # the target grid exceeds afacj_level — the reference's
        # `my_grid - level > afacj_level` test (src/DMEM_Setup.cpp:308);
        # closer hops use the standard R/P. No AFACx re-residualization.
        if k == 0:
            e = _add_level_smooth(hier, cfg, 0, r)
            return e

        def _ideal_hop(lvl):
            lv = hier.levels[lvl]
            return k - lvl > cfg.afacj_level and lv.R_id is not None

        rk = r
        for lvl in range(k):
            lv = hier.levels[lvl]
            rk = (lv.R_id if _ideal_hop(lvl) else lv.R) @ rk
        if k == L - 1:
            e = coarse_solve(hier, rk)
        else:
            lv = hier.levels[k]
            e = smooth(
                lv.A, lv.sm, cfg.smoother,
                jnp.zeros_like(rk), rk,
                num_sweeps=cfg.num_coarse_sweeps, zero_guess=True,
            )
        c = e
        for lvl in reversed(range(k)):
            lv = hier.levels[lvl]
            c = (lv.P_id if _ideal_hop(lvl) else lv.P) @ c
        return c
    if cyc in (CycleType.MULTADD, CycleType.BPX) or k == L - 1:
        rk = _restrict_chain(hier, cfg, r, k)
        if k == L - 1:
            e = coarse_solve(hier, rk)
        elif cyc == CycleType.BPX:
            lv = hier.levels[k]
            e = lv.sm.inv_wscale * rk  # one diagonal scaling per level
        else:
            e = _add_level_smooth(hier, cfg, k, rk)
        return _prolong_chain(hier, cfg, e, k)
    if cyc == CycleType.AFACX:
        # smooth at level k+1, prolong, re-residualize at level k, smooth
        # (reference: SMEM_Sync_Parfor_AFACx_Vcycle,
        #  src/SMEM_Sync_AMG.cpp:296-406)
        rk = _restrict_chain(hier, cfg, r, k)
        rk1 = hier.levels[k].R @ rk
        lvc = hier.levels[k + 1]
        if k + 1 == L - 1:
            u_coarse = coarse_solve(hier, rk1)
        else:
            u_coarse = smooth(
                lvc.A, lvc.sm, cfg.smoother,
                jnp.zeros_like(rk1), rk1,
                num_sweeps=cfg.num_coarse_sweeps, zero_guess=True,
            )
        e = hier.levels[k].P @ u_coarse
        lv = hier.levels[k]
        r_fine = residual(lv.A, e, rk)
        u_fine = smooth(
            lv.A, lv.sm, cfg.smoother,
            jnp.zeros_like(r_fine), r_fine,
            num_sweeps=cfg.num_fine_sweeps, zero_guess=True,
        )
        return _prolong_chain(hier, cfg, u_fine, k)
    raise ValueError(f"additive_correction does not support cycle {cyc}")


def sync_additive_cycle(
    hier: Hierarchy, cfg: CycleConfig, x: jnp.ndarray, b: jnp.ndarray
) -> jnp.ndarray:
    """One synchronous additive cycle: x += sum_k c_k(b - A x)
    (reference: DMEM_SyncAdd/DMEM_SyncAddCycle, src/DMEM_Mult.cpp:263-450)."""
    A0 = hier.levels[0].A
    r = residual(A0, x, b)
    c = jnp.zeros_like(x)
    for k in range(hier.num_levels):
        c = c + additive_correction(hier, cfg, r, k)
    return x + c


def sub_hierarchy(hier: Hierarchy, start: int) -> Hierarchy:
    """View of the hierarchy rooted at level `start` (shares level pytrees;
    the coarsest dense inverse is common)."""
    return Hierarchy(levels=hier.levels[start:], coarse_Ainv=hier.coarse_Ainv)


def mult_multadd_vcycle(
    hier: Hierarchy, cfg: CycleConfig, x: jnp.ndarray, b: jnp.ndarray
) -> jnp.ndarray:
    """Multiplicative V-cycle with multadd as the coarse-grid solver below
    coarsest_mult_level — the reference's MULT_MULTADD solver ("classical
    multiplicative with multadd as coarse grid solver",
    src/DMEM_Main.cpp:847-852): the additive machinery operates on levels
    >= coarsest_mult_level (src/DMEM_Add.cpp:215), the multiplicative sweep
    above. num_inner_cycles additive cycles approximate the coarse solve."""
    import dataclasses

    L = hier.num_levels
    cml = min(max(cfg.coarsest_mult_level, 0), L - 1)
    fs = [b]
    xs = [x]
    # multiplicative down sweep on [0, cml)
    for k in range(cml):
        lv = hier.levels[k]
        u = smooth(
            lv.A, lv.sm, cfg.smoother, xs[k], fs[k],
            num_sweeps=cfg.num_pre_sweeps, zero_guess=(k > 0),
        )
        xs[k] = u
        r = residual(lv.A, u, fs[k])
        fs.append(lv.R @ r)
        xs.append(None)
    # coarse solve at level cml: num_inner_cycles synchronous additive
    # cycles on the sub-hierarchy rooted there
    sub = sub_hierarchy(hier, cml)
    inner_cfg = dataclasses.replace(cfg, cycle=CycleType.MULTADD)
    u = xs[cml] if cml == 0 else jnp.zeros_like(fs[cml])
    for _ in range(max(cfg.num_inner_cycles, 1)):
        u = sync_additive_cycle(sub, inner_cfg, u, fs[cml])
    xs[cml] = u
    # multiplicative up sweep
    for k in reversed(range(cml)):
        lv = hier.levels[k]
        u = xs[k] + lv.P @ xs[k + 1]
        xs[k] = smooth_transpose(
            lv.A, lv.sm, cfg.smoother, u, fs[k], num_sweeps=cfg.num_post_sweeps
        )
    return xs[0]


def cycle_step(hier, cfg: CycleConfig, x, b):
    """Dispatch one cycle of the configured type."""
    if cfg.cycle == CycleType.MULT:
        return mult_vcycle(hier, cfg, x, b)
    if cfg.cycle == CycleType.MULT_MULTADD:
        return mult_multadd_vcycle(hier, cfg, x, b)
    return sync_additive_cycle(hier, cfg, x, b)
