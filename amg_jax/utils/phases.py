"""Per-phase instrumentation: smooth/residual/restrict/prolong/coarse/comm.

The reference's metrics of record are per-phase wall times plus message
counts, aggregated mean/min/max (reference: src/Main.hpp:159-185,
src/DMEM_Misc.cpp:7-279, wrapped around every kernel call e.g.
src/SMEM_Sync_AMG.cpp:42-69). Inside one jitted XLA program the phases are
fused — so the instrumented mode here re-executes the cycle SEGMENTED: each
phase is its own jitted function, timed with block_until_ready, per level.
The segmented cycle computes exactly the production cycle's math (asserted
in tests); only the launch schedule differs. Halo message counts/volumes
come from the static patterns (spcomm.comm_trace — exact, not sampled).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from amg_jax.solve.cycles import (
    CycleConfig,
    CycleType,
    _add_level_smooth,
    _prolong_chain,
    _restrict_chain,
    coarse_solve,
)
from amg_jax.smooth import smooth, smooth_transpose


@dataclass
class PhaseReport:
    """Per-phase wall times (s) and counts, per level (reference fields:
    smooth/residual/restrict/prolong/coarse wtime, message counts)."""

    num_levels: int = 0
    cycles: int = 0
    smooth: list = field(default_factory=list)  # (L,) seconds
    residual: list = field(default_factory=list)
    restrict: list = field(default_factory=list)
    prolong: list = field(default_factory=list)
    coarse: float = 0.0
    vecop: float = 0.0
    comm_bytes: list = field(default_factory=list)  # (L,) per cycle
    comm_msgs: list = field(default_factory=list)

    def totals(self) -> dict:
        return {
            "smooth_wtime": float(np.sum(self.smooth)),
            "residual_wtime": float(np.sum(self.residual)),
            "restrict_wtime": float(np.sum(self.restrict)),
            "prolong_wtime": float(np.sum(self.prolong)),
            "coarse_wtime": float(self.coarse),
            "vecop_wtime": float(self.vecop),
            "comm_bytes_per_cycle": int(np.sum(self.comm_bytes)),
            "comm_msgs_per_cycle": int(np.sum(self.comm_msgs)),
        }

    def print_table(self) -> None:
        t = self.totals()
        print(
            f"per-phase wtime over {self.cycles} instrumented cycles "
            f"(s, summed over levels):"
        )
        for k in ("smooth_wtime", "residual_wtime", "restrict_wtime",
                  "prolong_wtime", "coarse_wtime", "vecop_wtime"):
            print(f"  {k:16s}: {t[k]:.6f}")
        print(
            f"  comm/cycle      : {t['comm_msgs_per_cycle']} msgs, "
            f"{t['comm_bytes_per_cycle']} bytes"
        )
        print("  per-level (smooth/residual/restrict/prolong s):")
        for k in range(self.num_levels):
            rs = self.restrict[k] if k < len(self.restrict) else 0.0
            pr = self.prolong[k] if k < len(self.prolong) else 0.0
            print(
                f"    level {k}: {self.smooth[k]:.6f} / "
                f"{self.residual[k]:.6f} / {rs:.6f} / {pr:.6f}"
            )


def _timed(fn, *args):
    out = fn(*args)
    jax.block_until_ready(out)
    return out


def _comm_stats_of(fn, *args):
    """Exact halo traffic of one traced call (bytes, messages)."""
    from amg_jax.parallel.spcomm import comm_trace

    with comm_trace() as log:
        jax.eval_shape(fn, *args)
    return int(sum(log)), len(log)


def profile_mult_cycle(
    hier, cfg: CycleConfig, b, x0=None, num_cycles: int = 5
) -> PhaseReport:
    """Segmented multiplicative V-cycle with per-phase timers — computes the
    identical iteration as solve.cycles.mult_vcycle."""
    L = hier.num_levels
    if x0 is None:
        x0 = jnp.zeros_like(b)
    rep = PhaseReport(
        num_levels=L, cycles=num_cycles,
        smooth=[0.0] * L, residual=[0.0] * L,
        restrict=[0.0] * L, prolong=[0.0] * L,
        comm_bytes=[0] * L, comm_msgs=[0] * L,
    )

    pre, post = [], []
    resid, restr, prol = [], [], []
    for k in range(L - 1):
        lv = hier.levels[k]
        pre.append(jax.jit(
            lambda u, f, lv=lv, k=k: smooth(
                lv.A, lv.sm, cfg.smoother, u, f,
                num_sweeps=cfg.num_pre_sweeps, zero_guess=(k > 0),
            )
        ))
        post.append(jax.jit(
            lambda u, f, lv=lv: smooth_transpose(
                lv.A, lv.sm, cfg.smoother, u, f,
                num_sweeps=cfg.num_post_sweeps,
            )
        ))
        resid.append(jax.jit(lambda u, f, lv=lv: f - lv.A @ u))
        restr.append(jax.jit(lambda r, lv=lv: lv.R @ r))
        prol.append(jax.jit(lambda u, e, lv=lv: u + lv.P @ e))
    coarse = jax.jit(lambda r: coarse_solve(hier, r))

    # exact comm accounting per level (independent of timing)
    for k in range(L - 1):
        z = jnp.zeros(hier.levels[k].A.shape[1], b.dtype)
        zc = jnp.zeros(hier.levels[k].P.shape_cols, b.dtype)
        by = ms = 0
        for fn, args in (
            (pre[k], (z, z)), (post[k], (z, z)), (resid[k], (z, z)),
            (restr[k], (z,)), (prol[k], (z, zc)),
        ):
            b_, m_ = _comm_stats_of(fn, *args)
            by += b_
            ms += m_
        rep.comm_bytes[k], rep.comm_msgs[k] = by, ms

    x = x0
    # warmup compile
    for k in range(L - 1):
        z = jnp.zeros(hier.levels[k].A.shape[1], b.dtype)
        zc = jnp.zeros(hier.levels[k].P.shape_cols, b.dtype)
        _timed(pre[k], z, z); _timed(post[k], z, z)
        _timed(resid[k], z, z); _timed(restr[k], z); _timed(prol[k], z, zc)
    _timed(coarse, jnp.zeros(hier.levels[L - 1].A.shape[1], b.dtype))

    for _ in range(num_cycles):
        fs = [b]
        xs = [x]
        for k in range(L - 1):
            t0 = time.perf_counter()
            u = _timed(pre[k], xs[k], fs[k])
            rep.smooth[k] += time.perf_counter() - t0
            xs[k] = u
            t0 = time.perf_counter()
            r = _timed(resid[k], u, fs[k])
            rep.residual[k] += time.perf_counter() - t0
            t0 = time.perf_counter()
            fs.append(_timed(restr[k], r))
            rep.restrict[k] += time.perf_counter() - t0
            xs.append(None)
        t0 = time.perf_counter()
        xs[L - 1] = _timed(coarse, fs[L - 1])
        rep.coarse += time.perf_counter() - t0
        for k in reversed(range(L - 1)):
            t0 = time.perf_counter()
            u = _timed(prol[k], xs[k], xs[k + 1])
            rep.prolong[k] += time.perf_counter() - t0
            t0 = time.perf_counter()
            xs[k] = _timed(post[k], u, fs[k])
            rep.smooth[k] += time.perf_counter() - t0
        x = xs[0]
    rep._x = x  # for equivalence tests
    return rep


def _additive_level_plan(hier, cfg, k):
    """Segmented step plan for level k's additive correction — the EXACT
    per-kernel decomposition of solve.cycles.additive_correction (same
    branches, same operators), so the instrumented run times the production
    algorithm. Each step is (phase, attribution_level, jitted_fn, in_keys,
    out_key); the final step writes key 'c' (the level-0 correction)."""
    L = hier.num_levels
    cyc = cfg.cycle
    if cyc == CycleType.AFACJ and k == 0:
        return [("smooth", 0, jax.jit(
            lambda r: _add_level_smooth(hier, cfg, 0, r)), ("r",), "c")]
    if cyc == CycleType.AFACJ:
        # hop-conditional ideal-interpolant chains, mirroring
        # solve.cycles.additive_correction's AFACJ branch (-afacj_level)
        def _ideal_hop(lvl, k=k):
            lv = hier.levels[lvl]
            return k - lvl > cfg.afacj_level and lv.R_id is not None

        def _rchain(r, k=k):
            rk = r
            for lvl in range(k):
                lv = hier.levels[lvl]
                rk = (lv.R_id if _ideal_hop(lvl) else lv.R) @ rk
            return rk

        def _pchain(e, k=k):
            c = e
            for lvl in reversed(range(k)):
                lv = hier.levels[lvl]
                c = (lv.P_id if _ideal_hop(lvl) else lv.P) @ c
            return c

        steps = [("restrict", k, jax.jit(_rchain), ("r",), "rk")]
        if k == L - 1:
            steps.append(("coarse", k, jax.jit(
                lambda rk: coarse_solve(hier, rk)), ("rk",), "e"))
        else:
            lv = hier.levels[k]
            steps.append(("smooth", k, jax.jit(
                lambda rk: smooth(
                    lv.A, lv.sm, cfg.smoother, jnp.zeros_like(rk), rk,
                    num_sweeps=cfg.num_coarse_sweeps, zero_guess=True,
                )), ("rk",), "e"))
        steps.append(("prolong", k, jax.jit(_pchain), ("e",), "c"))
        return steps
    if cyc in (CycleType.MULTADD, CycleType.BPX) or k == L - 1:
        steps = [("restrict", k, jax.jit(
            lambda r: _restrict_chain(hier, cfg, r, k)), ("r",), "rk")]
        if k == L - 1:
            steps.append(("coarse", k, jax.jit(
                lambda rk: coarse_solve(hier, rk)), ("rk",), "e"))
        elif cyc == CycleType.BPX:
            steps.append(("smooth", k, jax.jit(
                lambda rk: hier.levels[k].sm.inv_wscale * rk), ("rk",), "e"))
        else:
            steps.append(("smooth", k, jax.jit(
                lambda rk: _add_level_smooth(hier, cfg, k, rk)), ("rk",),
                "e"))
        steps.append(("prolong", k, jax.jit(
            lambda e: _prolong_chain(hier, cfg, e, k)), ("e",), "c"))
        return steps
    # AFACX, k < L-1: coarse smooth at k+1, prolong, re-residualize at k,
    # fine smooth, prolong chain (src/SMEM_Sync_AMG.cpp:296-406)
    lv = hier.levels[k]
    lvc = hier.levels[k + 1]
    steps = [
        ("restrict", k, jax.jit(
            lambda r: _restrict_chain(hier, cfg, r, k)), ("r",), "rk"),
        ("restrict", k, jax.jit(lambda rk: lv.R @ rk), ("rk",), "rk1"),
    ]
    if k + 1 == L - 1:
        steps.append(("coarse", k + 1, jax.jit(
            lambda rk1: coarse_solve(hier, rk1)), ("rk1",), "uc"))
    else:
        steps.append(("smooth", k + 1, jax.jit(
            lambda rk1: smooth(
                lvc.A, lvc.sm, cfg.smoother, jnp.zeros_like(rk1), rk1,
                num_sweeps=cfg.num_coarse_sweeps, zero_guess=True,
            )), ("rk1",), "uc"))
    steps += [
        ("prolong", k, jax.jit(lambda uc: lv.P @ uc), ("uc",), "e"),
        ("residual", k, jax.jit(lambda rk, e: rk - lv.A @ e), ("rk", "e"),
         "rf"),
        ("smooth", k, jax.jit(
            lambda rf: smooth(
                lv.A, lv.sm, cfg.smoother, jnp.zeros_like(rf), rf,
                num_sweeps=cfg.num_fine_sweeps, zero_guess=True,
            )), ("rf",), "uf"),
        ("prolong", k, jax.jit(
            lambda uf: _prolong_chain(hier, cfg, uf, k)), ("uf",), "c"),
    ]
    return steps


def profile_additive_cycle(
    hier, cfg: CycleConfig, b, x0=None, num_cycles: int = 5
) -> PhaseReport:
    """Segmented additive cycle (multadd/afacx/afacj/bpx): every kernel of
    additive_correction timed individually, attributed to the reference's
    phase taxonomy (restrict/smooth/residual/prolong/coarse)."""
    L = hier.num_levels
    if x0 is None:
        x0 = jnp.zeros_like(b)
    rep = PhaseReport(
        num_levels=L, cycles=num_cycles,
        smooth=[0.0] * L, residual=[0.0] * L,
        restrict=[0.0] * L, prolong=[0.0] * L,
        comm_bytes=[0] * L, comm_msgs=[0] * L,
    )
    A0 = hier.levels[0].A
    resid0 = jax.jit(lambda u, f: f - A0 @ u)
    plans = [_additive_level_plan(hier, cfg, k) for k in range(L)]

    # shape inference (drives comm accounting + warmup inputs)
    shapes = []  # per level: {key: shape}
    rspec = jax.ShapeDtypeStruct(b.shape, b.dtype)
    for k in range(L):
        env = {"r": rspec}
        for phase, lvl, fn, in_keys, out_key in plans[k]:
            env[out_key] = jax.eval_shape(fn, *(env[ik] for ik in in_keys))
        shapes.append(env)

    def zeros_of(spec):
        return jnp.zeros(spec.shape, spec.dtype)

    # exact comm accounting per level + warmup compile
    _timed(resid0, x0, b)
    for k in range(L):
        by = ms = 0
        for phase, lvl, fn, in_keys, out_key in plans[k]:
            args = tuple(zeros_of(shapes[k][ik]) for ik in in_keys)
            b_, m_ = _comm_stats_of(fn, *args)
            by += b_
            ms += m_
            _timed(fn, *args)
        rep.comm_bytes[k], rep.comm_msgs[k] = by, ms

    x = x0
    for _ in range(num_cycles):
        t0 = time.perf_counter()
        r = _timed(resid0, x, b)
        rep.residual[0] += time.perf_counter() - t0
        c = jnp.zeros_like(x)
        for k in range(L):
            env = {"r": r}
            for phase, lvl, fn, in_keys, out_key in plans[k]:
                t0 = time.perf_counter()
                env[out_key] = _timed(fn, *(env[ik] for ik in in_keys))
                dt = time.perf_counter() - t0
                if phase == "coarse":
                    rep.coarse += dt
                else:
                    getattr(rep, phase)[lvl] += dt
            c = c + env["c"]
        x = x + c
    rep._x = x
    return rep


def profile_phases(
    hier, cfg: CycleConfig, b, x0=None, num_cycles: int = 5
) -> PhaseReport:
    if cfg.cycle == CycleType.MULT:
        return profile_mult_cycle(hier, cfg, b, x0, num_cycles)
    return profile_additive_cycle(hier, cfg, b, x0, num_cycles)
