"""Asynchronous additive AMG as a bounded-staleness state machine.

The reference realizes async multigrid three ways (OpenMP races, MPI
nonblocking messages, and a sequential simulator with randomized staleness)
that share one semantic model, which its own simulator makes explicit
(reference: SEQ_Add_Vcycle_SimRand, src/SEQ_AMG.cpp:531-793):

  per global step k, each level ("grid group") independently
    - fires with some probability (rate mismatch between groups),
    - reads a STALE snapshot of the global state — solution (READ_SOL) or
      residual (READ_RES) — of age ≤ sim_read_delay, monotonically newer
      than its last read; FULL_ASYNC staleness is per-row, SEMI_ASYNC
      per-level,
    - computes its additive correction from that stale read,
  and all firing corrections are accumulated into x; grid-wait statistics
  record how many global corrections elapsed between a level's reads
  (reference: src/SMEM_Async_AMG.cpp:242-252, src/Main.hpp:356-359).

On the accelerator this state machine IS the async solver (XLA programs are bulk-
synchronous per step): the snapshot history is a ring buffer of device
arrays, staleness is explicit randomized indexing with a jax PRNG, and the
whole solve is one jitted lax.while_loop. The same model drives the
multi-chip async schedule in amg_jax.parallel.

Delay/failure injection (reference: src/Main.hpp:136-141,
src/SMEM_Main.cpp:572-596, src/SMEM_Solve.cpp:33-43) maps to per-level
firing probabilities and a transient fail window.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from amg_jax.solve.cycles import CycleConfig, additive_correction


@dataclass(frozen=True)
class AsyncConfig:
    """Static async-execution knobs (reference CLI: -sim_read_delay,
    -sim_grid_wait, async_type, res_compute aka read_type)."""

    read_type: str = "sol"  # "sol" (recompute r from stale x) | "res"
    res_mode: str = "recompute"  # "recompute" (true r each step) | "update"
    # async termination scope (reference -converge_test_type, CheckConverge
    # src/DMEM_Add.cpp:906-944): "global" — the whole program stops when the
    # global residual norm converges (2-phase done-flag lattice); "local" —
    # each grid group FREEZES as soon as ITS OWN local residual view
    # converges, and the program stops when every group has frozen. Only the
    # grid-parallel solver distinguishes them (the single-program simulator
    # has one residual view).
    converge_test_type: str = "global"  # global | local
    #   "update": the shared residual is maintained INCREMENTALLY,
    #   r -= A*(sum of applied corrections), the reference's READ_RES +
    #   LOCAL res_compute mode (src/SMEM_Async_AMG.cpp:270-302) — the
    #   maintained r drifts from the true residual exactly as in the
    #   reference; convergence is checked on the maintained r.
    async_type: str = "full"  # "full" (per-row staleness) | "semi" (per-level)
    sim_read_delay: int = 4  # staleness window in global steps
    fire_prob: float = 0.5  # per-level per-step firing probability
    # > 0: the reference's exact firing model instead of Bernoulli — each
    # level carries a countdown drawn uniformly from [0, sim_grid_wait]
    # after every apply and fires when it reaches zero (reference:
    # grid_wait_list[level] = round(RandDouble(0, sim_grid_wait)),
    # src/SEQ_AMG.cpp:260,482,552). delay_levels/delay_prob are ignored in
    # this mode (the reference's sim path has no per-level delay knob).
    sim_grid_wait: int = 0
    # Richardson under-relaxation applied to every applied correction — the
    # scalar fallback acceleration. omega = 2/(alpha+beta) from eig bounds
    # of the synchronous additive operator, damped for staleness (runner).
    omega: float = 1.0
    # The reference's ASYMMETRIC async acceleration (DMEM_ChebyUpdate,
    # src/DMEM_Misc.cpp:612-666 + the d += e receive path,
    # src/DMEM_Add.cpp:511-517): accel="cheby"|"richardson" activates it.
    # Each level group advances its OWN 3-term recurrence at its own firing
    # rate (c_prev=1, c=mu seeds, omega_k = 2 mu T_k/T_{k+1}; richardson:
    # constant omega = 2/(1+sqrt(1-mu^-2))); every group's correction is
    # scaled by omega_k*delta (raw on its first fire — the reference's
    # cycle-0 copy branch), and the cheby_grid level's group additionally
    # carries the direction vector d: its applied correction gains the
    # (omega_k - 1)*d momentum term, and d accumulates EVERY correction
    # applied to x (own transform + received ones) — so d equals the total
    # update since its last fire. mu/delta come from eig bounds of the
    # synchronous additive operator (cheby_setup), exactly as the
    # reference's ChebySetup power iteration (src/DMEM_Setup.cpp:1901-1914).
    accel: str = "none"  # none | cheby | richardson
    cheby_grid: int = 0  # level whose group keeps the 3-term direction
    cheby_mu: float = 0.0
    cheby_delta: float = 0.0
    # message coalescing: corrections are published to the SHARED state only
    # every comm_every supersteps; between publishes each level group
    # accumulates its corrections in a private pending buffer and sees them
    # in its OWN reads immediately — the reference's
    # -async_comm_save_divisor + the in-flight pool's
    # accumulate-into-pending-buffer coalescing (reference:
    # src/DMEM_Add.cpp:375-383, src/DMEM_Comm.cpp:25-79). In the
    # grid-parallel solver the publish is the cross-group psum; in the
    # single-program async solve it is the add into the shared x/snapshot.
    comm_every: int = 1
    # fault injection: levels in delay_levels fire with delay_prob instead
    delay_levels: Tuple[int, ...] = ()
    delay_prob: float = 0.5
    # transient failure: fail_level does not fire during
    # [fail_start, fail_start + fail_duration)
    fail_level: int = -1
    fail_start: int = 0
    fail_duration: int = 0


class GridWaitStats(NamedTuple):
    """Per-level staleness accounting (the async metric of record)."""

    total: jnp.ndarray  # (L,) sum of waits
    count: jnp.ndarray  # (L,) number of corrections
    min: jnp.ndarray  # (L,)
    max: jnp.ndarray  # (L,)

    def summary(self):
        import numpy as np

        cnt = np.maximum(np.asarray(self.count), 1)
        return {
            "mean": (np.asarray(self.total) / cnt).tolist(),
            "min": np.asarray(self.min).tolist(),
            "max": np.asarray(self.max).tolist(),
            "num_correct": np.asarray(self.count).tolist(),
        }


class AsyncResult(NamedTuple):
    x: jnp.ndarray
    iters: jnp.ndarray
    rel_resnorm: jnp.ndarray
    history: jnp.ndarray
    grid_wait: GridWaitStats


def _fire_probs(acfg: AsyncConfig, L: int):
    import numpy as np

    p = np.full(L, acfg.fire_prob)
    for lvl in acfg.delay_levels:
        p[lvl] = acfg.delay_prob
    return jnp.asarray(p)


def async_solve(
    hier,
    cfg: CycleConfig,
    acfg: AsyncConfig,
    b: jnp.ndarray,
    x0: Optional[jnp.ndarray] = None,
    key: Optional[jax.Array] = None,
    tol: float = 1e-8,
    max_cycles: int = 500,
) -> AsyncResult:
    """Solve A x = b with the asynchronous additive model."""
    if x0 is None:
        x0 = jnp.zeros_like(b)
    if key is None:
        key = jax.random.PRNGKey(0)
    fn = jax.jit(
        _async_loop, static_argnames=("cfg", "acfg", "tol", "max_cycles")
    )
    return fn(hier, cfg, acfg, b, x0, key, tol, max_cycles)


def _async_loop(hier, cfg, acfg, b, x0, key, tol, max_cycles):
    A0 = hier.levels[0].A
    n = b.shape[0]
    L = hier.num_levels
    W = acfg.sim_read_delay + 1  # ring buffer depth
    dtype = b.dtype
    probs = _fire_probs(acfg, L).astype(dtype)

    r0 = b - A0 @ x0
    r0norm = jnp.linalg.norm(r0)
    safe_r0 = jnp.where(r0norm == 0.0, 1.0, r0norm)

    # ring buffer of snapshots: solution or residual depending on read_type
    snap0 = x0 if acfg.read_type == "sol" else r0
    hist_ring = jnp.tile(snap0[None, :], (W, 1))
    # last read: per (level,row) in FULL mode, per level in SEMI
    last_read = jnp.zeros((L, n) if acfg.async_type == "full" else (L,), jnp.int32)
    gw0 = GridWaitStats(
        total=jnp.zeros(L, dtype),
        count=jnp.zeros(L, jnp.int32),
        min=jnp.full(L, jnp.inf, dtype),
        max=jnp.full(L, -jnp.inf, dtype),
    )
    hist0 = jnp.full((max_cycles + 1,), jnp.nan, dtype=dtype)
    hist0 = hist0.at[0].set(1.0)
    global_correct0 = jnp.zeros((), jnp.int32)

    def read_stale(ring, lr_level, k, subkey):
        """Sample snapshot indices in [max(0, k-delay, last_read), k]."""
        low = jnp.maximum(jnp.maximum(k - acfg.sim_read_delay, 0), lr_level)
        if acfg.async_type == "full":
            u = jax.random.uniform(subkey, (n,))
            col = jnp.round(low + u * (k - low)).astype(jnp.int32)
            stale = ring[col % W, jnp.arange(n)]
        else:
            u = jax.random.uniform(subkey, ())
            col = jnp.round(low + u * (k - low)).astype(jnp.int32)
            stale = ring[col % W]
        return stale, col

    E = max(int(acfg.comm_every), 1)
    accel_on = acfg.accel in ("cheby", "richardson")
    if accel_on:
        assert E == 1, "async accel does not compose with comm coalescing"
        assert acfg.cheby_mu > 1.0 and acfg.cheby_delta > 0.0, (
            "accel needs cheby_mu/cheby_delta from cheby_setup eig bounds"
        )
    cg = min(max(acfg.cheby_grid, 0), L - 1)  # reference clamps cheby_grid
    mu_s = jnp.asarray(acfg.cheby_mu if accel_on else 2.0, dtype)
    delta_s = jnp.asarray(acfg.cheby_delta, dtype)

    def body(state):
        (x, ring, lr, gw, apply_marks, gcorrect, r_state, pending, waits, k,
         relnorm, hist, key, d_dir, cheb_c, cheb_cp, cyc) = state
        key, kf, kp, *kreads = jax.random.split(key, 3 + L)
        if acfg.sim_grid_wait > 0:
            # wait-counter firing: fire when the countdown hits zero, then
            # redraw it uniformly from [0, sim_grid_wait] (the reference's
            # SEQ_Add_Vcycle_Sim grid_wait_list, src/SEQ_AMG.cpp:260,482)
            fire = waits <= 0
            redraw = jnp.round(
                jax.random.uniform(kf, (L,)) * acfg.sim_grid_wait
            ).astype(jnp.int32)
            waits = jnp.where(fire, redraw, waits - 1)
        else:
            fire = jax.random.uniform(kf, (L,), dtype) < probs
        # transient failure window
        if acfg.fail_level >= 0:
            in_window = (k >= acfg.fail_start) & (
                k < acfg.fail_start + acfg.fail_duration
            )
            fire = fire.at[acfg.fail_level].set(
                jnp.where(in_window, False, fire[acfg.fail_level])
            )

        corrections = jnp.zeros((L, n), dtype)
        new_lr = lr
        for lvl in range(L):
            stale, col = read_stale(ring, lr[lvl], k, kreads[lvl])
            new_lr = new_lr.at[lvl].set(
                jnp.where(fire[lvl], col, lr[lvl]).astype(jnp.int32)
            )
            if acfg.read_type == "sol":
                if E > 1:
                    # coalescing: a group sees its OWN unpublished pending
                    # corrections immediately (the reference's local
                    # y += U[0] before any send, src/DMEM_Add.cpp:391-458)
                    r_stale = b - A0 @ (stale + pending[lvl])
                else:
                    r_stale = b - A0 @ stale
            else:
                r_stale = stale
                if E > 1:
                    r_stale = r_stale - A0 @ pending[lvl]
            c = additive_correction(hier, cfg, r_stale, lvl)
            corrections = corrections.at[lvl].set(
                jnp.where(fire[lvl], c, jnp.zeros_like(c))
            )

        # apply in random order (order only affects grid-wait accounting —
        # the sum itself commutes); reference shuffles level_perm
        perm = jax.random.permutation(kp, L)
        if accel_on:
            # asymmetric async Chebyshev/Richardson (DMEM_ChebyUpdate,
            # src/DMEM_Misc.cpp:612-666): per-level recurrence at the
            # level's own firing rate; first fire applies raw (the cycle-0
            # copy branch); cheby_grid's fire adds the (omega-1)*d momentum
            # and d tracks the total applied update since its last fire
            # (own transform + "received" others, src/DMEM_Add.cpp:511-517)
            c_next = 2.0 * mu_s * cheb_c - cheb_cp
            if acfg.accel == "richardson":
                om = jnp.full(
                    (L,),
                    2.0 / (1.0 + (1.0 - 1.0 / (acfg.cheby_mu ** 2)) ** 0.5),
                    dtype,
                )
            else:
                om = 2.0 * mu_s * cheb_c / c_next
            first_f = cyc == 0
            lvl_scale = jnp.where(first_f, jnp.asarray(1.0, dtype), om * delta_s)
            total_c = jnp.sum(corrections * lvl_scale[:, None], axis=0)
            mom = jnp.where(
                fire[cg] & ~first_f[cg], om[cg] - 1.0, jnp.asarray(0.0, dtype)
            )
            total_c = total_c + mom * d_dir
            x = x + total_c
            d_dir = jnp.where(fire[cg], total_c, d_dir + total_c)
            adv = fire & ~first_f
            cheb_cp = jnp.where(adv, cheb_c, cheb_cp)
            cheb_c = jnp.where(adv, c_next, cheb_c)
            cyc = cyc + fire.astype(jnp.int32)
        elif E > 1:
            # accumulate into per-level pending buffers; publish into the
            # shared state every Eth superstep (message coalescing,
            # reference -async_comm_save_divisor: src/DMEM_Add.cpp:375-383)
            pending = pending + acfg.omega * corrections
            publish = ((k + 1) % E) == 0
            total_c = jnp.where(publish, jnp.sum(pending, axis=0), 0.0)
            x = x + total_c
            pending = jnp.where(publish, jnp.zeros_like(pending), pending)
        else:
            total_c = acfg.omega * jnp.sum(corrections, axis=0)
            x = x + total_c

        # grid-wait statistics, evaluated in apply order: how many global
        # corrections landed between this level's consecutive applies —
        # the reference updates last_read_correct to the global count at
        # apply time (reference: src/SMEM_Async_AMG.cpp:242-255).
        def gw_body(carry, p):
            gcount, marks, gw = carry
            lvl_fire = fire[p]
            wait = (gcount - marks[p]).astype(dtype)
            gw = GridWaitStats(
                total=gw.total.at[p].add(jnp.where(lvl_fire, wait, 0.0)),
                count=gw.count.at[p].add(jnp.where(lvl_fire, 1, 0)),
                min=gw.min.at[p].min(jnp.where(lvl_fire, wait, jnp.inf)),
                max=gw.max.at[p].max(jnp.where(lvl_fire, wait, -jnp.inf)),
            )
            marks = marks.at[p].set(jnp.where(lvl_fire, gcount, marks[p]))
            gcount = gcount + jnp.where(lvl_fire, 1, 0)
            return (gcount, marks, gw), ()

        (gcorrect, apply_marks, gw), _ = jax.lax.scan(
            gw_body, (gcorrect, apply_marks, gw), perm
        )

        if acfg.res_mode == "update":
            # incremental residual maintenance (no b - A x recompute)
            r_maint = r_state - A0 @ total_c
            relnorm = jnp.linalg.norm(r_maint) / safe_r0
            snap = x if acfg.read_type == "sol" else r_maint
        else:
            r_maint = r_state  # unused
            r_true = b - A0 @ x
            relnorm = jnp.linalg.norm(r_true) / safe_r0
            snap = x if acfg.read_type == "sol" else r_true
        hist = hist.at[k + 1].set(relnorm)
        ring = ring.at[(k + 1) % W].set(snap)
        return (
            x, ring, new_lr, gw, apply_marks, gcorrect, r_maint, pending,
            waits, k + 1, relnorm, hist, key, d_dir, cheb_c, cheb_cp, cyc,
        )

    def cond(state):
        k, relnorm = state[9], state[10]
        return (k < max_cycles) & (relnorm > tol)

    # initial wait counters: one uniform draw per level (reference seeds the
    # list before the first cycle, src/SEQ_AMG.cpp:258-261). The extra key
    # split happens ONLY in wait-counter mode so the Bernoulli RNG stream —
    # which grid_parallel_solve replicates exactly — is unchanged.
    if acfg.sim_grid_wait > 0:
        key, kw = jax.random.split(key)
        waits0 = jnp.round(
            jax.random.uniform(kw, (L,)) * acfg.sim_grid_wait
        ).astype(jnp.int32)
    else:
        waits0 = jnp.zeros(L, jnp.int32)
    state = (
        x0, hist_ring, last_read, gw0, jnp.zeros(L, jnp.int32),
        global_correct0, r0, jnp.zeros((L, n), dtype), waits0,
        jnp.asarray(0, jnp.int32), jnp.asarray(jnp.inf, dtype), hist0, key,
        jnp.zeros(n, dtype),  # cheby direction d (accel mode)
        jnp.full((L,), mu_s, dtype),  # c seeds T_1 = mu (ChebySetup)
        jnp.ones(L, dtype),  # c_prev seeds T_0 = 1
        jnp.zeros(L, jnp.int32),  # per-level cycle counts
    )
    (x, _, _, gw, _, _, _, _, _, it, relnorm, hist, _,
     _, _, _, _) = jax.lax.while_loop(cond, body, state)
    return AsyncResult(
        x=x, iters=it, rel_resnorm=relnorm, history=hist, grid_wait=gw
    )
