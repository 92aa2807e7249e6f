"""Grid (level) parallelism mapped to device groups — the reference's core
distributed design, realized on a jax device mesh.

The reference splits MPI ranks into per-level communicators sized by a work
model; each "grid group" redundantly owns its restricted operators and runs
its additive cycle at its own rate, exchanging corrections through
ACCUMULATE messages and terminating through a done-flag lattice fused into
the residual-norm allreduce (reference: AssignProcs
src/DMEM_Setup.cpp:1638-1759; DMEM_Add src/DMEM_Add.cpp:20-178;
InnerProdFlag src/DMEM_Misc.cpp:414-433).

Realization (this module): one `shard_map` over a 1-D mesh.

  * level→device assignment comes from the same work model
    (amg_jax.parallel.partition.compute_level_work / assign_levels_to_devices);
  * each device evaluates ONLY its assigned levels' additive corrections —
    a `lax.switch` on `axis_index` whose branch d contains exactly device
    d's levels, so the compiled program runs (and spends FLOPs on) just the
    selected branch;
  * the correction exchange is one `lax.psum` of the partial corrections —
    the ACCUMULATE channel, ridden over the interconnect (NCCL on GPUs);
  * termination is a fused (residual-norm partial, done-flag) `lax.psum` of
    a stacked 2-vector per superstep — the InnerProdFlag analog: each
    device contributes its row-range partial of ||r||^2 and its own done
    flag, and the loop exits when the summed flags reach the device count;
  * asynchrony is the bounded-staleness model of amg_jax.solve.async_sim,
    with an IDENTICAL PRNG stream — per-level firing draws and stale-read
    columns are replicated scalars/vector draws, while the expensive reads
    and corrections happen only on the owning device. A grid-parallel solve
    therefore reproduces the async simulator's iterates to roundoff
    (tested), while distributing the per-level work.

Operator storage is OWNED, not replicated (round-4): each device's shard of
a device-major coefficient pool carries exactly the leaves its branch
touches — its assigned levels' A/smoother arrays plus the transfer chain
down to its deepest level — so per-device operator bytes track the
assignment instead of the full hierarchy (the reference's redistributed
gridk ownership: each grid group holds only its own A_k/P_k copies,
src/DMEM_Setup.cpp:216-334). The fine-grid operator alone stays replicated:
every group owns a fine-matrix copy in the reference too (the LOCAL_RES
residual A_gridk, src/DMEM_Add.cpp:530-556). The row-sharded path
(amg_jax.parallel.dist) is the orthogonal within-level axis.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from amg_jax.parallel.partition import (
    assign_levels_to_devices,
    compute_level_work,
)
from amg_jax.solve.async_sim import (
    AsyncConfig,
    AsyncResult,
    GridWaitStats,
    _fire_probs,
)
from amg_jax.setup.hierarchy import Hierarchy, Level
from amg_jax.solve.cycles import CycleConfig, CycleType, additive_correction


def plan_grid_levels(
    hh, num_devices: int, async_mode: bool = True, imbalance: float = 0.0,
    smoothed_transfers: bool = False,
    assign_policy: str = "balanced", assign_scalar: float = 0.5,
):
    """Work-model level→device plan. Returns (assignment, levels_of, scale)
    where levels_of[d] is the tuple of levels device d computes and
    scale[k] = 1/(group size of level k) so groups that share a level
    contribute it exactly once after the psum (the reference's within-group
    row partition collapses to redundant compute + scaling here)."""
    work = compute_level_work(
        hh, async_mode=async_mode, imbalance=imbalance,
        smoothed_transfers=smoothed_transfers,
    )
    assignment = assign_levels_to_devices(
        work, num_devices, policy=assign_policy, scalar=assign_scalar
    )
    levels_of = [[] for _ in range(num_devices)]
    L = len(assignment)
    scale = np.zeros(L)
    for k, (s, e) in enumerate(assignment):
        e = max(e, s + 1)
        scale[k] = 1.0 / (e - s)
        for d in range(s, min(e, num_devices)):
            levels_of[d].append(k)
    return assignment, tuple(tuple(ls) for ls in levels_of), scale


_LEVEL_TRANSFER_FIELDS = ("P", "R", "P_s", "R_s", "R_inj", "P_id", "R_id")


def _keep_fields(my_levels, L, cfg: CycleConfig):
    """The (level, field) operator leaves the device owning `my_levels`
    touches inside its correction branch: additive_correction walks the
    R/P transfer chain down to its deepest level and smooths there (AFACx
    additionally smooths at level k+1; the coarsest owner needs the dense
    inverse). The fine operator is excluded — it is passed replicated,
    every group owning a fine-matrix copy exactly as the reference's
    LOCAL_RES design (src/DMEM_Add.cpp:530-556)."""
    owned = set(my_levels)
    if not owned:  # a device with no levels touches no operators
        return set()
    if cfg.cycle == CycleType.AFACX:
        owned |= {min(k + 1, L - 1) for k in my_levels}
    deepest = max(owned)
    # only the transfer variants this config's additive_correction walks:
    # MULTADD/BPX chains pick R_s/P_s when use_smoothed_transfers (falling
    # back per level to R/P), AFACj mixes R/P with the ideal interpolants,
    # AFACx uses the raw chain plus its own level's R/P
    if cfg.cycle == CycleType.AFACJ:
        fields = ("P", "R", "P_id", "R_id")
    elif cfg.use_smoothed_transfers:
        fields = ("P", "R", "P_s", "R_s")
    else:
        fields = ("P", "R")
    keep = set()
    for j in range(deepest):
        for f in fields:
            keep.add((j, f))
    if cfg.cycle == CycleType.AFACX:
        # within-level R/P hop at each owned level k
        for k in my_levels:
            keep.add((k, "P"))
            keep.add((k, "R"))
    for k in owned:
        keep.add((k, "A"))
        keep.add((k, "sm"))
    keep.discard((0, "A"))
    if (L - 1) in owned:
        keep.add(("coarse", "Ainv"))
    return keep


def pack_device_pools(field_rows):
    """Generic device-major pooled storage: field_rows[d] maps a field key
    to the pytree device d owns. Packs each device's leaves into one flat
    buffer per dtype; rows pad to the max packed length and stack into
    (D, Lmax) pools whose leading axis shards over the mesh — per-device
    allocation = max_d(owned bytes) instead of full replication (the
    redistributed gridk ownership of the reference,
    src/DMEM_Setup.cpp:216-334).

    Returns (pools, metas, owned_bytes): pools maps dtype-name to a
    (D, Lmax) jnp array; metas[d] maps field key -> (treedef, leaf specs)
    for reconstruction; owned_bytes[d] is the exact per-device packed
    byte count (for memory-scaling assertions)."""
    from jax.tree_util import tree_flatten

    D = len(field_rows)
    metas, rows = [], []
    for d in range(D):
        offs, bufs, meta = {}, {}, {}
        for key in sorted(field_rows[d], key=str):
            sub = field_rows[d][key]
            if sub is None:
                continue
            leaves, treedef = tree_flatten(sub)
            specs = []
            for leaf in leaves:
                a = np.asarray(leaf)
                dt = str(a.dtype)
                off = offs.get(dt, 0)
                bufs.setdefault(dt, []).append(a.reshape(-1))
                specs.append((dt, off, a.shape))
                offs[dt] = off + a.size
            meta[key] = (treedef, specs)
        metas.append(meta)
        rows.append(
            {dt: np.concatenate(v) for dt, v in bufs.items()}
        )
    dtypes = sorted({dt for r in rows for dt in r})
    pools = {}
    for dt in dtypes:
        lmax = max((r[dt].size if dt in r else 0) for r in rows)
        mat = np.zeros((D, max(lmax, 1)), dtype=dt)
        for d, r in enumerate(rows):
            if dt in r:
                mat[d, : r[dt].size] = r[dt]
        pools[dt] = jnp.asarray(mat)
    owned_bytes = [
        sum(r[dt].size * np.dtype(dt).itemsize for dt in r) for r in rows
    ]
    return pools, metas, owned_bytes


def pool_field(meta, pool_row, key):
    """Rebuild one packed field from a device's local pool row (static
    slices); returns None for fields outside the device's keep set, so an
    out-of-set access is a loud tracing error rather than silently
    reading another device's data."""
    from jax.tree_util import tree_unflatten

    if key not in meta:
        return None
    treedef, specs = meta[key]
    leaves = [
        pool_row[dt][off : off + int(np.prod(shape, dtype=np.int64))]
        .reshape(shape)
        for dt, off, shape in specs
    ]
    return tree_unflatten(treedef, leaves)


def build_grid_owned_storage(hier, levels_of, cfg: CycleConfig):
    """Hierarchy-specific owned storage: per device, exactly the leaves
    its correction branch touches (_keep_fields). See pack_device_pools."""
    L = hier.num_levels
    field_rows = []
    for d in range(len(levels_of)):
        keep = _keep_fields(levels_of[d], L, cfg)
        if cfg.use_smoothed_transfers and cfg.cycle in (
            CycleType.MULTADD, CycleType.BPX
        ):
            # the chain takes R_s/P_s wherever present; the raw fallback
            # is only needed on levels without a smoothed transfer
            for lvl, f in list(keep):
                if f == "R" and getattr(hier.levels[lvl], "R_s", None) is not None:
                    keep.discard((lvl, "R"))
                if f == "P" and getattr(hier.levels[lvl], "P_s", None) is not None:
                    keep.discard((lvl, "P"))
        row = {}
        for key in keep:
            if key == ("coarse", "Ainv"):
                row[key] = hier.coarse_Ainv
            else:
                lvl, f = key
                row[key] = getattr(hier.levels[lvl], f)
        field_rows.append(row)
    return pack_device_pools(field_rows)


def _reconstruct_view(L, meta, pool_row, A0):
    """Rebuild one device's hierarchy view from its local pool row (see
    pool_field)."""

    def field(key):
        return pool_field(meta, pool_row, key)

    levels = []
    for lvl in range(L):
        kw = {f: field((lvl, f)) for f in _LEVEL_TRANSFER_FIELDS}
        levels.append(
            Level(
                A=A0 if lvl == 0 else field((lvl, "A")),
                sm=field((lvl, "sm")),
                **kw,
            )
        )
    return Hierarchy(
        levels=tuple(levels), coarse_Ainv=field(("coarse", "Ainv"))
    )


def _stale_read_cols(acfg: AsyncConfig, n, lr_level, k, subkey):
    """Replicated stale-read column draw — the exact RNG consumption of
    async_sim.read_stale (per-row in FULL mode, scalar in SEMI)."""
    low = jnp.maximum(jnp.maximum(k - acfg.sim_read_delay, 0), lr_level)
    if acfg.async_type == "full":
        u = jax.random.uniform(subkey, (n,))
    else:
        u = jax.random.uniform(subkey, ())
    return jnp.round(low + u * (k - low)).astype(jnp.int32)


def _gather_stale(acfg: AsyncConfig, ring, cols, n):
    W = acfg.sim_read_delay + 1
    if acfg.async_type == "full":
        return ring[cols % W, jnp.arange(n)]
    return ring[cols % W]


def grid_parallel_solve(
    hier,
    cfg: CycleConfig,
    acfg: AsyncConfig,
    levels_of: Sequence[Sequence[int]],
    level_scale,
    mesh: Mesh,
    b: jnp.ndarray,
    x0: Optional[jnp.ndarray] = None,
    key: Optional[jax.Array] = None,
    tol: float = 1e-8,
    max_cycles: int = 500,
) -> AsyncResult:
    """Asynchronous additive solve with level parallelism over the mesh.

    Semantically identical to amg_jax.solve.async_sim.async_solve with the
    same (acfg, key) — the PRNG stream is mirrored — but each device
    computes only `levels_of[device]`'s corrections (reference:
    src/DMEM_Add.cpp:180-329 per-grid AddCycle)."""
    if x0 is None:
        x0 = jnp.zeros_like(b)
    if key is None:
        key = jax.random.PRNGKey(0)
    axis = mesh.axis_names[0]
    D = mesh.devices.size
    assert len(levels_of) == D, "one level set per mesh device"
    if acfg.comm_every > 1:
        assert acfg.read_type == "sol" and acfg.res_mode == "recompute", (
            "message coalescing (comm_every>1) supports READ_SOL/recompute"
        )
    local_conv = acfg.converge_test_type == "local"
    if local_conv:
        assert acfg.res_mode == "recompute", (
            "local convergence needs each device's own residual view "
            "(res_mode='recompute')"
        )
    accel_on = acfg.accel in ("cheby", "richardson")
    if accel_on:
        assert acfg.comm_every == 1, (
            "async accel does not compose with comm coalescing"
        )
        assert not local_conv, "async accel needs global convergence"
        assert acfg.cheby_mu > 1.0 and acfg.cheby_delta > 0.0, (
            "accel needs cheby_mu/cheby_delta from cheby_setup eig bounds"
        )
    L = hier.num_levels
    n = b.shape[0]
    dtype = b.dtype
    W = acfg.sim_read_delay + 1
    probs = _fire_probs(acfg, L).astype(dtype)
    scale = jnp.asarray(level_scale, dtype)
    cg = min(max(acfg.cheby_grid, 0), L - 1)
    mu_s = jnp.asarray(acfg.cheby_mu if accel_on else 2.0, dtype)
    delta_s = jnp.asarray(acfg.cheby_delta, dtype)
    n_pad = -(-n // D) * D  # fused-norm partials use a (D, n_pad/D) view

    # owned operator storage: device-major pools sharded over the mesh —
    # only the fine operator rides in replicated (every group holds a
    # fine-matrix copy in the reference's LOCAL_RES design too)
    pools, metas, _ = build_grid_owned_storage(hier, levels_of, cfg)
    A0_rep = hier.levels[0].A

    def solve_body(A0, pools_, b_, x0_, key_):
        d = jax.lax.axis_index(axis)
        pool_row = {dt: pools_[dt][0] for dt in pools_}

        def norm_partial(r):
            """This device's row-range partial of ||r||^2."""
            r2 = jnp.pad(r * r, (0, n_pad - n)).reshape(D, n_pad // D)
            return jax.lax.dynamic_slice_in_dim(r2, d, 1, 0).sum()

        def fused_norm_flags(r, flag):
            """ONE psum carrying (norm partial, done flag) — the reference's
            InnerProdFlag (src/DMEM_Misc.cpp:414-433): the flag lattice
            rides the residual-norm reduction."""
            stats = jax.lax.psum(
                jnp.stack([norm_partial(r), flag]), axis
            )
            return stats[0], stats[1]

        def level_correction(hview, ring, cols, fire_lvl, lvl, c_pend, ls):
            """Owner-only work: stale read (+ stale residual) + correction.
            The device's own pending (not-yet-exchanged) corrections are
            visible in its own reads — the reference applies its corrections
            to its local x every cycle and ships them every Nth
            (src/DMEM_Add.cpp:391-458). `ls` is the per-level accel scale
            (omega_k*delta from the level's own recurrence; 1.0 without
            accel — see the DMEM_ChebyUpdate analog below)."""
            stale = _gather_stale(acfg, ring, cols, n)
            if acfg.read_type == "sol":
                r_stale = b_ - A0 @ (stale + acfg.omega * c_pend)
            else:
                r_stale = stale
            c = (ls[lvl] * scale[lvl]) * additive_correction(
                hview, cfg, r_stale, lvl
            )
            return jnp.where(fire_lvl, c, jnp.zeros_like(c))

        def make_branch(d_idx, my_levels):
            def branch(op):
                # this device's hierarchy view, sliced from ITS pool shard
                hview = _reconstruct_view(L, metas[d_idx], pool_row, A0)
                ring, cols_all, fire, c_pend, ls = op
                c = jnp.zeros(n, dtype)
                for lvl in my_levels:
                    c = c + level_correction(
                        hview, ring, cols_all[lvl], fire[lvl], lvl, c_pend,
                        ls,
                    )
                # normalize the varying-manual-axes type: a device with no
                # assigned levels would return a replicated-typed zeros
                # while other branches return pool-derived (varying)
                # values, which lax.switch rejects (same hazard fixed in
                # solve/ams.py's group branches)
                vma = getattr(jax.typeof(c), "vma", frozenset())
                if axis not in vma:
                    c = jax.lax.pcast(c, (axis,), to="varying")
                return c

            return branch

        branches = [make_branch(di, ls) for di, ls in enumerate(levels_of)]

        r0 = b_ - A0 @ x0_
        r0norm = jnp.sqrt(jax.lax.psum(norm_partial(r0), axis))
        safe_r0 = jnp.where(r0norm == 0.0, 1.0, r0norm)

        snap0 = x0_ if acfg.read_type == "sol" else r0
        ring0 = jnp.tile(snap0[None, :], (W, 1))
        lr0 = jnp.zeros(
            (L, n) if acfg.async_type == "full" else (L,), jnp.int32
        )
        gw0 = GridWaitStats(
            total=jnp.zeros(L, dtype),
            count=jnp.zeros(L, jnp.int32),
            min=jnp.full(L, jnp.inf, dtype),
            max=jnp.full(L, -jnp.inf, dtype),
        )
        hist0 = jnp.full((max_cycles + 1,), jnp.nan, dtype=dtype)
        hist0 = hist0.at[0].set(1.0)

        def body(state):
            (x, ring, lr, gw, marks, gcorr, r_state, c_pend, waits, k,
             relnorm, nflags, dflag, hist, key_s, d_dir, cheb_c, cheb_cp,
             cyc) = state
            key_s, kf, kp, *kreads = jax.random.split(key_s, 3 + L)
            if acfg.sim_grid_wait > 0:
                # wait-counter firing, replicated across devices — the same
                # draws as async_sim (reference: src/SEQ_AMG.cpp:260,482)
                fire = waits <= 0
                redraw = jnp.round(
                    jax.random.uniform(kf, (L,)) * acfg.sim_grid_wait
                ).astype(jnp.int32)
                waits = jnp.where(fire, redraw, waits - 1)
            else:
                fire = jax.random.uniform(kf, (L,), dtype) < probs
            if acfg.fail_level >= 0:
                in_w = (k >= acfg.fail_start) & (
                    k < acfg.fail_start + acfg.fail_duration
                )
                fire = fire.at[acfg.fail_level].set(
                    jnp.where(in_w, False, fire[acfg.fail_level])
                )
            # replicated stale-read columns per level (same stream as sim)
            cols_all = []
            new_lr = lr
            for lvl in range(L):
                cols = _stale_read_cols(acfg, n, lr[lvl], k, kreads[lvl])
                cols_all.append(cols)
                new_lr = new_lr.at[lvl].set(
                    jnp.where(fire[lvl], cols, lr[lvl]).astype(jnp.int32)
                )
            cols_all = jnp.stack(cols_all)

            # per-level accel scale from each level group's own recurrence
            # (the sim's DMEM_ChebyUpdate analog — replicated scalars, so
            # the transform needs no extra comm)
            if accel_on:
                c_next = 2.0 * mu_s * cheb_c - cheb_cp
                if acfg.accel == "richardson":
                    om = jnp.full(
                        (L,),
                        2.0
                        / (1.0 + (1.0 - 1.0 / (acfg.cheby_mu ** 2)) ** 0.5),
                        dtype,
                    )
                else:
                    om = 2.0 * mu_s * cheb_c / c_next
                first_f = cyc == 0
                lvl_scale = jnp.where(
                    first_f, jnp.asarray(1.0, dtype), om * delta_s
                )
            else:
                lvl_scale = jnp.ones(L, dtype)

            # owner-only corrections; psum = the ACCUMULATE exchange. With
            # comm_every > 1 the exchange fires only every Nth superstep;
            # corrections coalesce into the pending buffer between flushes
            # (the reference's -async_comm_save_divisor + in-flight pool
            # coalescing, src/DMEM_Add.cpp:375-383)
            c_part = jax.lax.switch(
                d, branches, (ring, cols_all, fire, c_pend, lvl_scale)
            )
            if local_conv:
                # LOCAL_CONVERGE (reference CheckConverge else-branch,
                # src/DMEM_Add.cpp:933-943): a locally-converged group stops
                # producing corrections while the others continue
                c_part = jnp.where(dflag > 0.5, 0.0, c_part)
            c_new = c_pend + c_part  # raw (unscaled) pending corrections
            flush = ((k + 1) % acfg.comm_every) == 0
            om_apply = 1.0 if accel_on else acfg.omega  # sim parity
            total_c = om_apply * jax.lax.psum(
                jnp.where(flush, c_new, jnp.zeros_like(c_new)), axis
            )
            if accel_on:
                # the cheby_grid group's momentum term rides OUTSIDE the
                # psum (d is replicated): applied = (om-1) d + om*delta*u,
                # and d accumulates every applied correction
                # (src/DMEM_Misc.cpp:651-662, src/DMEM_Add.cpp:511-517)
                mom = jnp.where(
                    fire[cg] & ~first_f[cg], om[cg] - 1.0,
                    jnp.asarray(0.0, dtype),
                )
                total_c = total_c + mom * d_dir
            x = x + total_c
            if accel_on:
                d_dir = jnp.where(fire[cg], total_c, d_dir + total_c)
                adv = fire & ~first_f
                cheb_cp = jnp.where(adv, cheb_c, cheb_cp)
                cheb_c = jnp.where(adv, c_next, cheb_c)
                cyc = cyc + fire.astype(jnp.int32)
            c_pend = jnp.where(flush, jnp.zeros_like(c_new), c_new)

            # grid-wait accounting in random apply order (replicated;
            # reference: src/SMEM_Async_AMG.cpp:242-255)
            perm = jax.random.permutation(kp, L)

            def gw_body(carry, p):
                gcount, mk, g = carry
                f = fire[p]
                wait = (gcount - mk[p]).astype(dtype)
                g = GridWaitStats(
                    total=g.total.at[p].add(jnp.where(f, wait, 0.0)),
                    count=g.count.at[p].add(jnp.where(f, 1, 0)),
                    min=g.min.at[p].min(jnp.where(f, wait, jnp.inf)),
                    max=g.max.at[p].max(jnp.where(f, wait, -jnp.inf)),
                )
                mk = mk.at[p].set(jnp.where(f, gcount, mk[p]))
                gcount = gcount + jnp.where(f, 1, 0)
                return (gcount, mk, g), ()

            (gcorr, marks, gw), _ = jax.lax.scan(
                gw_body, (gcorr, marks, gw), perm
            )

            if acfg.res_mode == "update":
                r_maint = r_state - A0 @ total_c
                normsq, nfl = fused_norm_flags(
                    r_maint, (relnorm <= tol).astype(dtype)
                )
                relnorm = jnp.sqrt(normsq) / safe_r0
                snap = x if acfg.read_type == "sol" else r_maint
            else:
                r_maint = r_state
                # each device's partial comes from ITS local view (shared x
                # plus its own pending corrections) — the fused reduction
                # mixes local residuals exactly as the reference's
                # InnerProdFlag over per-rank local residuals
                r_loc = b_ - A0 @ (x + acfg.omega * c_pend)
                if local_conv:
                    # local test: the device's OWN residual view, no psum
                    lrel = jnp.sqrt(jnp.sum(r_loc * r_loc)) / safe_r0
                    dflag = jnp.maximum(
                        dflag, (lrel <= tol).astype(dtype)
                    )
                    flag = dflag
                else:
                    flag = (relnorm <= tol).astype(dtype)
                normsq, nfl = fused_norm_flags(r_loc, flag)
                relnorm = jnp.sqrt(normsq) / safe_r0
                snap = x if acfg.read_type == "sol" else r_loc
            hist = hist.at[k + 1].set(relnorm)
            ring = ring.at[(k + 1) % W].set(snap)
            return (
                x, ring, new_lr, gw, marks, gcorr, r_maint, c_pend, waits,
                k + 1, relnorm, nfl, dflag, hist, key_s, d_dir, cheb_c,
                cheb_cp, cyc,
            )

        def cond(state):
            k, relnorm, nflags = state[9], state[10], state[11]
            if local_conv:
                # LOCAL_CONVERGE: the program ends when every group has
                # frozen itself, regardless of the global norm
                return (k < max_cycles) & (nflags < D)
            # GLOBAL_CONVERGE done-flag lattice: exit once every device's
            # flag (summed in the SAME psum as the norm) reaches 1; the
            # fresh relnorm check terminates without the extra
            # flag-propagation step
            return (k < max_cycles) & (relnorm > tol) & (nflags < D)

        if acfg.sim_grid_wait > 0:
            key_, kw0 = jax.random.split(key_)
            waits0 = jnp.round(
                jax.random.uniform(kw0, (L,)) * acfg.sim_grid_wait
            ).astype(jnp.int32)
        else:
            waits0 = jnp.zeros(L, jnp.int32)
        # c_pend and dflag become device-varying (they mix in the owned
        # pool shard's branch output), so their zero inits must be marked
        # varying for the while_loop carry types to match
        vary = lambda v: jax.lax.pcast(v, (axis,), to="varying")  # noqa: E731
        state = (
            x0_, ring0, lr0, gw0, jnp.zeros(L, jnp.int32),
            jnp.zeros((), jnp.int32), r0, vary(jnp.zeros(n, dtype)), waits0,
            jnp.asarray(0, jnp.int32),
            jnp.asarray(jnp.inf, dtype), jnp.asarray(0.0, dtype),
            vary(jnp.asarray(0.0, dtype)),
            hist0, key_,
            jnp.zeros(n, dtype),  # cheby direction d (psum output: unvaried)
            jnp.full((L,), mu_s, dtype),  # c seeds T_1 = mu
            jnp.ones(L, dtype),  # c_prev seeds T_0 = 1
            jnp.zeros(L, jnp.int32),  # per-level cycle counts
        )
        (x, _, _, gw, _, _, _, c_pend, _, it, relnorm, _, _, hist,
         _, _, _, _, _) = jax.lax.while_loop(cond, body, state)
        # unflushed pending corrections enter the final answer (the drain
        # loop of the reference's AsyncRecvCleanup, src/DMEM_Add.cpp:827-890)
        x = x + acfg.omega * jax.lax.psum(c_pend, axis)
        return AsyncResult(
            x=x, iters=it, rel_resnorm=relnorm, history=hist, grid_wait=gw
        )

    rep = P()
    a0_specs = jax.tree_util.tree_map(lambda _: rep, A0_rep)
    pool_specs = {dt: P(axis, None) for dt in pools}
    out_specs = AsyncResult(
        x=rep,
        iters=rep,
        rel_resnorm=rep,
        history=rep,
        grid_wait=GridWaitStats(total=rep, count=rep, min=rep, max=rep),
    )
    fn = jax.shard_map(
        solve_body,
        mesh=mesh,
        in_specs=(a0_specs, pool_specs, rep, rep, rep),
        out_specs=out_specs,
    )
    return jax.jit(fn)(A0_rep, pools, b, x0, key)


def device_branch_fn(hier, cfg: CycleConfig, acfg: AsyncConfig, my_levels, b):
    """Standalone jittable function computing one device's per-superstep
    correction work — used to assert per-device FLOPs ∝ assigned-level work
    via compiled cost analysis (the profile check the reference's work
    model is calibrated against, src/DMEM_Setup.cpp:1762-1846)."""
    n = b.shape[0]

    def fn(ring, cols_all):
        c = jnp.zeros(n, b.dtype)
        for lvl in my_levels:
            stale = _gather_stale(acfg, ring, cols_all[lvl], n)
            if acfg.read_type == "sol":
                r_stale = b - hier.levels[0].A @ stale
            else:
                r_stale = stale
            c = c + additive_correction(hier, cfg, r_stale, lvl)
        return c

    return fn
