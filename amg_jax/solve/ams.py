"""Auxiliary-space (Hiptmair/AMS-style) preconditioner for curl-curl systems.

The reference feeds its MFEM Maxwell problem (src/Maxwell.cpp:50-208)
straight into BoomerAMG, which converges poorly: the curl-curl operator's
near-nullspace is the whole range of the discrete gradient G (C @ G = 0 by
the exact sequence), and nodal AMG cannot see it in the edge unknowns. The
standard cure (hypre's AMS / Hiptmair's hybrid smoother) corrects in the
potential space explicitly. This module implements the additive
Hiptmair-Xu decomposition (both auxiliary spaces, as hypre AMS):

    M^-1 r  =  w S^-1 r  +  G · B_n( G^T r )  +  Pi · B_p( Pi^T r )

where w S^-1 is one (SPD) weighted Jacobi/L1 sweep on the edge operator,
B_n is one AMG V-cycle on the nodal operator A_n = G^T A G (for the lumped
lowest-order discretization A_n = sigma·vol·(node Laplacian) — the exact
sequence kills the curl term), and B_p is one AMG V-cycle on the VECTOR
nodal operator A_p = Pi^T A Pi with Pi the Nedelec nodal interpolation
(problems.maxwell aux['Pi']). range(G) covers the gradient near-nullspace,
range(Pi) the remaining low-frequency divergence-free fields — without the
Pi term the additive operator's smallest eigenvalue collapses (measured
kappa 46 vs 2.0 with Pi, n=8 mesh, ideal subspace solves), which is the
difference between a stalling async additive solve and a contracting one.
M is SPD, so it drives PCG. Pi=None falls back to the two-term variant.

Everything device-side is jittable: G converts to the gather-amortized
device formats and the nodal cycle is the ordinary hierarchy apply — so the
preconditioner inherits sharding/BSR/async machinery for free.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from amg_jax.setup.hierarchy import (
    Hierarchy,
    HierarchyParams,
    build_hierarchy,
)
from amg_jax.solve.cycles import CycleConfig, CycleType, mult_vcycle
from amg_jax.sparse.csr import CSRMatrix


class AMSData(NamedTuple):
    """Device-side preconditioner state (a pytree)."""

    G: object  # edges × nodes device matrix
    Gt: object  # nodes × edges
    inv_wscale: jnp.ndarray  # edge smoother w / scale
    node_hier: Hierarchy  # AMG hierarchy on G^T A G
    Pi: object = None  # edges × 3·nodes Nedelec nodal interpolation
    Pit: object = None
    pi_hier: Hierarchy | None = None  # AMG hierarchy on Pi^T A Pi


def build_ams(
    A_edge: CSRMatrix,
    G: CSRMatrix,
    params: HierarchyParams | None = None,
    smoother_weight: float | None = None,
    Pi: CSRMatrix | None = None,
) -> tuple:
    """Set up the AMS preconditioner. Returns (AMSData, node CycleConfig).

    `G` is the discrete gradient and `Pi` the (optional) Nedelec nodal
    interpolation (Problem.aux['G'] / aux['Pi'] from
    amg_jax.problems.maxwell); with Pi the full Hiptmair-Xu two-auxiliary-
    space decomposition is built (hypre AMS's cycle type 1 analog)."""
    import scipy.sparse as sp

    from amg_jax.setup.hierarchy import _format_converter
    from amg_jax.setup.rap import estimate_rho_dinv_a

    if params is None:
        params = HierarchyParams(keep_stencil_fine=False)
    # nodal operator A_n = G^T A G (host SpGEMM, setup-time)
    As = A_edge.to_scipy().tocsr()
    Gs = G.to_scipy().tocsr()
    A_n = CSRMatrix.from_scipy((Gs.T @ (As @ Gs)).tocsr())
    _, node_hier = build_hierarchy(A_n, params)
    convert = _format_converter(params)
    pi_kw = {}
    if Pi is not None:
        Pis = Pi.to_scipy().tocsr()
        A_p = CSRMatrix.from_scipy((Pis.T @ (As @ Pis)).tocsr())
        _, pi_hier = build_hierarchy(A_p, params)
        pi_kw = dict(
            Pi=convert(Pi, params.dtype),
            Pit=convert(Pi.transpose(), params.dtype),
            pi_hier=pi_hier,
        )

    # SPD edge smoother term: w * scale^-1 with w = 1/rho(S^-1 A)
    scale = A_edge.l1_row_norms()
    scale = np.where(scale == 0.0, 1.0, scale)
    if smoother_weight is None:
        smoother_weight = 1.0 / max(
            estimate_rho_dinv_a(A_edge, seed=params.seed, scale=scale), 1e-12
        )
    data = AMSData(
        G=convert(G, params.dtype),
        Gt=convert(G.transpose(), params.dtype),
        inv_wscale=jnp.asarray(smoother_weight / scale, dtype=params.dtype),
        node_hier=node_hier,
        **pi_kw,
    )
    cfg = CycleConfig(cycle=CycleType.MULT, smoother=params.smoother)
    return data, cfg


def ams_precondition(
    ams: AMSData, cfg: CycleConfig, r: jnp.ndarray
) -> jnp.ndarray:
    """Apply M^-1 r = w S^-1 r + G C(G^T r) [+ Pi C(Pi^T r)], where C is
    one cycle of the configured type on the nodal (and vector-nodal)
    hierarchy (MULT V-cycle by default; any additive cycle —
    multadd/AFACx/BPX — via cfg.cycle, so the async additive machinery
    drives the auxiliary corrections too). Jittable."""
    from amg_jax.solve.cycles import cycle_step

    def aux_cycle(hier, rr):
        if cfg.cycle == CycleType.MULT:
            return mult_vcycle(hier, cfg, jnp.zeros_like(rr), rr)
        return cycle_step(hier, cfg, jnp.zeros_like(rr), rr)

    e_smooth = ams.inv_wscale * r
    e = e_smooth + ams.G @ aux_cycle(ams.node_hier, ams.Gt @ r)
    if ams.pi_hier is not None:
        e = e + ams.Pi @ aux_cycle(ams.pi_hier, ams.Pit @ r)
    return e


def build_sharded_ams(
    A_edge: CSRMatrix,
    G: CSRMatrix,
    mesh,
    params: HierarchyParams | None = None,
    smoother_weight: float | None = None,
    Pi: CSRMatrix | None = None,
) -> tuple:
    """Row-sharded AMS over a device mesh with halo-segment comm — the
    distributed Maxwell path (BASELINE config 5: Maxwell + multi-device +
    DMEM-style comm; reference: src/Maxwell.cpp:50-208 solved through
    src/DMEM_Add.cpp/DMEM_Comm.cpp). The edge operator, the discrete
    gradient G and its transpose are HaloELL (boundary-segment exchange
    only — no all-gathers), and the nodal hierarchy is the halo-comm
    distributed hierarchy.

    Returns (A_halo, AMSData, node_cfg, pad_edge, pad_node): vectors pad
    via parallel.dist.pad_vector(b, pad_edge, mesh)."""
    from amg_jax.parallel.dist import _pad_csr, build_dist_hierarchy, shard_vector
    from amg_jax.parallel.spcomm import build_halo_ell
    from amg_jax.setup.hierarchy import build_host_hierarchy
    from amg_jax.setup.rap import estimate_rho_dinv_a

    if params is None:
        params = HierarchyParams(keep_stencil_fine=False, device_format="ell")
    D = int(mesh.devices.size)
    E = A_edge.n_rows
    # nodal operator A_n = G^T A G + halo-distributed hierarchy on it
    As = A_edge.to_scipy().tocsr()
    Gs = G.to_scipy().tocsr()
    A_n = CSRMatrix.from_scipy((Gs.T @ (As @ Gs)).tocsr())
    hh_n = build_host_hierarchy(A_n, params)
    node_hier, pad_node = build_dist_hierarchy(hh_n, params, mesh, comm="halo")
    N_pad = pad_node[1]
    unit = D if params.device_format == "ell" else 16 * D
    E_pad = -(-E // unit) * unit
    A_pad = _pad_csr(A_edge, E_pad, E_pad, unit_diag_from=E)
    G_pad = _pad_csr(G, E_pad, N_pad)  # zero pad block: pads decouple
    A_halo = build_halo_ell(A_pad, mesh, dtype=params.dtype)
    G_h = build_halo_ell(G_pad, mesh, dtype=params.dtype)
    Gt_h = build_halo_ell(G_pad.transpose(), mesh, dtype=params.dtype)

    scale = A_pad.l1_row_norms()  # pad rows: unit diag -> scale 1
    scale = np.where(scale == 0.0, 1.0, scale)
    if smoother_weight is None:
        smoother_weight = 1.0 / max(
            estimate_rho_dinv_a(
                A_edge, seed=params.seed, scale=scale[:E]
            ),
            1e-12,
        )
    pi_kw = {}
    if Pi is not None:
        # second auxiliary space (full Hiptmair-Xu): Pi and its hierarchy
        # shard exactly like G — HaloELL boundary-segment exchange only
        Pis = Pi.to_scipy().tocsr()
        A_p = CSRMatrix.from_scipy((Pis.T @ (As @ Pis)).tocsr())
        hh_p = build_host_hierarchy(A_p, params)
        pi_hier, pad_pi = build_dist_hierarchy(hh_p, params, mesh, comm="halo")
        Pi_pad = _pad_csr(Pi, E_pad, pad_pi[1])
        pi_kw = dict(
            Pi=build_halo_ell(Pi_pad, mesh, dtype=params.dtype),
            Pit=build_halo_ell(Pi_pad.transpose(), mesh, dtype=params.dtype),
            pi_hier=pi_hier,
        )
    data = AMSData(
        G=G_h,
        Gt=Gt_h,
        inv_wscale=shard_vector(
            jnp.asarray(smoother_weight / scale, dtype=params.dtype), mesh
        ),
        node_hier=node_hier,
        **pi_kw,
    )
    cfg = CycleConfig(cycle=CycleType.MULT, smoother=params.smoother)
    return A_halo, data, cfg, (E, E_pad), pad_node


def ams_async_additive_solve(
    A_dev,
    ams: AMSData,
    b: jnp.ndarray,
    x0: jnp.ndarray | None = None,
    key=None,
    omega="auto",  # "auto": 0.7 * 2/(alpha+beta) from estimated eig bounds
    fire_prob: float = 0.8,
    sim_read_delay: int = 2,
    tol: float = 1e-6,
    max_cycles: int = 600,
    accel: str = "none",  # none | cheby | richardson (asymmetric async)
    cheby_coeffs=None,  # auto-estimated from the additive AMS operator
    cheby_grid: int = 0,  # group keeping the 3-term direction (0 = edge)
    cheby_damp: float = 1.0,  # staleness damping of delta
    cheby_restart: int = 16,  # restart the recurrences every m group-cycles
    smoothed_transfers: bool = True,  # G-smoothed P/R in the aux multadds
):
    """ASYNCHRONOUS additive auxiliary-space Maxwell solve — the literal
    BASELINE config-5 composition (reference: src/Maxwell.cpp fed into
    the async additive engine, src/DMEM_Add.cpp:20-178): the edge
    smoother and each nodal level form independent correction groups that
    fire at their own rates against bounded-staleness iterates (the
    SEQ_Add_Vcycle_SimRand model, src/SEQ_AMG.cpp:531-793), corrections
    accumulated into x.

        group 0  : c = w S^-1 r            (edge Jacobi)
        group k+1: c = G · add_corr_k(G^T r)   (node level k, prolongated
                                                through the gradient)

    Convergence (n=8 mesh, fire=0.8, delay=2, measured): the round-4
    two-space variant contracted at 0.9885/cycle; the full Hiptmair-Xu
    decomposition (Pi groups) with smoothed aux transfers and the
    auto-estimated omega contracts at 0.931/cycle and reaches 1e-8.

    accel="cheby" activates the reference's asymmetric async Chebyshev
    (DMEM_ChebyUpdate, src/DMEM_Misc.cpp:612-666): per-group 3-term
    recurrences at each group's own firing rate, omega_k*delta-scaled
    corrections, and the cheby_grid group's (omega_k-1)*d momentum with d
    accumulating every applied correction (src/DMEM_Add.cpp:511-517).
    mu/delta are estimated from the synchronous additive AMS operator
    (the ChebySetup analog) unless cheby_coeffs is given; delta is damped
    cheby_damp-x and the recurrence restarts every cheby_restart group-
    cycles. MEASURED LIMIT: in the synchronous limit (fire=1, delay=0)
    the accelerated iteration hits the Chebyshev-optimal rate (0.79 =
    (sqrt(k)-1)/(sqrt(k)+1) on the kappa~99 two-space operator, 64 vs
    961 scalar cycles), but under ANY bounded staleness the momentum
    term amplifies stale error on spectra wider than kappa ~ 10 and the
    iteration diverges — accel therefore defaults OFF here (it wins on
    the narrow-spectrum multadd configs, solve/async_sim.py), and the
    async-AMS route to speed is conditioning (the Pi space), not
    momentum. solve_ams_pcg / solve_sharded_ams_pcg remain the
    production synchronous Maxwell routes. One jitted lax.while_loop.
    """
    import jax

    from amg_jax.solve.cycles import CycleConfig, CycleType, additive_correction
    from amg_jax.smooth import SmootherType

    if x0 is None:
        x0 = jnp.zeros_like(b)
    if key is None:
        key = jax.random.PRNGKey(0)
    nh = ams.node_hier
    nL = nh.num_levels
    pL = ams.pi_hier.num_levels if ams.pi_hier is not None else 0
    # correction groups: edge smoother, node levels, Pi (vector-nodal)
    # levels — each an independent async group, the Maxwell analog of the
    # reference's per-level grid groups
    Lg = 1 + nL + pL
    W = sim_read_delay + 1
    cfg_add = CycleConfig(
        cycle=CycleType.MULTADD, smoother=SmootherType.L1_JACOBI,
        use_smoothed_transfers=smoothed_transfers,
    )
    accel_on = accel in ("cheby", "richardson")
    cg = min(max(cheby_grid, 0), Lg - 1)

    def group_correction(ams_, g, r):
        if g == 0:
            return ams_.inv_wscale * r
        if g <= nL:
            rn = ams_.Gt @ r
            return ams_.G @ additive_correction(
                ams_.node_hier, cfg_add, rn, g - 1
            )
        rp = ams_.Pit @ r
        return ams_.Pi @ additive_correction(
            ams_.pi_hier, cfg_add, rp, g - 1 - nL
        )

    if cheby_coeffs is None and (accel_on or omega == "auto"):
        from amg_jax.solve.accel import estimate_cycle_eigs

        def minv_a(op, u):
            A_, ams_ = op
            r = A_ @ u
            c = jnp.zeros_like(u)
            for g in range(Lg):
                c = c + group_correction(ams_, g, r)
            return c

        cheby_coeffs = estimate_cycle_eigs(
            minv_a, b.shape[0], b.dtype, num_iters=20,
            operand=(A_dev, ams),
        )
    if omega == "auto":
        # 0.7x the synchronous Richardson optimum of the group-sum
        # operator, backed off for staleness (measured on the n=8 mesh,
        # full AMS: 1.0x diverges under fire=0.8/delay=2, 0.7x contracts
        # at 0.952/cycle — vs 0.9885 for the round-4 fixed omega=0.5
        # two-space variant)
        omega = float(0.7 * 2.0 / (cheby_coeffs.alpha + cheby_coeffs.beta))
    mu = float(cheby_coeffs.mu) if accel_on else 2.0
    delta = float(cheby_coeffs.delta) * cheby_damp if accel_on else 0.0

    def loop(A_, ams_, b_, x0_, key_):
        dtype = b_.dtype
        r0n = jnp.linalg.norm(b_ - A_ @ x0_)
        safe = jnp.where(r0n == 0.0, 1.0, r0n)
        ring0 = jnp.tile(x0_[None, :], (W, 1))
        hist0 = jnp.full((max_cycles + 1,), jnp.nan, dtype=dtype)
        hist0 = hist0.at[0].set(1.0)
        mu_s = jnp.asarray(mu, dtype)
        delta_s = jnp.asarray(delta, dtype)

        def body(st):
            x, ring, k, rel, hist, kk, d_dir, cheb_c, cheb_cp, cyc = st
            kk, kf, kr = jax.random.split(kk, 3)
            fire = jax.random.uniform(kf, (Lg,), dtype) < fire_prob
            cols = jnp.round(
                jnp.maximum(k - sim_read_delay, 0)
                + jax.random.uniform(kr, (Lg,))
                * (k - jnp.maximum(k - sim_read_delay, 0))
            ).astype(jnp.int32)
            if accel_on:
                c_next = 2.0 * mu_s * cheb_c - cheb_cp
                if accel == "richardson":
                    om = jnp.full(
                        (Lg,),
                        2.0 / (1.0 + (1.0 - 1.0 / (mu ** 2)) ** 0.5),
                        dtype,
                    )
                else:
                    om = 2.0 * mu_s * cheb_c / c_next
                first_f = cyc == 0
                g_scale = jnp.where(
                    first_f, jnp.asarray(1.0, dtype), om * delta_s
                )
            else:
                g_scale = jnp.full((Lg,), omega, dtype)
            c = jnp.zeros_like(x)
            for g in range(Lg):
                x_stale = ring[cols[g] % W]
                r_g = b_ - A_ @ x_stale
                c = c + jnp.where(
                    fire[g],
                    g_scale[g] * group_correction(ams_, g, r_g),
                    jnp.zeros_like(c),
                )
            if accel_on:
                mom = jnp.where(
                    fire[cg] & ~first_f[cg], om[cg] - 1.0,
                    jnp.asarray(0.0, dtype),
                )
                c = c + mom * d_dir
                d_dir = jnp.where(fire[cg], c, d_dir + c)
                adv = fire & ~first_f
                cheb_cp = jnp.where(adv, cheb_c, cheb_cp)
                cheb_c = jnp.where(adv, c_next, cheb_c)
                cyc = cyc + fire.astype(jnp.int32)
                if cheby_restart > 0:
                    # RESTARTED async Chebyshev: bounded-staleness errors
                    # are amplified ~T_k(mu) by the long recurrence (the
                    # unrestarted form diverges under any staleness on
                    # this kappa~100 operator — measured); restarting
                    # every m of a group's own cycles caps the
                    # amplification window while keeping most of the
                    # m-step minimax gain ((2/T_m(mu))^(1/m) per cycle).
                    wrap = cyc >= cheby_restart
                    cyc = jnp.where(wrap, 0, cyc)
                    cheb_c = jnp.where(wrap, mu_s, cheb_c)
                    cheb_cp = jnp.where(wrap, jnp.asarray(1.0, dtype),
                                        cheb_cp)
            x = x + c
            r = b_ - A_ @ x
            rel = jnp.linalg.norm(r) / safe
            hist = hist.at[k + 1].set(rel)
            ring = ring.at[(k + 1) % W].set(x)
            return (x, ring, k + 1, rel, hist, kk, d_dir, cheb_c, cheb_cp,
                    cyc)

        def cond(st):
            k, rel = st[2], st[3]
            return (k < max_cycles) & (rel > tol) & (rel < 1e3)

        st = (
            x0_, ring0, jnp.asarray(0, jnp.int32),
            jnp.asarray(1.0, dtype), hist0, key_,
            jnp.zeros_like(x0_),
            jnp.full((Lg,), mu_s, dtype),
            jnp.ones(Lg, dtype),
            jnp.zeros(Lg, jnp.int32),
        )
        x, _, it, rel, hist, _, _, _, _, _ = jax.lax.while_loop(
            cond, body, st
        )
        return x, it, rel, hist

    x, it, rel, hist = jax.jit(loop)(A_dev, ams, b, x0, key)
    from amg_jax.solve.driver import SolveResult

    return SolveResult(x=x, iters=it, rel_resnorm=rel, history=hist)


def plan_ams_groups(ams: AMSData, num_devices: int):
    """Work-model assignment of AMS correction groups to mesh devices
    (the AssignProcs analog, src/DMEM_Setup.cpp:1638-1759): group work =
    the rows its chain+smooth touches (edge smoother: n_edges; aux level
    k: the transfer-chain and level sizes). Returns (groups_of, scale)
    with scale[g] = 1/(devices sharing group g)."""
    from amg_jax.parallel.partition import assign_levels_to_devices

    def level_work(hier):
        out = []
        for k in range(hier.num_levels):
            w = 0.0
            for j in range(k):
                lv = hier.levels[j]
                for f in ("R_s", "R", "P_s", "P"):
                    op = getattr(lv, f, None)
                    if op is not None and hasattr(op, "nnz"):
                        w += op.nnz / 2.0  # one R + one P walk the chain
                        break
            A_k = hier.levels[k].A
            w += getattr(A_k, "nnz", 0) or 0
            out.append(max(w, 1.0))
        return out

    n_e = int(np.asarray(ams.inv_wscale).shape[0])
    work = [float(n_e)] + level_work(ams.node_hier)
    if ams.pi_hier is not None:
        work += level_work(ams.pi_hier)
    assignment = assign_levels_to_devices(np.asarray(work), num_devices)
    Lg = len(work)
    groups_of = [[] for _ in range(num_devices)]
    scale = np.zeros(Lg)
    for g, (s, e) in enumerate(assignment):
        e = max(e, s + 1)
        scale[g] = 1.0 / (e - s)
        for d in range(s, min(e, num_devices)):
            groups_of[d].append(g)
    return tuple(tuple(gs) for gs in groups_of), scale


def _ams_owned_rows(ams: AMSData, groups_of, cfg_add):
    """Per-device field rows for pack_device_pools: exactly the operator
    leaves each device's AMS groups touch (edge scale; G/Gt + node chain;
    Pi/Pit + vector-nodal chain — every group owns its own copies, the
    reference's redistributed gridk ownership)."""
    nL = ams.node_hier.num_levels

    def chain_fields(tag, hier, k, row):
        for j in range(k):
            lv = hier.levels[j]
            if cfg_add.use_smoothed_transfers and lv.R_s is not None:
                row[(tag, j, "R_s")] = lv.R_s
            else:
                row[(tag, j, "R")] = lv.R
            if cfg_add.use_smoothed_transfers and lv.P_s is not None:
                row[(tag, j, "P_s")] = lv.P_s
            else:
                row[(tag, j, "P")] = lv.P
        if k == hier.num_levels - 1:
            row[(tag, "coarse")] = hier.coarse_Ainv
        else:
            row[(tag, k, "A")] = hier.levels[k].A
            row[(tag, k, "sm")] = hier.levels[k].sm

    rows = []
    for gs in groups_of:
        row = {}
        for g in gs:
            if g == 0:
                row[("edge", "inv_wscale")] = ams.inv_wscale
            elif g <= nL:
                row[("G",)] = ams.G
                row[("Gt",)] = ams.Gt
                chain_fields("n", ams.node_hier, g - 1, row)
            else:
                row[("Pi",)] = ams.Pi
                row[("Pit",)] = ams.Pit
                chain_fields("p", ams.pi_hier, g - 1 - nL, row)
        rows.append(row)
    return rows


def ams_grid_parallel_solve(
    A_dev,
    ams: AMSData,
    mesh,
    b: jnp.ndarray,
    x0: jnp.ndarray | None = None,
    key=None,
    omega="auto",
    fire_prob: float = 0.8,
    sim_read_delay: int = 2,
    tol: float = 1e-6,
    max_cycles: int = 600,
    groups_of=None,
    group_scale=None,
    cheby_coeffs=None,
    smoothed_transfers: bool = True,
):
    """Config-5 ASSEMBLED: the asynchronous additive Maxwell solve driven
    through the grid-parallel engine over a device mesh — the reference's
    exact composition (src/Maxwell.cpp:50-208 solved by the per-grid-group
    async additive engine src/DMEM_Add.cpp:20-178 over the ACCUMULATE
    channels of src/DMEM_Comm.cpp:81-348).

    Each mesh device owns a subset of the AMS correction groups (edge
    smoother / node levels / Pi levels, work-model assigned) with OWNED
    operator storage — its pool shard carries only its groups' operators
    (G/Gt or Pi/Pit plus its levels' chain, the redistributed gridk
    ownership); only the fine edge operator rides replicated (every group
    holds a fine copy in the reference's LOCAL_RES design,
    src/DMEM_Add.cpp:530-556). Corrections exchange through ONE psum per
    superstep (the ACCUMULATE channel) and termination is the
    fused (norm-partial, done-flag) psum — InnerProdFlag
    (src/DMEM_Misc.cpp:414-433). The PRNG stream mirrors
    ams_async_additive_solve exactly, so this reproduces the
    single-program async AMS iterates to roundoff (tested) while
    distributing the group work."""
    import jax
    from jax.sharding import PartitionSpec as P

    from amg_jax.parallel.grid import pack_device_pools, pool_field
    from amg_jax.solve.cycles import (
        CycleConfig,
        CycleType,
        additive_correction,
    )
    from amg_jax.smooth import SmootherType

    if x0 is None:
        x0 = jnp.zeros_like(b)
    if key is None:
        key = jax.random.PRNGKey(0)
    axis = mesh.axis_names[0]
    D = int(mesh.devices.size)
    nh = ams.node_hier
    nL = nh.num_levels
    pL = ams.pi_hier.num_levels if ams.pi_hier is not None else 0
    Lg = 1 + nL + pL
    W = sim_read_delay + 1
    n = b.shape[0]
    dtype = b.dtype
    cfg_add = CycleConfig(
        cycle=CycleType.MULTADD, smoother=SmootherType.L1_JACOBI,
        use_smoothed_transfers=smoothed_transfers,
    )
    if groups_of is None:
        groups_of, group_scale = plan_ams_groups(ams, D)
    assert len(groups_of) == D, "one group set per mesh device"
    if group_scale is None:
        group_scale = np.zeros(Lg)
        for gs in groups_of:
            for g in gs:
                group_scale[g] += 1.0
        group_scale = 1.0 / np.maximum(group_scale, 1.0)
    gscale = jnp.asarray(group_scale, dtype)

    if omega == "auto":
        if cheby_coeffs is None:
            from amg_jax.solve.accel import estimate_cycle_eigs

            def group_corr_host(ams_, g, r):
                if g == 0:
                    return ams_.inv_wscale * r
                if g <= nL:
                    return ams_.G @ additive_correction(
                        ams_.node_hier, cfg_add, ams_.Gt @ r, g - 1
                    )
                return ams_.Pi @ additive_correction(
                    ams_.pi_hier, cfg_add, ams_.Pit @ r, g - 1 - nL
                )

            def minv_a(op, u):
                A_, ams_ = op
                r = A_ @ u
                c = jnp.zeros_like(u)
                for g in range(Lg):
                    c = c + group_corr_host(ams_, g, r)
                return c

            cheby_coeffs = estimate_cycle_eigs(
                minv_a, n, dtype, num_iters=20, operand=(A_dev, ams)
            )
        omega = float(0.7 * 2.0 / (cheby_coeffs.alpha + cheby_coeffs.beta))

    pools, metas, owned_bytes = pack_device_pools(
        _ams_owned_rows(ams, groups_of, cfg_add)
    )
    n_pad = -(-n // D) * D

    def hier_view(tag, meta, pool_row, L_sub):
        from amg_jax.setup.hierarchy import Hierarchy, Level

        levels = []
        for j in range(L_sub):
            levels.append(Level(
                A=pool_field(meta, pool_row, (tag, j, "A")),
                sm=pool_field(meta, pool_row, (tag, j, "sm")),
                P=pool_field(meta, pool_row, (tag, j, "P")),
                R=pool_field(meta, pool_row, (tag, j, "R")),
                P_s=pool_field(meta, pool_row, (tag, j, "P_s")),
                R_s=pool_field(meta, pool_row, (tag, j, "R_s")),
                R_inj=None,
            ))
        return Hierarchy(
            levels=tuple(levels),
            coarse_Ainv=pool_field(meta, pool_row, (tag, "coarse")),
        )

    def solve_body(A_, pools_, b_, x0_, key_):
        d = jax.lax.axis_index(axis)
        pool_row = {dt: pools_[dt][0] for dt in pools_}

        def norm_partial(r):
            r2 = jnp.pad(r * r, (0, n_pad - n)).reshape(D, n_pad // D)
            return jax.lax.dynamic_slice_in_dim(r2, d, 1, 0).sum()

        def group_correction(meta, g, r):
            if g == 0:
                return pool_field(meta, pool_row, ("edge", "inv_wscale")) * r
            if g <= nL:
                G = pool_field(meta, pool_row, ("G",))
                Gt = pool_field(meta, pool_row, ("Gt",))
                hv = hier_view("n", meta, pool_row, nL)
                return G @ additive_correction(hv, cfg_add, Gt @ r, g - 1)
            Pi = pool_field(meta, pool_row, ("Pi",))
            Pit = pool_field(meta, pool_row, ("Pit",))
            hv = hier_view("p", meta, pool_row, pL)
            return Pi @ additive_correction(
                hv, cfg_add, Pit @ r, g - 1 - nL
            )

        def make_branch(d_idx, gs):
            def branch(op):
                ring, cols, fire = op
                c = jnp.zeros(n, dtype)
                for g in gs:
                    x_stale = ring[cols[g] % W]
                    r_g = b_ - A_ @ x_stale
                    cg_ = gscale[g] * group_correction(
                        metas[d_idx], g, r_g
                    )
                    c = c + jnp.where(fire[g], cg_, jnp.zeros_like(c))
                # normalize the output's varying-manual-axes type: branches
                # differ in which pooled (device-varying) operators they
                # touch, so without this some branches trace replicated and
                # others varying and lax.switch rejects the mismatch
                # (surfaced at n>=24 group assignments)
                vma = getattr(jax.typeof(c), "vma", frozenset())
                if axis not in vma:
                    c = jax.lax.pcast(c, (axis,), to="varying")
                return c

            return branch

        branches = [make_branch(di, gs) for di, gs in enumerate(groups_of)]

        r0 = b_ - A_ @ x0_
        r0n = jnp.sqrt(jax.lax.psum(norm_partial(r0), axis))
        safe = jnp.where(r0n == 0.0, 1.0, r0n)
        ring0 = jnp.tile(x0_[None, :], (W, 1))
        hist0 = jnp.full((max_cycles + 1,), jnp.nan, dtype=dtype)
        hist0 = hist0.at[0].set(1.0)

        def body(st):
            x, ring, k, rel, hist, kk = st
            kk, kf, kr = jax.random.split(kk, 3)
            fire = jax.random.uniform(kf, (Lg,), dtype) < fire_prob
            cols = jnp.round(
                jnp.maximum(k - sim_read_delay, 0)
                + jax.random.uniform(kr, (Lg,))
                * (k - jnp.maximum(k - sim_read_delay, 0))
            ).astype(jnp.int32)
            c_part = jax.lax.switch(d, branches, (ring, cols, fire))
            # ONE psum: the ACCUMULATE correction exchange
            c = jax.lax.psum(c_part, axis)
            x = x + omega * c
            r = b_ - A_ @ x
            rel = jnp.sqrt(jax.lax.psum(norm_partial(r), axis)) / safe
            hist = hist.at[k + 1].set(rel)
            ring = ring.at[(k + 1) % W].set(x)
            return (x, ring, k + 1, rel, hist, kk)

        def cond(st):
            k, rel = st[2], st[3]
            return (k < max_cycles) & (rel > tol) & (rel < 1e3)

        st = (
            x0_, ring0, jnp.asarray(0, jnp.int32),
            jnp.asarray(1.0, dtype), hist0, key_,
        )
        x, _, it, rel, hist, _ = jax.lax.while_loop(cond, body, st)
        return x, it, rel, hist

    rep = P()
    a_specs = jax.tree_util.tree_map(lambda _: rep, A_dev)
    pool_specs = {dt: P(axis, None) for dt in pools}
    fn = jax.shard_map(
        solve_body,
        mesh=mesh,
        in_specs=(a_specs, pool_specs, rep, rep, rep),
        out_specs=(rep, rep, rep, rep),
    )
    x, it, rel, hist = jax.jit(fn)(A_dev, pools, b, x0, key)
    from amg_jax.solve.driver import SolveResult

    res = SolveResult(x=x, iters=it, rel_resnorm=rel, history=hist)
    return res, owned_bytes


def solve_sharded_ams_pcg(
    A_halo,
    ams: AMSData,
    cfg: CycleConfig,
    b: jnp.ndarray,
    mesh,
    pad_edge,
    x0: jnp.ndarray | None = None,
    tol: float = 1e-8,
    max_iters: int = 200,
):
    """PCG on the sharded edge system (halo comm); b is the UNPADDED host
    RHS; the returned x is unpadded. Pad rows carry zero residual (unit
    diagonal, zero RHS) so norms and dots are exact."""
    import jax

    from amg_jax.parallel.dist import pad_vector, unpad_vector
    from amg_jax.solve.krylov import pcg

    b_pad = pad_vector(jnp.asarray(b), pad_edge, mesh)
    x0_pad = (
        jnp.zeros_like(b_pad)
        if x0 is None
        else pad_vector(jnp.asarray(x0), pad_edge, mesh)
    )
    res = jax.jit(
        lambda A_, ams_, b_, x0_: pcg(
            lambda v: A_ @ v,
            lambda r: ams_precondition(ams_, cfg, r),
            b_,
            x0_,
            tol=tol,
            max_iters=max_iters,
        )
    )(A_halo, ams, b_pad, x0_pad)
    return res._replace(x=unpad_vector(res.x, pad_edge))


def solve_ams_pcg(
    A_dev,
    ams: AMSData,
    cfg: CycleConfig,
    b: jnp.ndarray,
    x0: jnp.ndarray | None = None,
    tol: float = 1e-8,
    max_iters: int = 200,
):
    """PCG on the edge system with the AMS preconditioner."""
    import jax

    from amg_jax.solve.krylov import pcg

    if x0 is None:
        x0 = jnp.zeros_like(b)
    return jax.jit(
        lambda A_, ams_, b_, x0_: pcg(
            lambda v: A_ @ v,
            lambda r: ams_precondition(ams_, cfg, r),
            b_,
            x0_,
            tol=tol,
            max_iters=max_iters,
        )
    )(A_dev, ams, b, x0)
