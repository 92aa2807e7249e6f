"""Work model and level→device assignment ("grid parallelism").

Native port of the reference's work-model logic: each level's work is
proportional to its operator nnz (matvec/smooth cost) plus a vector-op term,
and devices are assigned to levels in contiguous ranges sized by work
fraction — the reference's ComputeWork/AssignProcs with MPI_Comm_split
(reference: src/DMEM_Setup.cpp:1638-1846; SMEM thread analog
PartitionLevels src/SMEM_Setup.cpp:590-868).

Here the "communicator split" is a static block layout: the extended-system
flat vector is padded so each level block occupies whole device shards of a
1-D mesh, making level parallelism a row-block sharding (see
amg_jax.solve.extended and amg_jax.parallel.dist).
"""

from __future__ import annotations

import numpy as np


def compute_level_work(
    hh, async_mode: bool = True, imbalance: float = 0.0,
    fine_residual: bool | None = None,
    smoothed_transfers: bool = False,
) -> np.ndarray:
    """Per-level relative work, in flop units matching what the grid-parallel
    branches actually execute. An additive level-k group does, per cycle:
    a fine residual (async local-residual mode recomputes b - A0 x from its
    stale read, reference: DMEM_AddResidual_LocalRes src/DMEM_Add.cpp:530-556),
    a restrict chain down to k and a prolong chain back (2 flops per nnz
    each), the level's smoothing, and O(rows) vector ops (the reference
    weights async vs sync differently and exposes an artificial imbalance
    knob, src/DMEM_Setup.cpp:1762-1846)."""
    if fine_residual is None:
        fine_residual = async_mode
    L = hh.num_levels
    nnz = np.array([lv.A.nnz for lv in hh.levels], dtype=np.float64)
    rows = np.array([lv.A.n_rows for lv in hh.levels], dtype=np.float64)
    def chain_op(lv):
        # multadd's ONE_INTERPOLANT mode runs its chains through the denser
        # smoothed transfers P~ = G P (reference: SmoothTransfer,
        # src/SMEM_Setup.cpp:1173-1254)
        op = lv.P_s if smoothed_transfers and lv.P_s is not None else lv.P
        return op.nnz if op is not None else 0

    p_nnz = np.array([chain_op(lv) for lv in hh.levels], dtype=np.float64)
    work = np.zeros(L)
    for k in range(L):
        # restrict + prolong chains to/from level k (2 flops/nnz each way),
        # the level's own smoothing and O(rows) vector ops. In the sync
        # model the chains are shared across one sweep, so their cost is
        # amortized. With smoothed transfers the per-level smoother is a
        # zero-guess diagonal scale (O(rows)); otherwise a symmetrized
        # sweep (~2 matvec-equivalents).
        chain = 4.0 * p_nnz[:k].sum()
        if not async_mode:
            chain /= max(L, 1)
        smooth_cost = 2.0 * rows[k] if smoothed_transfers else 4.0 * nnz[k]
        work[k] = chain + smooth_cost + 5.0 * rows[k]
        if fine_residual:
            work[k] += 2.0 * nnz[0]
    if imbalance != 0.0:
        rng = np.random.default_rng(0)
        work *= 1.0 + imbalance * rng.random(L)
    return work / work.sum()


def assign_levels_to_devices(
    work: np.ndarray, num_devices: int,
    policy: str = "balanced", scalar: float = 0.5,
) -> list:
    """Contiguous device ranges per level, sized ∝ work fraction; every level
    gets ≥1 device when possible, coarse levels may share the last device.
    Returns [(dev_start, dev_end_exclusive)] per level
    (reference: AssignProcs src/DMEM_Setup.cpp:1638-1759).

    policy "balanced" sizes groups by the work model
    (ASSIGN_PROCS_BALANCED_WORK); "scalar" decays geometrically — each
    successive level gets max(floor(prev * scalar), 1) devices with the
    remainder on the coarsest (ASSIGN_PROCS_SCALAR + -assign_procs_scalar,
    src/DMEM_Setup.cpp:1684-1685)."""
    L = len(work)
    if num_devices >= L:
        if policy == "scalar":
            counts = np.zeros(L, dtype=int)
            cand = num_devices
            for k in range(L):
                cand = max(int(np.floor(cand * scalar)), 1)
                counts[k] = cand
            # repair to exactly num_devices, floor of 1 per level, surplus
            # devices land on the coarsest grid (the reference's last level
            # takes count_num_procs)
            while counts.sum() > num_devices:
                big = int(np.argmax(counts))
                counts[big] -= 1
            counts[-1] += num_devices - counts.sum()
        else:
            # largest-remainder apportionment with a 1-device floor
            ideal = work * num_devices
            counts = np.maximum(np.floor(ideal).astype(int), 1)
            while counts.sum() > num_devices:
                counts[np.argmax(counts)] -= 1
            order = np.argsort(-(ideal - counts))
            i = 0
            while counts.sum() < num_devices:
                counts[order[i % L]] += 1
                i += 1
        out = []
        start = 0
        for k in range(L):
            out.append((start, start + int(counts[k])))
            start += int(counts[k])
        return out
    # fewer devices than levels: group consecutive levels onto one device
    # each, split points at equal cumulative work
    mid = np.cumsum(work) - work / 2.0
    devs = np.minimum((mid * num_devices).astype(int), num_devices - 1)
    devs = np.maximum.accumulate(devs)  # keep level→device monotone
    return [(int(d), int(d) + 1) for d in devs]
