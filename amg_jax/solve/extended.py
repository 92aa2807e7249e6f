"""Extended-system BPX solver: the whole multilevel operator as ONE system.

The reference assembles the multilevel additive operator as a single big
block-sparse matrix AA over the concatenated per-level unknown vector
(explicit mode), or applies it matrix-free through prolong/restrict chains
(implicit mode), then solves with async Chebyshev-weighted Jacobi
(reference: BuildExtendedMatrix src/SMEM_Setup.cpp:1426-1548,
SMEM_ExtendedSystemSolve src/SMEM_ExtendedSystem.cpp:9-907).

Block structure (derived from the reference's chain products): with
Pchain_k = P_0 … P_{k-1} (level-0 ← level-k prolongation chain) and
C = [Pchain_0 | … | Pchain_{L-1}],

    AA = C^T A_0 C,   AA_{l,m} = A_l · P_l … P_{m-1}  (l < m),

i.e. the extended system is the Galerkin product over the concatenated
chains. Solving AA U = C^T r and updating x += C U is BPX-preconditioned
relaxation in disguise — the natural accelerator formulation: one flattened state
vector, uniform kernels, level parallelism = row-block partition of AA
(this is how grid parallelism maps to device meshes in amg_jax.parallel).

The async mode reuses the bounded-staleness model: each level block fires
independently and reads stale snapshots of the flat vector.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from amg_jax.solve.accel import ChebyCoeffs, cheby_init, cheby_update
from amg_jax.sparse.ell import ELLMatrix, ell_from_csr


@jax.tree_util.register_pytree_node_class
@dataclass
class ExtendedSystem:
    """Device-side extended system (pytree; offsets are static aux)."""

    pchains: Tuple[ELLMatrix, ...]  # n0 × n_k, level-k chain prolongation
    rchains: Tuple[ELLMatrix, ...]  # n_k × n0, explicit transposes
    inv_wdiag: jnp.ndarray  # (N_ext,) w / diag(AA) — Jacobi scaling
    AA: Optional[ELLMatrix]  # explicit mode only
    offsets: Tuple[int, ...]  # static block offsets, len L+1

    def tree_flatten(self):
        return (self.pchains, self.rchains, self.inv_wdiag, self.AA), self.offsets

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(
            pchains=children[0],
            rchains=children[1],
            inv_wdiag=children[2],
            AA=children[3],
            offsets=aux,
        )


def build_extended_system(
    hh, params, explicit: bool = False, weight: Optional[float] = None
) -> ExtendedSystem:
    """Host-side construction from the host hierarchy (setup time)."""
    import scipy.sparse as sp

    from amg_jax.sparse.csr import CSRMatrix

    L = hh.num_levels
    dtype = params.dtype
    A0 = hh.levels[0].A.to_scipy()
    chains = []
    acc = sp.identity(hh.levels[0].A.n_rows, format="csr")
    chains.append(acc)
    for k in range(L - 1):
        acc = (acc @ hh.levels[k].P.to_scipy()).tocsr()
        chains.append(acc)
    pchains = tuple(
        ell_from_csr(CSRMatrix.from_scipy(c), dtype=dtype) for c in chains
    )
    rchains = tuple(
        ell_from_csr(CSRMatrix.from_scipy(c.T.tocsr()), dtype=dtype)
        for c in chains
    )
    offsets = [0]
    for k in range(L):
        offsets.append(offsets[-1] + hh.levels[k].A.n_rows)
    # diag(AA_kk) = diag(A_k); weight per level from the hierarchy
    diags = []
    for k in range(L):
        d = hh.levels[k].A.diagonal()
        d = np.where(d == 0.0, 1.0, d)
        w = weight if weight is not None else hh.levels[k].weight
        diags.append(w / d)
    inv_wdiag = jnp.asarray(np.concatenate(diags), dtype=dtype)
    AA = None
    if explicit:
        blocks = [
            [
                (chains[l].T @ A0 @ chains[m]).tocsr()
                for m in range(L)
            ]
            for l in range(L)
        ]
        AA_sp = sp.bmat(blocks, format="csr")
        AA_sp.data[np.abs(AA_sp.data) < 1e-300] = 0.0
        AA_sp.eliminate_zeros()
        AA = ell_from_csr(CSRMatrix.from_scipy(AA_sp), dtype=dtype)
    return ExtendedSystem(
        pchains=pchains,
        rchains=rchains,
        inv_wdiag=inv_wdiag,
        AA=AA,
        offsets=tuple(offsets),
    )


def build_sharded_extended_system(
    hh, params, mesh, weight: Optional[float] = None, imbalance: float = 0.0,
    assign_policy: str = "balanced", assign_scalar: float = 0.5,
) -> ExtendedSystem:
    """Grid parallelism on the extended system: pad each level block to
    shard boundaries of the mesh (amg_jax.parallel.dist.pad_extended_layout)
    so a plain row sharding of the flat vector places level k's rows exactly
    on its work-model-assigned device group — the realization of the
    reference's AssignProcs communicator split (reference:
    src/DMEM_Setup.cpp:1638-1759) applied to the flattened PAR_BPX system
    (src/SMEM_Sync_AMG.cpp:147-294, src/SMEM_ExtendedSystem.cpp:9-907).

    Each device then updates ONLY its own block rows of AA U = FF (row-
    sharded ELL: per-device FLOPs ∝ its rows' nnz), and the per-step gather
    of U is the gridj→gridk correction exchange. Padding rows carry a unit
    diagonal and zero inv_wdiag, so they never move."""
    import jax as _jax
    from jax.sharding import NamedSharding, PartitionSpec as _P
    import scipy.sparse as sp

    from amg_jax.parallel.dist import pad_extended_layout
    from amg_jax.parallel.partition import (
        assign_levels_to_devices,
        compute_level_work,
    )
    from amg_jax.sparse.csr import CSRMatrix

    L = hh.num_levels
    D = mesh.devices.size
    dtype = params.dtype
    sizes = [lv.A.n_rows for lv in hh.levels]
    work = compute_level_work(hh, imbalance=imbalance)
    assignment = assign_levels_to_devices(
        work, D, policy=assign_policy, scalar=assign_scalar
    )
    p_off, p_total, row_owner = pad_extended_layout(sizes, assignment, D)

    A0 = hh.levels[0].A.to_scipy()
    n0 = sizes[0]
    chains = [sp.identity(n0, format="csr")]
    for k in range(L - 1):
        chains.append((chains[-1] @ hh.levels[k].P.to_scipy()).tocsr())

    # padded chain prolongations: n0 x block_size (original cols lead)
    def pad_cols(c, bs):
        c = c.tocsr().copy()
        c.resize((n0, bs))
        return c

    blocks = [p_off[k + 1] - p_off[k] for k in range(L)]
    pch = [pad_cols(chains[k], blocks[k]) for k in range(L)]
    pchains = tuple(
        ell_from_csr(CSRMatrix.from_scipy(c), dtype=dtype) for c in pch
    )
    rchains = tuple(
        ell_from_csr(CSRMatrix.from_scipy(c.T.tocsr()), dtype=dtype)
        for c in pch
    )

    # assemble the padded AA in one COO pass: AA_{l,m} = chain_l^T A0 chain_m
    rows_all, cols_all, data_all = [], [], []
    for l in range(L):
        left = (chains[l].T @ A0).tocsr()
        for m in range(L):
            blk = (left @ chains[m]).tocoo()
            rows_all.append(blk.row + p_off[l])
            cols_all.append(blk.col + p_off[m])
            data_all.append(blk.data)
    pad_rows = np.flatnonzero(row_owner < 0)
    rows_all.append(pad_rows)
    cols_all.append(pad_rows)
    data_all.append(np.ones(pad_rows.size))
    AA_sp = sp.coo_matrix(
        (
            np.concatenate(data_all),
            (np.concatenate(rows_all), np.concatenate(cols_all)),
        ),
        shape=(p_total, p_total),
    ).tocsr()
    AA_sp.data[np.abs(AA_sp.data) < 1e-300] = 0.0
    AA_sp.eliminate_zeros()
    AA = ell_from_csr(CSRMatrix.from_scipy(AA_sp), dtype=dtype)

    inv_wdiag = np.zeros(p_total)
    for k in range(L):
        d = hh.levels[k].A.diagonal()
        d = np.where(d == 0.0, 1.0, d)
        w = weight if weight is not None else hh.levels[k].weight
        inv_wdiag[p_off[k] : p_off[k] + sizes[k]] = w / d

    ax = mesh.axis_names[0]
    row_sh = NamedSharding(mesh, _P(ax))
    mat_sh = NamedSharding(mesh, _P(ax, None))
    AA = ELLMatrix(
        cols=_jax.device_put(AA.cols, mat_sh),
        vals=_jax.device_put(AA.vals, mat_sh),
        shape_cols=AA.shape_cols,
    )
    return ExtendedSystem(
        pchains=pchains,
        rchains=rchains,
        inv_wdiag=_jax.device_put(
            jnp.asarray(inv_wdiag, dtype=dtype), row_sh
        ),
        AA=AA,
        offsets=tuple(p_off),
    )


def ext_prolong(ext: ExtendedSystem, U: jnp.ndarray) -> jnp.ndarray:
    """x = C U = sum_k Pchain_k U_k (fine-grid vector)."""
    L = len(ext.pchains)
    x = None
    for k in range(L):
        u_k = U[ext.offsets[k] : ext.offsets[k + 1]]
        c = ext.pchains[k] @ u_k
        x = c if x is None else x + c
    return x


def ext_restrict(ext: ExtendedSystem, y: jnp.ndarray) -> jnp.ndarray:
    """C^T y: concatenated restrict chains of a fine-grid vector."""
    return jnp.concatenate([r @ y for r in ext.rchains])


def ext_matvec(ext: ExtendedSystem, A0, U: jnp.ndarray) -> jnp.ndarray:
    """AA @ U — implicit (matrix-free) or explicit ELL
    (reference: ExtendedSystemImplicitMatVec,
    src/SMEM_ExtendedSystem.cpp:838-907)."""
    if ext.AA is not None:
        return ext.AA @ U
    return ext_restrict(ext, A0 @ ext_prolong(ext, U))


class ExtSolveResult(NamedTuple):
    x: jnp.ndarray
    iters: jnp.ndarray
    rel_resnorm: jnp.ndarray
    history: jnp.ndarray


def ext_solve(
    hier,
    ext: ExtendedSystem,
    b: jnp.ndarray,
    x0: Optional[jnp.ndarray] = None,
    tol: float = 1e-8,
    max_cycles: int = 300,
    cheby_coeffs: Optional[ChebyCoeffs] = None,
    async_fire_prob: float = 1.0,
    sim_read_delay: int = 0,
    key: Optional[jax.Array] = None,
) -> ExtSolveResult:
    """Solve A x = b via (async) Chebyshev-weighted Jacobi on the extended
    system AA U = C^T r0, monitoring the TRUE fine-grid residual.

    async_fire_prob < 1 enables the bounded-staleness async mode: each level
    block updates only when it fires, reading a stale U snapshot
    (reference async extended solve: src/SMEM_ExtendedSystem.cpp:243-500)."""
    if x0 is None:
        x0 = jnp.zeros_like(b)
    if key is None:
        key = jax.random.PRNGKey(0)
    fn = jax.jit(
        _ext_loop,
        static_argnames=(
            "tol", "max_cycles", "coeffs", "fire_prob", "delay"
        ),
    )
    return fn(
        hier, ext, b, x0, key, tol, max_cycles, cheby_coeffs,
        async_fire_prob, sim_read_delay,
    )


def _ext_loop(hier, ext, b, x0, key, tol, max_cycles, coeffs, fire_prob, delay):
    A0 = hier.levels[0].A
    L = len(ext.pchains)
    N = ext.offsets[-1]
    dtype = b.dtype
    W = delay + 1

    r0 = b - A0 @ x0
    r0norm = jnp.linalg.norm(r0)
    safe_r0 = jnp.where(r0norm == 0.0, 1.0, r0norm)
    FF = ext_restrict(ext, r0)

    # static per-block segment ids for masking
    seg = np.zeros(N, np.int32)
    for k in range(L):
        seg[ext.offsets[k] : ext.offsets[k + 1]] = k
    seg = jnp.asarray(seg)

    hist0 = jnp.full((max_cycles + 1,), jnp.nan, dtype=dtype)
    hist0 = hist0.at[0].set(1.0)
    U0 = jnp.zeros(N, dtype)
    ring0 = jnp.tile(U0[None, :], (W, 1))
    cheby0 = cheby_init(N, dtype)

    def body(state):
        U, ring, ch, k, relnorm, hist, key = state
        key, kf, kr = jax.random.split(key, 3)
        if fire_prob < 1.0:
            fire = jax.random.uniform(kf, (L,), dtype) < fire_prob
            fire_rows = fire[seg]
            # stale read per block
            low = jnp.maximum(k - delay, 0)
            col = jnp.round(
                low + jax.random.uniform(kr, (L,)) * (k - low)
            ).astype(jnp.int32)
            U_read = ring[col[seg] % W, jnp.arange(N)]
        else:
            fire_rows = jnp.ones(N, dtype=bool)
            U_read = U
        rr = FF - ext_matvec(ext, A0, U_read)
        du = ext.inv_wdiag * rr
        if coeffs is not None:
            if fire_prob < 1.0:
                # async: the global Chebyshev recurrence is inconsistent with
                # partial (stale) updates — use a damped stationary Richardson
                # weight instead. The damping margin (0.6× the synchronous
                # optimum) keeps the iteration convergent under the bounded
                # staleness the async model introduces (measured: 0.6 stays
                # stable at fire_prob 0.7 / delay 3 where 1.0 diverges).
                du = (0.6 * 2.0 / (coeffs.alpha + coeffs.beta)) * du
            else:
                ch = cheby_update(ch, du, coeffs)
                du = ch.d
        U_new = jnp.where(fire_rows, U + du, U)
        x = x0 + ext_prolong(ext, U_new)
        r_true = b - A0 @ x
        relnorm = jnp.linalg.norm(r_true) / safe_r0
        hist = hist.at[k + 1].set(relnorm)
        ring = ring.at[(k + 1) % W].set(U_new)
        return (U_new, ring, ch, k + 1, relnorm, hist, key)

    def cond(state):
        _, _, _, k, relnorm, _, _ = state
        return (k < max_cycles) & (relnorm > tol)

    state = (
        U0, ring0, cheby0, jnp.asarray(0, jnp.int32),
        jnp.asarray(jnp.inf, dtype), hist0, key,
    )
    U, _, _, it, relnorm, hist, _ = jax.lax.while_loop(cond, body, state)
    x = x0 + ext_prolong(ext, U)
    return ExtSolveResult(x=x, iters=it, rel_resnorm=relnorm, history=hist)
