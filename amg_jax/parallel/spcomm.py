"""Sparse neighbor (halo) exchange for unstructured row-partitioned operators.

The reference computes, at setup, the minimal per-peer overlap intervals each
rank needs of every other rank's vector segment (CreateCommData_LocalRes,
reference: src/DMEM_Setup.cpp:666-1265) and its distributed SpMV ships ONLY
those boundary entries per matvec (hypre comm-pkg halo + the async engine of
src/DMEM_Comm.cpp:81-348). The round-1 GSPMD path instead all-gathered the
whole vector per matvec — correct, but comm volume O(n) instead of
O(boundary).

This module is the equivalent here:

  setup time (host, vectorized numpy):
    for each device d: its row block's referenced columns are split into
    own-block (local index) and external (ghost); ghost columns are
    deduplicated and assigned ghost slots; for every (owner p → requester d)
    pair the owner's send list is the requester's ghost columns that fall in
    p's column block. The set of nonzero device offsets (d - p) mod D is the
    neighbor structure:
      * sparse coupling (banded matrices — stencils, RCM-ordered files,
        lexicographic FEM): one lax.ppermute per offset class, shipping only
        real neighbor segments;
      * dense coupling: one lax.all_to_all of padded segments.

  solve time (shard_map, static pattern):
    send_buf = x_local[send_idx]          # boundary gather
    recv     = ppermute / all_to_all      # ships ONLY boundary segments
    ghost    = recv.flat[ghost_map]       # static scatter into ghost slots
    y        = ELL-SpMV over [x_local | ghost]

  Comm volume per matvec per device = (#offsets)*S doubles ∝ the partition
  surface — asserted in tests against the compiled HLO (no O(n) all-gather).

HaloELL is a pytree with `@` semantics, so every existing cycle/smoother/
solver runs on a halo-partitioned hierarchy unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from amg_jax.dtypes import INDEX_DTYPE


@jax.tree_util.register_pytree_node_class
@dataclass
class HaloELL:
    """Row-partitioned ELL operator with a static halo-exchange pattern.

    cols/vals : (D, n_loc, k) — per-device ELL; col entries < n_loc_c index
                the device's own column block, entries >= n_loc_c index its
                ghost slots (n_loc_c + slot)
    send_idx  : ppermute mode: (D, m, S) — send_idx[me, j] = my local column
                indices the peer at offset offsets[j] needs;
                all_to_all mode: (D, D, S) — send_idx[me, peer]
    ghost_map : (D, G) — flat index into the concatenated receive buffers
                for each of my ghost slots (pad 0; unread)
    offsets   : static tuple of device-offset classes ((d-p) mod D); empty
                tuple selects all_to_all mode
    perms     : static tuple of ppermute pair lists, one per offset
    """

    cols: jnp.ndarray
    vals: jnp.ndarray
    send_idx: jnp.ndarray
    ghost_map: jnp.ndarray
    shape: Tuple[int, int]
    n_loc: int
    n_loc_c: int
    axis: str
    offsets: Tuple[int, ...]
    perms: Tuple[Tuple[Tuple[int, int], ...], ...]
    # per-device counts from the setup pattern (static): elements each device
    # puts on the wire per matvec (padded segments, only for pairs it is
    # actually a source of) and the true boundary payload before padding
    wire_send: Tuple[int, ...] = ()
    payload_send: Tuple[int, ...] = ()

    def tree_flatten(self):
        return (
            (self.cols, self.vals, self.send_idx, self.ghost_map),
            (self.shape, self.n_loc, self.n_loc_c, self.axis,
             self.offsets, self.perms, self.wire_send, self.payload_send),
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def shape_cols(self) -> int:
        return self.shape[1]

    @property
    def nnz_padded(self) -> int:
        return int(np.prod(self.cols.shape))

    def __matmul__(self, x):
        return halo_spmv(self, x)

    def matvec(self, x):
        return halo_spmv(self, x)

    def comm_bytes_per_matvec(self) -> int:
        """Mean wire bytes shipped per device per matvec: padded segments,
        counted only for (source, dest) pairs the pattern actually ships
        (the metric the reference reports as message volume,
        DMEM_PrintOutput). See comm_payload_bytes_per_matvec for the
        unpadded boundary payload."""
        return int(round(_mean_bytes(
            self.wire_send, self.send_idx, self.vals.dtype.itemsize
        )))

    def comm_payload_bytes_per_matvec(self) -> int:
        """Mean true boundary bytes per device per matvec (no segment
        padding) — the lower bound the wire volume is compared against."""
        if not self.payload_send:
            return self.comm_bytes_per_matvec()
        D = len(self.payload_send)
        return int(round(
            sum(self.payload_send) * self.vals.dtype.itemsize / D
        ))


def _mean_bytes(wire_send, send_idx, itemsize):
    """Mean per-device wire bytes; falls back to the padded upper bound for
    operators built before pattern accounting (empty wire_send)."""
    if wire_send:
        return sum(wire_send) * itemsize / len(wire_send)
    return send_idx.shape[1] * send_idx.shape[2] * itemsize


def _exchange(a, x_loc):
    """Ship boundary segments; returns the receive pool, first axis = slot.
    Works for scalar segments (x_loc (n,)) and block segments (x_loc
    (ncb, bn) — HaloBSR ships whole bn-wide column blocks)."""
    send_idx = a.send_idx[0]
    tail = x_loc.shape[1:]
    if a.offsets:
        recvs = []
        for j, perm in enumerate(a.perms):
            seg = x_loc[send_idx[j]]  # (S, *tail)
            recvs.append(jax.lax.ppermute(seg, a.axis, list(perm)))
        return jnp.concatenate(recvs) if recvs else jnp.zeros(
            (1,) + tail, x_loc.dtype
        )
    send_buf = x_loc[send_idx]  # (D, S, *tail)
    recv = jax.lax.all_to_all(send_buf, a.axis, split_axis=0, concat_axis=0)
    return recv.reshape((-1,) + tail)


def _local_spmv(a: HaloELL, cols, vals, send_idx, ghost_map, x_loc):
    cols, vals, ghost_map = cols[0], vals[0], ghost_map[0]
    a = HaloELL(
        cols=cols, vals=vals, send_idx=send_idx, ghost_map=ghost_map,
        shape=a.shape, n_loc=a.n_loc, n_loc_c=a.n_loc_c, axis=a.axis,
        offsets=a.offsets, perms=a.perms,
    )
    pool = _exchange(a, x_loc)
    ghost = pool[ghost_map]
    xg = jnp.concatenate([x_loc, ghost])
    return jnp.sum(vals * xg[cols], axis=1)


_MESH_BY_AXIS = {}
_COMM_TRACE = None


def register_halo_mesh(mesh: Mesh) -> None:
    _MESH_BY_AXIS[mesh.axis_names[0]] = mesh


class comm_trace:
    """Record per-matvec halo-comm bytes during a jax trace — the message
    volume accounting of the reference's DMEM stats (message counts/volumes,
    reference: src/DMEM_Misc.cpp:90-96,235). Usage:

        with comm_trace() as log:
            jax.eval_shape(cycle_fn, hier, x, b)
        total_bytes = sum(log)
    """

    def __enter__(self):
        global _COMM_TRACE
        _COMM_TRACE = []
        return _COMM_TRACE

    def __exit__(self, *exc):
        global _COMM_TRACE
        _COMM_TRACE = None
        return False


def halo_spmv(a: HaloELL, x: jnp.ndarray) -> jnp.ndarray:
    """y = A @ x with explicit boundary-segment exchange."""
    if _COMM_TRACE is not None:
        _COMM_TRACE.append(a.comm_bytes_per_matvec())
    mesh = _MESH_BY_AXIS[a.axis]
    ax = a.axis
    fn = jax.shard_map(
        lambda c, v, s, g, xl: _local_spmv(a, c, v, s, g, xl),
        mesh=mesh,
        in_specs=(
            P(ax, None, None), P(ax, None, None),
            P(ax, None, None), P(ax, None),
            P(ax),
        ),
        out_specs=P(ax),
    )
    return fn(a.cols, a.vals, a.send_idx, a.ghost_map, x)


def _build_exchange_pattern(ghost_lists, n_loc_c, D, max_ppermute_offsets):
    """Shared pattern math for HaloELL/HaloBSR: given each device's sorted
    unique external (column or column-block) ids, compute the per-peer send
    lists, offset classes, ppermute pair lists, and ghost maps. Returns
    (send_idx, ghost_map, offs, perms, S, G)."""
    G = max(max((g.size for g in ghost_lists), default=0), 1)
    seg_counts = np.zeros((D, D), np.int64)
    segs = [[None] * D for _ in range(D)]
    for d in range(D):
        g = ghost_lists[d]
        owner = g // n_loc_c
        for p in range(D):
            s = g[owner == p] - p * n_loc_c
            segs[p][d] = s
            seg_counts[p, d] = s.size
    pairs = np.argwhere(seg_counts > 0)
    off_of = {}
    for p, d in pairs:
        off_of.setdefault(int((d - p) % D), []).append((int(p), int(d)))
    offs = tuple(sorted(off_of))
    use_ppermute = 0 < len(offs) <= max_ppermute_offsets
    S = max(int(seg_counts.max()), 1)
    # exact accounting: elements each device puts on the wire (padded
    # segments, only for pairs it actually sources — the ppermute moves
    # data only along listed pairs; all_to_all ships every off-device
    # segment) and the true unpadded boundary payload
    payload_send = tuple(int(c) for c in seg_counts.sum(axis=1))
    if use_ppermute:
        wire = np.zeros(D, np.int64)
        for prs in off_of.values():
            for p, _ in prs:
                wire[p] += S
        wire_send = tuple(int(w) for w in wire)
    else:
        wire_send = tuple(S * (D - 1) for _ in range(D))
    if use_ppermute:
        m = len(offs)
        send_idx = np.zeros((D, m, S), np.int32)
        perms = []
        for j, o in enumerate(offs):
            perms.append(tuple(off_of[o]))
            for p, d in off_of[o]:
                s = segs[p][d]
                send_idx[p, j, : s.size] = s
        perms = tuple(perms)
        ghost_map = np.zeros((D, G), np.int32)
        for d in range(D):
            g = ghost_lists[d]
            owner = g // n_loc_c
            for j, o in enumerate(offs):
                p = (d - o) % D
                msk = owner == p
                if msk.any():
                    ghost_map[d, np.flatnonzero(msk)] = (
                        j * S + np.arange(msk.sum())
                    ).astype(np.int32)
    else:
        offs, perms = (), ()
        send_idx = np.zeros((D, D, S), np.int32)
        ghost_map = np.zeros((D, G), np.int32)
        for p in range(D):
            for d in range(D):
                s = segs[p][d]
                send_idx[p, d, : s.size] = s
        for d in range(D):
            g = ghost_lists[d]
            owner = g // n_loc_c
            pos = np.zeros(g.size, np.int64)
            for p in range(D):
                msk = owner == p
                pos[msk] = np.arange(msk.sum())
            ghost_map[d, : g.size] = (owner * S + pos).astype(np.int32)
    return send_idx, ghost_map, offs, perms, S, G, wire_send, payload_send


def build_halo_ell(csr, mesh: Mesh, dtype=None, max_ppermute_offsets=None):
    """Build the halo pattern for a host CSR whose row and column counts are
    multiples of the mesh size (pad first — see parallel.dist._pad_csr).

    This is the setup-time overlap-interval computation of the reference
    (CreateCommData_LocalRes, src/DMEM_Setup.cpp:666-1265), vectorized."""
    D = int(mesh.devices.size)
    ax = mesh.axis_names[0]
    n_rows, n_cols = csr.n_rows, csr.n_cols
    assert n_rows % D == 0 and n_cols % D == 0, (
        f"halo pattern needs row/col counts divisible by the mesh "
        f"({n_rows}x{n_cols} over {D})"
    )
    n_loc = n_rows // D
    n_loc_c = n_cols // D
    if dtype is None:
        dtype = jnp.float64
    if max_ppermute_offsets is None:
        max_ppermute_offsets = max(D // 2, 2)

    indptr, indices, data = csr.indptr, csr.indices, csr.data
    k = max(int(np.diff(indptr).max()) if n_rows else 1, 1)

    ghost_lists = []  # per device: sorted unique external global cols
    per_dev = []
    for d in range(D):
        lo, hi = indptr[d * n_loc], indptr[(d + 1) * n_loc]
        cols_d = indices[lo:hi]
        own = (cols_d >= d * n_loc_c) & (cols_d < (d + 1) * n_loc_c)
        ghost_lists.append(np.unique(cols_d[~own]))
        per_dev.append((lo, hi, cols_d, own))

    send_idx, ghost_map, offs, perms, S, G, wire_send, payload_send = (
        _build_exchange_pattern(ghost_lists, n_loc_c, D, max_ppermute_offsets)
    )

    cols_arr = np.zeros((D, n_loc, k), np.int64)
    vals_arr = np.zeros((D, n_loc, k), np.float64)
    for d in range(D):
        lo, hi, cols_d, own = per_dev[d]
        g = ghost_lists[d]
        remap = np.where(
            own,
            cols_d - d * n_loc_c,
            n_loc_c + np.searchsorted(g, cols_d),
        )
        rows_local = np.repeat(
            np.arange(n_loc),
            np.diff(indptr[d * n_loc : (d + 1) * n_loc + 1]),
        )
        slot = np.arange(hi - lo) - np.repeat(
            indptr[d * n_loc : (d + 1) * n_loc] - lo,
            np.diff(indptr[d * n_loc : (d + 1) * n_loc + 1]),
        )
        cols_arr[d, rows_local, slot] = remap
        vals_arr[d, rows_local, slot] = data[lo:hi]

    register_halo_mesh(mesh)
    mat_sh = NamedSharding(mesh, P(ax, None, None))
    return HaloELL(
        cols=jax.device_put(jnp.asarray(cols_arr, INDEX_DTYPE), mat_sh),
        vals=jax.device_put(jnp.asarray(vals_arr, dtype=dtype), mat_sh),
        send_idx=jax.device_put(jnp.asarray(send_idx), mat_sh),
        ghost_map=jax.device_put(
            jnp.asarray(ghost_map), NamedSharding(mesh, P(ax, None))
        ),
        shape=(n_rows, n_cols),
        n_loc=n_loc,
        n_loc_c=n_loc_c,
        axis=ax,
        offsets=offs,
        perms=perms,
        wire_send=wire_send,
        payload_send=payload_send,
    )


@jax.tree_util.register_pytree_node_class
@dataclass
class HaloBSR:
    """Block-row-partitioned blocked-ELL (BSR) operator with a halo pattern
    at BLOCK-COLUMN granularity — the gather-amortized unstructured format
    (amg_jax.sparse.bsr) combined with boundary-segment exchange: each
    shipped segment element is one bn-wide column block, so the exchange
    moves dense chunks instead of scalars.

    block_cols: (D, nrb_loc, kb) — remapped (< ncb_loc own, >= ncb_loc ghost)
    blocks:     (D, nrb_loc, kb, bm, bn)
    send_idx/ghost_map/offsets/perms: as HaloELL, over block columns.
    """

    block_cols: jnp.ndarray
    blocks: jnp.ndarray
    send_idx: jnp.ndarray
    ghost_map: jnp.ndarray
    shape: Tuple[int, int]
    nrb_loc: int
    ncb_loc: int
    axis: str
    offsets: Tuple[int, ...]
    perms: Tuple[Tuple[Tuple[int, int], ...], ...]

    def tree_flatten(self):
        return (
            (self.block_cols, self.blocks, self.send_idx, self.ghost_map),
            (self.shape, self.nrb_loc, self.ncb_loc, self.axis,
             self.offsets, self.perms),
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def shape_cols(self) -> int:
        return self.shape[1]

    @property
    def bm(self) -> int:
        return self.blocks.shape[3]

    @property
    def bn(self) -> int:
        return self.blocks.shape[4]

    @property
    def nnz_padded(self) -> int:
        return int(np.prod(self.blocks.shape))

    def __matmul__(self, x):
        return halo_bsr_spmv(self, x)

    def matvec(self, x):
        return halo_bsr_spmv(self, x)

    def comm_bytes_per_matvec(self) -> int:
        nbuf = self.send_idx.shape[1]
        S = self.send_idx.shape[2]
        return nbuf * S * self.bn * self.blocks.dtype.itemsize


def _local_bsr_spmv(a: HaloBSR, bc, blk, send_idx, ghost_map, x_loc):
    bc, blk, ghost_map = bc[0], blk[0], ghost_map[0]
    bn = blk.shape[3]
    xb = x_loc.reshape(a.ncb_loc, bn)
    # exchange whole bn-wide column blocks
    shim = HaloELL(
        cols=None, vals=None, send_idx=send_idx, ghost_map=ghost_map,
        shape=a.shape, n_loc=a.nrb_loc, n_loc_c=a.ncb_loc, axis=a.axis,
        offsets=a.offsets, perms=a.perms,
    )
    pool = _exchange(shim, xb)  # (n_sent, bn) stacked segments
    ghost = pool[ghost_map]  # (G, bn)
    xg = jnp.concatenate([xb, ghost], axis=0)
    g = xg[bc]  # (nrb_loc, kb, bn)
    y = jnp.einsum(
        "rkij,rkj->ri", blk, g, preferred_element_type=blk.dtype,
        precision=jax.lax.Precision.HIGHEST,
    )
    return y.reshape(-1)


def halo_bsr_spmv(a: HaloBSR, x: jnp.ndarray) -> jnp.ndarray:
    mesh = _MESH_BY_AXIS[a.axis]
    ax = a.axis
    if _COMM_TRACE is not None:
        _COMM_TRACE.append(a.comm_bytes_per_matvec())
    fn = jax.shard_map(
        lambda bc, blk, s, g, xl: _local_bsr_spmv(a, bc, blk, s, g, xl),
        mesh=mesh,
        in_specs=(
            P(ax, None, None), P(ax, None, None, None, None),
            P(ax, None, None), P(ax, None),
            P(ax),
        ),
        out_specs=P(ax),
    )
    return fn(a.block_cols, a.blocks, a.send_idx, a.ghost_map, x)


def build_halo_bsr(
    csr, mesh: Mesh, bm: int = 8, bn: int = 8, dtype=None,
    max_ppermute_offsets=None,
) -> HaloBSR:
    """Build a HaloBSR from a host CSR whose row count is a multiple of
    D*bm and column count a multiple of D*bn (pad first)."""
    from amg_jax.sparse.bsr import bsr_from_csr

    D = int(mesh.devices.size)
    ax = mesh.axis_names[0]
    n, m = csr.shape
    assert n % (D * bm) == 0 and m % (D * bn) == 0, (
        f"halo BSR needs n % (D*bm) == 0 and m % (D*bn) == 0 "
        f"({n}x{m}, D={D}, bm={bm}, bn={bn})"
    )
    if dtype is None:
        dtype = jnp.float64
    if max_ppermute_offsets is None:
        max_ppermute_offsets = max(D // 2, 2)
    g = bsr_from_csr(csr, bm=bm, bn=bn, dtype=jnp.float64)
    bc_np = np.asarray(g.block_cols)
    blk_np = np.asarray(g.blocks, dtype=np.float64)
    nrb, kb = bc_np.shape
    nrb_loc = nrb // D
    ncb = -(-m // bn)
    ncb_loc = ncb // D
    # padded slots (zero tiles at block-col 0) must not create ghost traffic
    valid = np.abs(blk_np).sum(axis=(2, 3)) > 0.0

    ghost_lists = []
    for d in range(D):
        bc_d = bc_np[d * nrb_loc : (d + 1) * nrb_loc]
        v_d = valid[d * nrb_loc : (d + 1) * nrb_loc]
        ext = bc_d[v_d & ((bc_d < d * ncb_loc) | (bc_d >= (d + 1) * ncb_loc))]
        ghost_lists.append(np.unique(ext))
    send_idx, ghost_map, offs, perms, S, G, _, _ = _build_exchange_pattern(
        ghost_lists, ncb_loc, D, max_ppermute_offsets
    )
    bc_remap = np.zeros((D, nrb_loc, kb), np.int64)
    for d in range(D):
        bc_d = bc_np[d * nrb_loc : (d + 1) * nrb_loc].astype(np.int64)
        gl = ghost_lists[d]
        own = (bc_d >= d * ncb_loc) & (bc_d < (d + 1) * ncb_loc)
        v_d = valid[d * nrb_loc : (d + 1) * nrb_loc]
        remap = np.where(
            own, bc_d - d * ncb_loc, ncb_loc + np.searchsorted(gl, bc_d)
        )
        # padded/invalid slots point at local block 0 (zero tiles anyway)
        remap = np.where(v_d, remap, 0)
        bc_remap[d] = remap

    register_halo_mesh(mesh)
    blk_sh = NamedSharding(mesh, P(ax, None, None, None, None))
    mat_sh = NamedSharding(mesh, P(ax, None, None))
    return HaloBSR(
        block_cols=jax.device_put(jnp.asarray(bc_remap, INDEX_DTYPE), mat_sh),
        blocks=jax.device_put(
            jnp.asarray(
                blk_np.reshape(D, nrb_loc, kb, bm, bn), dtype=dtype
            ),
            blk_sh,
        ),
        send_idx=jax.device_put(jnp.asarray(send_idx), mat_sh),
        ghost_map=jax.device_put(
            jnp.asarray(ghost_map), NamedSharding(mesh, P(ax, None))
        ),
        shape=(n, m),
        nrb_loc=nrb_loc,
        ncb_loc=ncb_loc,
        axis=ax,
        offsets=offs,
        perms=perms,
    )
