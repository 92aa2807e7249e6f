"""Structured (geometric) multigrid hierarchy — the gather-free fast path.

Gathers cost more per element than streamed loads, so ELL SpMV dominates
coarse-level cost in the algebraic hierarchy. For stencil problems (the
Laplacian/difconv family, SURVEY §2.8 — the reference's headline
benchmarks) the design is a PFMG-style structured hierarchy:

  * coarsening: every other point per axis (vertex-centered, even indices);
  * P: separable (bi/tri)linear interpolation = zero-upsample + a [1/2,1,1/2]
    filter per axis; R = P^T = the mirrored filter + even subsampling —
    both are per-axis contractions, no index arrays;
  * A_c = R A P computed on the host and re-expressed as a VARIABLE-
    coefficient stencil (one coefficient array per offset): SpMV at every
    level is a sum of shifted elementwise multiplies — fully XLA-fusable,
    zero gathers (hypre's PFMG stores struct matrices the same way).

The resulting levels plug into the same cycle algorithms (duck-typed A/P/R
with `@`), smoothers, async schedulers, and solve drivers as the algebraic
path. For a 27-pt fine operator with trilinear transfers the coarse
operators stay 27-pt (verified at build time).
"""

from __future__ import annotations

import functools
import itertools
from dataclasses import dataclass
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from amg_jax.dtypes import SETUP_DTYPE
from amg_jax.sparse.csr import CSRMatrix
from amg_jax.sparse.stencil import StencilOperator


@jax.tree_util.register_pytree_node_class
@dataclass
class VarStencilOperator:
    """Variable-coefficient stencil: coeffs[t] is the full grid-shaped array
    of coefficients for offset t (the struct-matrix layout of hypre PFMG).

    y[i] = sum_t coeffs[t][i] * x[i + offset_t]   (zero outside the grid)
    """

    coeffs: jnp.ndarray  # (m, *grid_shape)
    offsets: Tuple[Tuple[int, ...], ...]  # static
    grid_shape: Tuple[int, ...]  # static

    def tree_flatten(self):
        return (self.coeffs,), (self.offsets, self.grid_shape)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(coeffs=children[0], offsets=aux[0], grid_shape=aux[1])

    @property
    def n_rows(self) -> int:
        return int(np.prod(self.grid_shape))

    @property
    def shape(self) -> tuple:
        return (self.n_rows, self.n_rows)

    def diagonal(self) -> jnp.ndarray:
        for t, off in enumerate(self.offsets):
            if all(d == 0 for d in off):
                return self.coeffs[t].reshape(-1)
        return jnp.zeros(self.n_rows, self.coeffs.dtype)

    def matvec(self, x: jnp.ndarray) -> jnp.ndarray:
        grid = x.reshape(self.grid_shape)
        nd = len(self.grid_shape)
        pads = [
            (
                max(abs(o[d]) for o in self.offsets),
                max(abs(o[d]) for o in self.offsets),
            )
            for d in range(nd)
        ]
        padded = jnp.pad(grid, pads)
        y = jnp.zeros_like(grid)
        for t, off in enumerate(self.offsets):
            idx = tuple(
                slice(pads[d][0] + off[d], pads[d][0] + off[d] + self.grid_shape[d])
                for d in range(nd)
            )
            y = y + self.coeffs[t] * padded[idx]
        return y.reshape(x.shape)

    def __matmul__(self, x):
        return self.matvec(x)


@functools.lru_cache(maxsize=None)
def _axis_transfer_np(sf: int, sc: int) -> np.ndarray:
    """1-D linear-interpolation transfer matrix S (sf x sc): S[2c,c]=1,
    S[2c±1,c]=1/2 (clipped at the boundary). Restriction contracts the fine
    axis with S; prolongation contracts the coarse axis with S^T — the same
    matrix realizes both ([1/2,1,1/2] filter + even subsample)."""
    if sf == sc:
        # untouched axis (e.g. the component axis of an interleaved vector
        # field): the transfer is the identity
        return np.eye(sf)
    if sf == 2 * sc - 2:
        # EVEN fine axis, graded-end coarsening (sc = sf/2 + 1): coarse
        # nodes sit on fine nodes {0, 2, …, sf-2, sf-1} — the last coarse
        # interval has length 1 instead of 2. Every fine row still sums to
        # 1, so constants (and rigid-body modes on FEM grids) stay in
        # range(P) — the property plain halving of an even axis loses (its
        # last fine node is covered by a single 0.5 entry), which is what
        # stalled the identity-BC elasticity V-cycle at rate ~0.99.
        S = np.zeros((sf, sc))
        c = np.arange(sc - 1)
        S[2 * c, c] = 1.0
        S[sf - 1, sc - 1] = 1.0
        odd = np.arange(1, sf - 1, 2)
        S[odd, odd // 2] = 0.5
        S[odd, odd // 2 + 1] = 0.5
        return S
    S = np.zeros((sf, sc))
    c = np.arange(sc)
    S[2 * c, c] = 1.0
    lo, hi = 2 * c - 1, 2 * c + 1
    m = lo >= 0
    S[lo[m], c[m]] = 0.5
    m = hi < sf
    S[hi[m], c[m]] = 0.5
    return S


def _restrict_axis(g: jnp.ndarray, axis: int, sf: int, sc: int):
    """Apply S^T (see _axis_transfer_np) along `axis`: the [1/2, 1, 1/2]
    filter and even subsampling as strided slices of the zero-padded axis.
    Elementwise float arithmetic only — no dense product, so nothing on
    this path can run in TF32, and XLA fuses it with its neighbours."""
    if sf == 2 * sc - 2:
        # graded end: the standard transfer on fine nodes 0..sf-2, and the
        # last fine node injected into the last coarse node
        head = _restrict_axis(
            lax.slice_in_dim(g, 0, sf - 1, axis=axis), axis, sf - 1, sc - 1)
        return jnp.concatenate(
            [head, lax.slice_in_dim(g, sf - 1, sf, axis=axis)], axis=axis)
    pad = [(0, 0)] * g.ndim
    pad[axis] = (1, 2 * sc + 1 - sf)  # padded length 2*sc + 2
    gp = jnp.pad(g, pad)

    def taps(start):
        return lax.slice_in_dim(gp, start, start + 2 * sc, stride=2, axis=axis)

    return taps(1) + 0.5 * (taps(0) + taps(2))


def _prolong_axis(g: jnp.ndarray, axis: int, sf: int, sc: int):
    """Apply S along `axis`: coarse values on the even fine nodes, the mean
    of the two coarse neighbours (zero past the end) on the odd ones."""
    if sf == 2 * sc - 2:
        head = _prolong_axis(
            lax.slice_in_dim(g, 0, sc - 1, axis=axis), axis, sf - 1, sc - 1)
        return jnp.concatenate(
            [head, lax.slice_in_dim(g, sc - 1, sc, axis=axis)], axis=axis)
    pad = [(0, 0)] * g.ndim
    pad[axis] = (0, 1)
    nxt = lax.slice_in_dim(jnp.pad(g, pad), 1, sc + 1, axis=axis)
    both = jnp.stack([g, 0.5 * (g + nxt)], axis=axis + 1)
    shape = list(g.shape)
    shape[axis] = 2 * sc
    return lax.slice_in_dim(both.reshape(shape), 0, sf, axis=axis)


@jax.tree_util.register_pytree_node_class
@dataclass
class StructuredProlong:
    """Trilinear prolongation coarse→fine: zero-upsample then filter."""

    fine_shape: Tuple[int, ...]
    coarse_shape: Tuple[int, ...]

    def tree_flatten(self):
        return (), (self.fine_shape, self.coarse_shape)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(fine_shape=aux[0], coarse_shape=aux[1])

    @property
    def shape(self):
        return (int(np.prod(self.fine_shape)), int(np.prod(self.coarse_shape)))

    @property
    def shape_cols(self):
        return self.shape[1]

    def __matmul__(self, xc: jnp.ndarray):
        g = xc.reshape(self.coarse_shape)
        for d in range(g.ndim):
            if self.fine_shape[d] == self.coarse_shape[d]:
                continue  # identity axis (vector components)
            g = _prolong_axis(g, d, self.fine_shape[d], self.coarse_shape[d])
        return g.reshape(-1)


@jax.tree_util.register_pytree_node_class
@dataclass
class StructuredRestrict:
    """Full-weighting restriction fine→coarse: P^T = filter then subsample."""

    fine_shape: Tuple[int, ...]
    coarse_shape: Tuple[int, ...]

    def tree_flatten(self):
        return (), (self.fine_shape, self.coarse_shape)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(fine_shape=aux[0], coarse_shape=aux[1])

    @property
    def shape(self):
        return (int(np.prod(self.coarse_shape)), int(np.prod(self.fine_shape)))

    @property
    def shape_cols(self):
        return self.shape[1]

    def __matmul__(self, rf: jnp.ndarray):
        g = rf.reshape(self.fine_shape)
        for d in range(g.ndim):
            if self.fine_shape[d] == self.coarse_shape[d]:
                continue  # identity axis (vector components)
            g = _restrict_axis(g, d, self.fine_shape[d], self.coarse_shape[d])
        return g.reshape(-1)


def _coarse_shape(shape):
    return tuple((s + 1) // 2 for s in shape)


@jax.tree_util.register_pytree_node_class
@dataclass
class MaskedTransfer:
    """Transfer composed with Dirichlet masks: out_mask * (T @ (in_mask *
    x)). Decouples identity-BC (clamped) dofs from the coarse correction —
    without it the Galerkin coarse operators mix stiffness and identity
    rows and the V-cycle degrades badly near the boundary."""

    inner: object  # StructuredProlong | StructuredRestrict
    in_mask: jnp.ndarray
    out_mask: jnp.ndarray

    def tree_flatten(self):
        return (self.inner, self.in_mask, self.out_mask), ()

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(inner=children[0], in_mask=children[1],
                   out_mask=children[2])

    @property
    def shape(self):
        return self.inner.shape

    @property
    def shape_cols(self):
        return self.inner.shape[1]

    def __matmul__(self, x: jnp.ndarray):
        return self.out_mask * (self.inner @ (self.in_mask * x))


def _identity_row_mask(As) -> np.ndarray:
    """Boolean mask of exact unit-diagonal-only rows (Dirichlet identity
    rows of the bc='identity' convention): a_ii == 1 and no off-diagonals."""
    As = As.tocsr()
    n = As.shape[0]
    nnz_row = np.diff(As.indptr)
    mask = np.zeros(n, dtype=bool)
    single = nnz_row == 1
    idx = As.indptr[:-1][single]
    mask[single] = (As.indices[idx] == np.flatnonzero(single)) & (
        As.data[idx] == 1.0
    )
    return mask


def _structured_P_csr(fine_shape, coarse_shape) -> CSRMatrix:
    """Assemble the trilinear P as host CSR (for RAP and validation)."""
    import scipy.sparse as sp

    nd = len(fine_shape)
    nf = int(np.prod(fine_shape))
    nc = int(np.prod(coarse_shape))
    cid = np.arange(nc).reshape(coarse_shape)
    rows, cols, vals = [], [], []
    # fine point f gets contributions from coarse neighbors per axis
    fidx = np.stack(
        np.meshgrid(*[np.arange(s) for s in fine_shape], indexing="ij"),
        axis=-1,
    ).reshape(-1, nd)
    fid = np.arange(nf)
    # per axis: even f → (f//2, weight 1); odd f → ((f-1)/2, .5), ((f+1)/2, .5)
    per_axis = []
    for d in range(nd):
        f = fidx[:, d]
        opts = []  # list of (cidx array, weight array, valid mask)
        if coarse_shape[d] == fine_shape[d]:
            # uncoarsened (semicoarsening) axis: identity transfer
            opts.append((f, np.ones(nf), np.ones(nf, dtype=bool)))
            opts.append((f, np.zeros(nf), np.zeros(nf, dtype=bool)))
        elif fine_shape[d] == 2 * coarse_shape[d] - 2:
            # graded-end even-axis coarsening (matches _axis_transfer_np):
            # coarse nodes on fine {0, 2, …, sf-2, sf-1}
            sf, sc = fine_shape[d], coarse_shape[d]
            last = f == sf - 1
            even = (f % 2 == 0) | last
            c1 = np.where(last, sc - 1, f // 2)
            opts.append((c1, np.where(even, 1.0, 0.5),
                         np.ones(nf, dtype=bool)))
            opts.append((f // 2 + 1, np.where(even, 0.0, 0.5),
                         (~even) & (f // 2 + 1 <= sc - 1)))
        else:
            even = f % 2 == 0
            opts.append(
                (f // 2, np.where(even, 1.0, 0.5), even | (f // 2 >= 0))
            )
            opts.append(((f + 1) // 2, np.where(even, 0.0, 0.5),
                         (~even) & ((f + 1) // 2 < coarse_shape[d])))
        per_axis.append(opts)
    for combo in itertools.product(range(2), repeat=nd):
        w = np.ones(nf)
        cmulti = np.zeros((nf, nd), dtype=np.int64)
        valid = np.ones(nf, dtype=bool)
        for d in range(nd):
            ci, wd, vd = per_axis[d][combo[d]]
            w = w * wd
            cmulti[:, d] = ci
            valid &= vd
        valid &= w != 0.0
        if not valid.any():
            continue
        cflat = cid[tuple(cmulti[valid].T)]
        rows.append(fid[valid])
        cols.append(cflat)
        vals.append(w[valid])
    p = sp.coo_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(nf, nc),
    )
    return CSRMatrix.from_scipy(p)


def _csr_to_var_stencil(A: CSRMatrix, grid_shape, dtype) -> VarStencilOperator:
    """Re-express a CSR operator on a structured grid as a variable stencil.
    Raises if any entry falls outside the ±1 neighborhood (would indicate
    transfer operators inconsistent with a 27-pt-closed RAP)."""
    nd = len(grid_shape)
    n = int(np.prod(grid_shape))
    assert A.n_rows == n
    strides = np.array(
        [int(np.prod(grid_shape[d + 1 :])) for d in range(nd)], dtype=np.int64
    )
    offsets = [o for o in itertools.product((-1, 0, 1), repeat=nd)]
    off_index = {o: t for t, o in enumerate(offsets)}
    coeffs = np.zeros((len(offsets), n), dtype=SETUP_DTYPE)
    rows = np.repeat(np.arange(n), np.diff(A.indptr))
    cols = A.indices.astype(np.int64)
    # decode multi-indices
    rmulti = np.stack(
        [np.asarray((rows // strides[d]) % grid_shape[d]) for d in range(nd)],
        axis=1,
    )
    cmulti = np.stack(
        [np.asarray((cols // strides[d]) % grid_shape[d]) for d in range(nd)],
        axis=1,
    )
    delta = cmulti - rmulti
    if np.abs(delta).max() > 1:
        bad = np.abs(delta).max(axis=1) > 1
        raise ValueError(
            f"operator not ±1-stencil-closed: {bad.sum()} entries reach "
            f"distance {np.abs(delta).max()}"
        )
    tidx = np.array([off_index[tuple(d)] for d in delta])
    coeffs[tidx, rows] = A.data
    return VarStencilOperator(
        coeffs=jnp.asarray(coeffs.reshape((len(offsets),) + tuple(grid_shape)),
                           dtype=dtype),
        offsets=tuple(offsets),
        grid_shape=tuple(grid_shape),
    )


def csr_to_dia_stencil(
    A: CSRMatrix, grid_shape, dtype, max_offsets: int = 256,
    return_lo: bool = False,
) -> VarStencilOperator:
    """Re-express ANY translation-structured CSR operator on a logical grid
    as a variable stencil with a DISCOVERED offset set (generalized-diagonal
    / DIA form). Unlike _csr_to_var_stencil this allows arbitrary reach.

    The payoff case is interleaved vector problems: a Q1 elasticity operator
    on an (nx+1, ny+1, nz+1) node grid with d dofs/node, ordered
    node-major/component-minor, is exactly a variable stencil on the grid
    (nx+1, ny+1, d*(nz+1)) whose last-axis offsets are d*dz_node + (comp_b -
    comp_a) ∈ [-(d+2), d+2] — at most 9*(2d+... ) ~ 99 generalized diagonals
    for d=3. SpMV then runs as shifted elementwise multiply-adds: zero
    gathers, full HBM bandwidth (vs ~2 ns/index gather-bound BSR). The same
    holds for any FEM/FD operator on a structured mesh with fixed dofs per
    node (reference's unstructured-CSR workhorse: src/SMEM_MatVec.cpp).
    """
    n = A.n_rows
    nd = len(grid_shape)
    assert int(np.prod(grid_shape)) == n, (grid_shape, n)
    strides = np.array(
        [int(np.prod(grid_shape[d + 1 :])) for d in range(nd)], dtype=np.int64
    )
    rows = np.repeat(np.arange(n), np.diff(A.indptr))
    cols = A.indices.astype(np.int64)
    rmulti = np.stack(
        [np.asarray((rows // strides[d]) % grid_shape[d]) for d in range(nd)],
        axis=1,
    )
    cmulti = np.stack(
        [np.asarray((cols // strides[d]) % grid_shape[d]) for d in range(nd)],
        axis=1,
    )
    delta = cmulti - rmulti
    # scalar-encode the offset triples so the census is a 1-D unique (a
    # lexicographic unique over 10M+ rows costs minutes; this is seconds)
    enc_base = np.asarray(
        [2 * int(s) + 1 for s in grid_shape], dtype=np.int64
    )
    enc = np.zeros(delta.shape[0], dtype=np.int64)
    for d in range(nd):
        enc = enc * enc_base[d] + (delta[:, d] + int(grid_shape[d]))
    uniq_enc, tidx = np.unique(enc, return_inverse=True)
    if len(uniq_enc) > max_offsets:
        raise ValueError(
            f"operator needs {len(uniq_enc)} generalized diagonals "
            f"(> {max_offsets}): not translation-structured on {grid_shape}"
        )
    # decode back to offset tuples (ascending encoded order is the same
    # lexicographic order np.unique(axis=0) produced)
    uniq = np.zeros((len(uniq_enc), nd), dtype=np.int64)
    rem = uniq_enc.copy()
    for d in range(nd - 1, -1, -1):
        uniq[:, d] = rem % enc_base[d] - int(grid_shape[d])
        rem //= enc_base[d]
    coeffs = np.zeros((len(uniq), n), dtype=SETUP_DTYPE)
    coeffs[tidx, rows] = A.data
    offsets = tuple(tuple(int(v) for v in o) for o in uniq)
    shaped = coeffs.reshape((len(uniq),) + tuple(grid_shape))
    vs = VarStencilOperator(
        coeffs=jnp.asarray(shaped, dtype=dtype),
        offsets=offsets,
        grid_shape=tuple(grid_shape),
    )
    if not return_lo:
        return vs
    # double-single coefficient split: lo holds the f64→f32 rounding
    # remainder, so (vs, vs_lo) together represent A to ~f64 accuracy —
    # the accurate-operator pair for mixed-precision outer residuals
    # (amg_jax.solve.mixed.mixed_pcg / ops/ds.py::ds_residual)
    c_hi = shaped.astype(np.float32)
    c_lo = (shaped - c_hi.astype(np.float64)).astype(np.float32)
    vs_lo = VarStencilOperator(
        coeffs=jnp.asarray(c_lo),
        offsets=offsets,
        grid_shape=tuple(grid_shape),
    )
    return vs, vs_lo


def build_dia_structured_hierarchy(
    A: CSRMatrix,
    node_shape: Tuple[int, ...],
    num_functions: int = 1,
    params=None,
    max_levels: int = 25,
    max_coarse_size: int = 600,
    dtype=jnp.float64,
    smoother=None,
    smooth_weight=None,
    max_offsets: int = 256,
):
    """Geometric hierarchy for a VARIABLE-coefficient operator on a
    structured node grid with `num_functions` interleaved dofs per node —
    the gather-free device path for structured-mesh FEM systems (elasticity
    bc='identity', vardifconv/graded scalar problems).

    Every level's operator is a DIA VarStencilOperator (shifted multiply-
    adds, zero gathers); transfers are node-wise separable (tri)linear
    interpolation x identity on the component axis, executed as per-axis dense
    contractions (StructuredProlong/Restrict on the (nodes..., d) view).
    Because nested Q1 spaces embed exactly, the Galerkin product of the
    identity-BC FEM operator stays translation-structured, so every coarse
    level admits the DIA form too (validated at build time — raises
    ValueError if the offset census explodes).

    Returns the same (HostHierarchy, Hierarchy) pair as the other builders;
    plugs into all cycles/solvers unchanged. Replaces the reference's
    unstructured row-loop path for its structured-mesh problems (reference:
    src/SMEM_MatVec.cpp:123-259, src/Elasticity.cpp:7-149)."""
    import scipy.sparse as sp

    from amg_jax.setup.hierarchy import (
        Hierarchy,
        HostHierarchy,
        HostLevel,
        Level,
    )
    from amg_jax.setup.rap import estimate_rho_dinv_a
    from amg_jax.smooth import SmootherType, make_smoother_data

    if params is not None:
        dtype = params.dtype
        smoother = params.smoother
        smooth_weight = params.smooth_weight
        max_levels = params.max_levels
        max_coarse_size = max(params.max_coarse_size, 8)
    if smoother is None:
        smoother = SmootherType.L1_JACOBI
    d = max(num_functions, 1)

    def dia_shape(ns):
        return tuple(ns[:-1]) + (ns[-1] * d,)

    hh = HostHierarchy(params=params)
    node_shapes = [tuple(node_shape)]
    A_csr = A
    dev_levels = []
    lvl = 0
    while True:
        ns = node_shapes[-1]
        A_dev = csr_to_dia_stencil(
            A_csr, dia_shape(ns), dtype, max_offsets=max_offsets
        )
        hl = HostLevel(A=A_csr)
        if smooth_weight is not None:
            hl.weight = smooth_weight
        else:
            scale = None
            if smoother in (SmootherType.L1_JACOBI, SmootherType.SYM_L1_JACOBI):
                scale = A_csr.l1_row_norms()
            hl.weight = 1.0 / max(estimate_rho_dinv_a(A_csr, scale=scale), 1e-12)
        hh.levels.append(hl)
        # jgs_weight='auto' carries the divergence guard the algebraic
        # builder applies (hybrid JGS is only conditionally convergent
        # on elasticity-class operators) — round-4 fix: the DIA builder
        # previously dropped it, so JGS-smoothed DIA cycles diverged
        sm = make_smoother_data(
            A_csr, smoother, w=hl.weight, dtype=dtype,
            block_size=(params.block_size if params is not None else 128),
            jgs_weight=(getattr(params, 'jgs_weight', 'auto')
                        if params is not None else 'auto'),
        )
        n = A_csr.n_rows
        mask_f = _identity_row_mask(A_csr.to_scipy())
        # On identity-BC FEM grids (clamped dofs present ⇒ free faces
        # exist) the transfer must reproduce constants on free faces or the
        # rigid-body near-nullspace escapes range(P) and the V-cycle rate
        # degrades to ~1 (observed: 145×19×19 beam stalled at 0.99 once
        # plain halving crossed an even axis — its last fine node is
        # covered by a single 0.5 entry). Odd axes coarsen vertex-centered
        # (sf = 2sc−1); EVEN axes coarsen with the graded-end transfer
        # (sc = sf/2+1, coarse nodes on fine {0,2,…,sf−2,sf−1}), which
        # keeps unit row sums — semicoarsening (skipping the axis) is NOT
        # an option: it builds anisotropic coarse cells that point-Jacobi
        # V-cycles stall on (measured: rel_res plateau 1e-3 at 40 PCG
        # cycles on the 33×11×11 beam). Eliminated-boundary operators keep
        # plain halving: their constant defect sits on Dirichlet rows where
        # the error is identically zero.
        if mask_f.any():
            cns_try = tuple(
                (s + 1) // 2 if s % 2 == 1 else s // 2 + 1 for s in ns
            )
        else:
            cns_try = _coarse_shape(ns)
        if (
            n <= max_coarse_size
            or lvl == max_levels - 1
            or min(ns) < 5
            or cns_try == ns
        ):
            dev_levels.append(
                Level(A=A_dev, P=None, R=None, P_s=None, R_s=None,
                      R_inj=None, sm=sm)
            )
            break
        cns = cns_try
        Ps = _structured_P_csr(ns, cns).to_scipy()
        if d > 1:
            Ps = sp.kron(Ps, sp.eye(d), format="csr")
        # Dirichlet decoupling: zero the P rows of clamped fine dofs and the
        # columns of clamped coarse dofs (coarse node 2i is the fine node's
        # image, so identity rows survive RAP as identity rows), then pin
        # the clamped coarse diagonal back to 1 — the coarse problem is the
        # same bc='identity' convention one level down
        mask_f = _identity_row_mask(A_csr.to_scipy())
        if mask_f.any():
            keep_f = sp.diags((~mask_f).astype(np.float64))
            # coarse clamped mask by injection: coarse node c sits on the
            # fine node of its 1-D position — 2c on an odd-coarsened axis,
            # {0,2,…,sf−2,sf−1} on a graded-end even axis, c itself on an
            # identity axis — so it inherits that dof's Dirichlet status
            def _axis_pos(sf, sc):
                if sf == sc:
                    return np.arange(sf)
                if sf == 2 * sc - 2:
                    return np.append(np.arange(0, sf - 1, 2), sf - 1)
                return 2 * np.arange(sc)

            pos = [_axis_pos(ns[ax], cns[ax]) for ax in range(len(ns))]
            pos.append(np.arange(d))
            mask_c = mask_f.reshape(ns + (d,))[np.ix_(*pos)].reshape(-1)
            keep_c = sp.diags((~mask_c).astype(np.float64))
            Ps = (keep_f @ Ps @ keep_c).tocsr()
            Ps.eliminate_zeros()
        P_csr = CSRMatrix.from_scipy(Ps.tocsr())
        R_csr = P_csr.transpose()
        hl.P, hl.R = P_csr, R_csr
        Ac = (Ps.T @ A_csr.to_scipy() @ Ps).tocsr()
        Ac.data[np.abs(Ac.data) < 1e-14 * np.abs(Ac.data).max()] = 0.0
        Ac.eliminate_zeros()
        if mask_f.any() and mask_c.any():
            Ac = (Ac + sp.diags(mask_c.astype(np.float64))).tocsr()
        # per-axis node transfers x identity on the trailing component axis
        P_dev = StructuredProlong(
            fine_shape=ns + (d,), coarse_shape=cns + (d,)
        )
        R_dev = StructuredRestrict(
            fine_shape=ns + (d,), coarse_shape=cns + (d,)
        )
        if mask_f.any():
            vin = jnp.asarray((~mask_c).astype(np.float64), dtype=dtype)
            vout = jnp.asarray((~mask_f).astype(np.float64), dtype=dtype)
            P_dev = MaskedTransfer(inner=P_dev, in_mask=vin, out_mask=vout)
            R_dev = MaskedTransfer(inner=R_dev, in_mask=vout, out_mask=vin)
        dev_levels.append(
            Level(A=A_dev, P=P_dev, R=R_dev, P_s=None, R_s=None,
                  R_inj=None, sm=sm)
        )
        A_csr = CSRMatrix.from_scipy(Ac)
        node_shapes.append(cns)
        lvl += 1
    coarse_Ainv = jnp.asarray(
        np.linalg.inv(hh.levels[-1].A.to_dense()), dtype=dtype
    )
    return hh, Hierarchy(levels=tuple(dev_levels), coarse_Ainv=coarse_Ainv)


def build_structured_hierarchy(
    fine: StencilOperator,
    params=None,
    max_levels: int = 25,
    max_coarse_size: int = 600,
    dtype=jnp.float64,
    smoother=None,
    smooth_weight=None,
    coarse_op: str = "auto",  # auto | var (exact RAP) | const (see below)
):
    """Geometric hierarchy for a stencil problem. Returns the same
    (HostHierarchy, Hierarchy) pair as the algebraic build — Level.A is a
    VarStencilOperator (level 0 keeps the constant StencilOperator), P/R are
    structured transfer objects, the coarsest level is a dense inverse.

    coarse_op="const": device coarse operators become constant
    StencilOperators carrying the RAP's interior stencil. The Galerkin RAP
    of a constant stencil under the structured transfer pair is EXACTLY
    constant except in the single outermost cell layer (verified
    numerically: deviation 0.0 everywhere at depth >= 1; the shell rows
    lose the out-and-back truncation paths, <= 14% of the max weight), so
    this is a boundary-shell perturbation of the coarse-grid operator
    only — the fine-grid problem, smoother scales (built from the exact
    CSR), and coarsest dense inverse stay exact, and the solve converges
    to the same solution with ~1-2 extra cycles (measured 17 vs 15 on
    40^3 to 1e-8). What it buys: coarse-level operators carry the
    stencil as 27 SCALARS instead of streaming 27 full coefficient planes
    from HBM per application — the coarse coefficient stream (3.4x the
    fine state per level-1 pass) was the dominant slice of the V-cycle's
    coarse time. This is the production struct-path configuration (the
    rediscretization tradition of geometric multigrid, with RAP interior
    weights instead of rediscretized ones); "var" keeps the exact RAP."""
    from amg_jax.setup.hierarchy import (
        Hierarchy,
        HostHierarchy,
        HostLevel,
        Level,
    )
    from amg_jax.setup.rap import estimate_rho_dinv_a
    from amg_jax.smooth import SmootherType, make_smoother_data
    from amg_jax.sparse.stencil import stencil_to_csr

    if params is not None:
        dtype = params.dtype
        smoother = params.smoother
        smooth_weight = params.smooth_weight
        max_levels = params.max_levels
        max_coarse_size = max(params.max_coarse_size, 8)
    if smoother is None:
        smoother = SmootherType.L1_JACOBI

    hh = HostHierarchy(params=params)
    shapes = [tuple(fine.grid_shape)]
    A_csr = stencil_to_csr(fine)
    dev_levels = []
    A_dev = StencilOperator(
        weights=jnp.asarray(np.asarray(fine.weights), dtype=dtype),
        offsets=fine.offsets,
        grid_shape=tuple(fine.grid_shape),
    )
    lvl = 0
    while True:
        shape = shapes[-1]
        hl = HostLevel(A=A_csr)
        if smooth_weight is not None:
            hl.weight = smooth_weight
        else:
            scale = None
            if smoother in (SmootherType.L1_JACOBI, SmootherType.SYM_L1_JACOBI):
                scale = A_csr.l1_row_norms()
            hl.weight = 1.0 / max(estimate_rho_dinv_a(A_csr, scale=scale), 1e-12)
        hh.levels.append(hl)
        # jgs_weight='auto' carries the divergence guard the algebraic
        # builder applies (hybrid JGS is only conditionally convergent
        # on elasticity-class operators) — round-4 fix: the DIA builder
        # previously dropped it, so JGS-smoothed DIA cycles diverged
        sm = make_smoother_data(
            A_csr, smoother, w=hl.weight, dtype=dtype,
            block_size=(params.block_size if params is not None else 128),
            jgs_weight=(getattr(params, 'jgs_weight', 'auto')
                        if params is not None else 'auto'),
        )
        n = A_csr.n_rows
        if n <= max_coarse_size or lvl == max_levels - 1 or min(shape) < 5:
            dev_levels.append(
                Level(A=A_dev, P=None, R=None, P_s=None, R_s=None,
                      R_inj=None, sm=sm)
            )
            break
        cshape = _coarse_shape(shape)
        P_csr = _structured_P_csr(shape, cshape)
        R_csr = P_csr.transpose()
        hl.P, hl.R = P_csr, R_csr
        Ac_csr = R_csr.matmul(A_csr).matmul(P_csr)
        # drop numerically-zero fill
        acs = Ac_csr.to_scipy()
        acs.data[np.abs(acs.data) < 1e-14 * np.abs(acs.data).max()] = 0.0
        acs.eliminate_zeros()
        Ac_csr = CSRMatrix.from_scipy(acs)
        P_dev = StructuredProlong(fine_shape=shape, coarse_shape=cshape)
        R_dev = StructuredRestrict(fine_shape=shape, coarse_shape=cshape)
        dev_levels.append(
            Level(A=A_dev, P=P_dev, R=R_dev, P_s=None, R_s=None,
                  R_inj=None, sm=sm)
        )
        A_csr = Ac_csr
        A_dev = _csr_to_var_stencil(Ac_csr, cshape, dtype)
        # "auto" applies the constant form only on levels with min side
        # >= 32: the coefficient stream only matters there (level-1's 27
        # planes are 3.4x the fine state per pass; at 32^3 they are
        # ~3.5 MB — microseconds), while the boundary-shell approximation
        # error GROWS as levels shrink (the shell is 6/side of the cells:
        # 19% at 32, 37% at 16 — measured: const at every level degrades
        # the 126^3 5-level cycle rate 0.42 -> 0.56, const at >= 32 only
        # costs ~1 cycle)
        if coarse_op == "const" or (
            coarse_op == "auto" and min(cshape) >= 32
        ):
            c = np.asarray(A_dev.coeffs)
            center = tuple(s // 2 for s in cshape)
            w = c[(slice(None),) + center]
            # guard the constancy claim: everything off the outer shell
            # must match the center row exactly (zero tolerance modulo
            # float noise) — "auto" falls back to the exact VarStencil,
            # "const" fails loudly
            ok = True
            if min(cshape) >= 5:
                inner = c[(slice(None),) + tuple(slice(1, -1) for _ in cshape)]
                dev = np.abs(inner - w.reshape((-1,) + (1,) * len(cshape)))
                ok = bool(dev.max() <= 1e-10 * np.abs(w).max())
                assert ok or coarse_op == "auto", (
                    "RAP interior is not constant — coarse_op='const' "
                    "does not apply to this transfer pair"
                )
            if ok:
                A_dev = StencilOperator(
                    weights=jnp.asarray(w, dtype), offsets=A_dev.offsets,
                    grid_shape=cshape,
                )
        shapes.append(cshape)
        lvl += 1
    coarse_Ainv = jnp.asarray(
        np.linalg.inv(hh.levels[-1].A.to_dense()), dtype=dtype
    )
    return hh, Hierarchy(levels=tuple(dev_levels), coarse_Ainv=coarse_Ainv)
