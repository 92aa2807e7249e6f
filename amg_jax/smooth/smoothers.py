"""The smoother family.

Re-implements every smoother of the reference (reference:
src/SEQ_Smooth.cpp, src/SMEM_Smooth.cpp, src/DMEM_Smooth.cpp:574-638) as pure
functions over a precomputed per-level `SmootherData` pytree:

  JACOBI / L1_JACOBI    u += w*S^-1 (f - A u),  S = diag(A) or L1 row norms
  HYBRID_JGS            Gauss-Seidel within fixed row blocks, Jacobi across
                        blocks — the reference's thread-block hybrid
                        (reference: src/SMEM_Smooth.cpp:222-305). The
                        within-block sequential solve becomes a precomputed
                        dense inverse of (D + tril(A_block)) applied as one
                        batched matmul: bit-exact hybrid-JGS
                        semantics with block = "thread".
  HYBRID_JGS_BACKWARD   the transposed variant (D + triu(A_block))^-1
                        (reference: src/SMEM_Smooth.cpp:307-363)
  GS                    exact sequential Gauss-Seidel, realized as
                        HYBRID_JGS with one block spanning the matrix (small
                        n parity path) or via lax.scan row recurrence.
  SYM_JACOBI /          the SPD-preserving symmetrized sweep
  SYM_L1_JACOBI         e = w S^-1 (2S/w - A) w S^-1 r, used by additive
                        cycles with pre+post smoothing (reference:
                        src/SEQ_Smooth.cpp:119-189, src/DMEM_Smooth.cpp:619-637)

Asynchronous execution (async Jacobi / async GS / Southwell) is not a kernel
property here: the same kernels are driven by the bounded-staleness scheduler
in `amg_jax.solve.async_sim` / `amg_jax.parallel`, mirroring how the
reference's async smoothers are its sync kernels minus the barriers.
"""

from __future__ import annotations

import enum
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from amg_jax.dtypes import SETUP_DTYPE


class SmootherType(enum.Enum):
    JACOBI = "jacobi"
    L1_JACOBI = "l1_jacobi"
    HYBRID_JGS = "hybrid_jgs"
    HYBRID_JGS_BACKWARD = "hybrid_jgs_backward"
    GS = "gs"
    SYM_JACOBI = "sym_jacobi"
    SYM_L1_JACOBI = "sym_l1_jacobi"


# Smoothers whose error propagator is symmetric in the A inner product —
# required by additive cycles with pre+post sweeps (reference uses the
# symmetrized forms there, src/SMEM_Setup.cpp:1173-1254).
SYMMETRIC_TYPES = (SmootherType.SYM_JACOBI, SmootherType.SYM_L1_JACOBI)


class SmootherData(NamedTuple):
    """Per-level precomputed smoother state (a pytree of device arrays).

    scale:      (n,) — S = diag(A) (Jacobi flavors) or L1 row norms.
    inv_wscale: (n,) — w / S, the multiplier applied to residuals.
    w:          ()  — damping weight.
    block_inv:  (nblocks, bs, bs) or None — inverse of (D + tril of the
                bs×bs diagonal blocks of A), identity-padded past n.
    block_inv_bwd: same for the upper-triangular (transposed) sweep.
    """

    scale: jnp.ndarray
    inv_wscale: jnp.ndarray
    w: jnp.ndarray
    block_inv: Optional[jnp.ndarray]
    block_inv_bwd: Optional[jnp.ndarray]


def make_smoother_data(
    A_csr,
    smoother: SmootherType,
    w: float = 1.0,
    block_size: int = 128,
    dtype=jnp.float64,
    jgs_weight=None,
) -> SmootherData:
    """Precompute SmootherData from the host CSR matrix at setup time
    (the analog of the reference's scale arrays, src/DMEM_Setup.cpp:391-485)."""
    diag = A_csr.diagonal().astype(SETUP_DTYPE)
    if smoother in (SmootherType.L1_JACOBI, SmootherType.SYM_L1_JACOBI):
        scale = A_csr.l1_row_norms()
    else:
        scale = diag
    # guard empty/zero rows (padded or disconnected): unit scale
    scale = np.where(scale == 0.0, 1.0, scale)
    block_inv = block_inv_bwd = None
    if smoother in (
        SmootherType.HYBRID_JGS,
        SmootherType.HYBRID_JGS_BACKWARD,
        SmootherType.GS,
    ):
        n = A_csr.n_rows
        bs = n if smoother == SmootherType.GS else min(block_size, n)
        nblocks = -(-n // bs)
        s = A_csr.to_scipy()

        def tri_inverses(upper: bool) -> np.ndarray:
            out = np.tile(np.eye(bs, dtype=SETUP_DTYPE), (nblocks, 1, 1))
            for b in range(nblocks):
                lo, hi = b * bs, min((b + 1) * bs, n)
                blk = s[lo:hi, lo:hi].toarray()
                tri = np.triu(blk) if upper else np.tril(blk)
                m = hi - lo
                d = np.diag(blk)
                np.fill_diagonal(tri, np.where(d == 0.0, 1.0, d))
                tgt = out[b]  # identity-padded past n
                tgt[:m, :m] = tri
                out[b] = np.linalg.inv(tgt)
            return out

        inv_fwd = tri_inverses(upper=False)
        inv_bwd = tri_inverses(upper=True)
        # hybrid JGS is block-Jacobi across blocks and only *conditionally*
        # convergent (diverges on elasticity-class matrices); jgs_weight
        # damps it: du = w_jgs * (D+L_blk)^-1 r. "auto" = 1/rho(M^-1 A) by
        # host power iteration (the analog of hypre's relax weight the
        # reference exposes as -smooth_weight, src/SMEM_Main.cpp:409-428).
        if jgs_weight == "auto":
            rng = np.random.default_rng(0)
            s_op = A_csr.to_scipy()

            def apply_MinvA(v):
                y = s_op @ v
                yp = np.zeros(nblocks * bs)
                yp[:n] = y
                yp = yp.reshape(nblocks, bs)
                return np.einsum("bij,bj->bi", inv_fwd, yp).reshape(-1)[:n]

            def rho_power(apply_fn, iters=50):
                x = rng.standard_normal(n)
                lam = 0.0
                for _ in range(iters):
                    y = apply_fn(x)
                    nrm = np.linalg.norm(y)
                    if nrm == 0.0:
                        return 0.0
                    lam = nrm / np.linalg.norm(x)
                    x = y / nrm
                return lam

            rho_E = rho_power(lambda v: v - apply_MinvA(v))
            if rho_E <= 1.02:
                jgs_w = 1.0  # already convergent: exact undamped semantics
            else:
                jgs_w = 1.0 / max(rho_power(apply_MinvA), 1.0)
        else:
            jgs_w = 1.0 if jgs_weight is None else float(jgs_weight)
        block_inv = jnp.asarray(jgs_w * inv_fwd, dtype=dtype)
        block_inv_bwd = jnp.asarray(jgs_w * inv_bwd, dtype=dtype)
    return SmootherData(
        scale=jnp.asarray(scale, dtype=dtype),
        inv_wscale=jnp.asarray(w / scale, dtype=dtype),
        w=jnp.asarray(w, dtype=dtype),
        block_inv=block_inv,
        block_inv_bwd=block_inv_bwd,
    )


def _block_solve(block_inv: jnp.ndarray, r: jnp.ndarray) -> jnp.ndarray:
    """Apply the batched dense (D+L_block)^-1 to r: one batched matmul."""
    nblocks, bs, _ = block_inv.shape
    n = r.shape[0]
    npad = nblocks * bs
    rp = jnp.pad(r, (0, npad - n)).reshape(nblocks, bs)
    # HIGHEST: without it a float32 product may run in TF32 on the GPU
    out = jnp.einsum(
        "bij,bj->bi", block_inv, rp, preferred_element_type=rp.dtype,
        precision=jax.lax.Precision.HIGHEST,
    )
    return out.reshape(npad)[:n]


def _one_sweep(A, sm: SmootherData, smoother: SmootherType, u, f, zero_guess):
    """u_{new} = u + M^-1 (f - A u); zero_guess skips the matvec
    (the reference's zero_flags fast path, src/SEQ_Smooth.cpp:14-24)."""
    r = f if zero_guess else f - (A @ u)
    if smoother in (SmootherType.JACOBI, SmootherType.L1_JACOBI):
        du = sm.inv_wscale * r
    elif smoother in (SmootherType.HYBRID_JGS, SmootherType.GS):
        du = _block_solve(sm.block_inv, r)
    elif smoother == SmootherType.HYBRID_JGS_BACKWARD:
        du = _block_solve(sm.block_inv_bwd, r)
    elif smoother in SYMMETRIC_TYPES:
        # e = w S^-1 (2 S/w t - A t),  t = w S^-1 r  — SPD symmetrized sweep
        t = sm.inv_wscale * r
        du = 2.0 * t - sm.inv_wscale * (A @ t)
    else:
        raise ValueError(f"unknown smoother {smoother}")
    return (du if zero_guess else u + du)


def smooth(
    A,
    sm: SmootherData,
    smoother: SmootherType,
    u: jnp.ndarray,
    f: jnp.ndarray,
    num_sweeps: int = 1,
    zero_guess: bool = False,
):
    """Run `num_sweeps` smoothing sweeps (num_sweeps is static → unrolled)."""
    for s in range(num_sweeps):
        u = _one_sweep(A, sm, smoother, u, f, zero_guess and s == 0)
    return u


def smooth_transpose(
    A,
    sm: SmootherData,
    smoother: SmootherType,
    u: jnp.ndarray,
    f: jnp.ndarray,
    num_sweeps: int = 1,
    zero_guess: bool = False,
):
    """The adjoint sweep (backward ordering), used as the post-smoother to
    keep cycles symmetric (reference: src/SMEM_Smooth.cpp:307-363 transposed
    hybrid JGS; Jacobi flavors are self-adjoint in the S inner product)."""
    t = {
        SmootherType.HYBRID_JGS: SmootherType.HYBRID_JGS_BACKWARD,
        SmootherType.HYBRID_JGS_BACKWARD: SmootherType.HYBRID_JGS,
    }.get(smoother, smoother)
    return smooth(A, sm, t, u, f, num_sweeps, zero_guess)


def gs_scan_sweep(ell, diag, u, f):
    """Exact sequential Gauss-Seidel via lax.scan over rows on an ELLMatrix —
    the semantics-reference path for tests (O(n) sequential steps; not a
    production kernel). Mirrors src/SEQ_Smooth.cpp:89-117."""

    cols, vals = ell.cols, ell.vals

    def body(u, i):
        row_c = cols[i]
        row_v = vals[i]
        acc = jnp.sum(row_v * u[row_c]) - diag[i] * u[i]
        ui = (f[i] - acc) / diag[i]
        return u.at[i].set(ui), ()

    u, _ = jax.lax.scan(body, u, jnp.arange(ell.n_rows))
    return u
