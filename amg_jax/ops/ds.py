"""Double-single (two-float) compensated arithmetic for mixed precision.

Iterative refinement of float32 solves to 1e-8 relative residuals needs
better-than-f32 state and residual evaluation. Double-single arithmetic
provides it from float32 operations alone: a value is an unevaluated sum hi + lo of two f32s
(~48 significant bits), with error-free transformations (Knuth TwoSum)
keeping the low parts exact.

Used by amg_jax.solve.mixed.mixed_pcg: the solution is stored as (hi, lo),
and the fine-grid residual r = b - A x is evaluated with compensated tap
summation, so refinement with f32 V-cycles converges to ~1e-9 relative
instead of the plain-f32 ~1e-5 floor.

The transforms are exact only if every operation rounds on its own: a
compiler that fuses a multiply and an add into one FMA, or reassociates a
sum, breaks them. `chip_smoke.py` checks on the GPU that they stay exact.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax.numpy as jnp


class DS(NamedTuple):
    """Double-single number/vector: value = hi + lo (|lo| <= ulp(hi)/2)."""

    hi: jnp.ndarray
    lo: jnp.ndarray


def two_sum(a, b):
    """Error-free: s + e == a + b exactly (Knuth)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


_SPLIT = 4097.0  # 2^12 + 1 (Dekker split factor for f32's 24-bit mantissa)


def _split(a):
    c = _SPLIT * a
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a, b):
    """Error-free: p + e == a * b exactly (Dekker, no FMA needed)."""
    p = a * b
    a_hi, a_lo = _split(a)
    b_hi, b_lo = _split(b)
    e = ((a_hi * b_hi - p) + a_hi * b_lo + a_lo * b_hi) + a_lo * b_lo
    return p, e


def ds_from(x) -> DS:
    return DS(hi=x, lo=jnp.zeros_like(x))


def ds_renorm(hi, lo) -> DS:
    s, e = two_sum(hi, lo)
    return DS(hi=s, lo=e)


def ds_add_float(x: DS, y) -> DS:
    """x + y for f32 y."""
    s, e = two_sum(x.hi, y)
    return ds_renorm(s, e + x.lo)


def ds_add(x: DS, y: DS) -> DS:
    s, e = two_sum(x.hi, y.hi)
    return ds_renorm(s, e + x.lo + y.lo)


def ds_neg(x: DS) -> DS:
    return DS(hi=-x.hi, lo=-x.lo)


def ds_to_float(x: DS):
    return x.hi + x.lo


def stencil_matvec_comp(A, x) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """y = A @ x for a (Var)StencilOperator with compensated products
    (Dekker TwoProd) and compensated tap summation (TwoSum): returns
    (y_hi, y_err) with y_hi + y_err accurate to ~f32 eps^2."""
    grid = x.reshape(A.grid_shape)
    nd = len(A.grid_shape)
    pads = [
        (
            max(abs(o[d]) for o in A.offsets),
            max(abs(o[d]) for o in A.offsets),
        )
        for d in range(nd)
    ]
    padded = jnp.pad(grid, pads)
    acc = jnp.zeros_like(grid)
    comp = jnp.zeros_like(grid)
    var = hasattr(A, "coeffs")
    for t, off in enumerate(A.offsets):
        idx = tuple(
            slice(pads[d][0] + off[d], pads[d][0] + off[d] + A.grid_shape[d])
            for d in range(nd)
        )
        w = A.coeffs[t] if var else A.weights[t]
        term, perr = two_prod(w, padded[idx])
        acc, e = two_sum(acc, term)
        comp = comp + e + perr
    return acc.reshape(x.shape), comp.reshape(x.shape)


def ell_matvec_comp(a, x) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Compensated ELL SpMV: TwoProd per slot + TwoSum accumulation over the
    (static, small) slot axis. Returns (y_hi, y_err)."""
    gathered = x[a.cols]  # (n, k)
    acc = jnp.zeros(a.cols.shape[0], x.dtype)
    comp = jnp.zeros_like(acc)
    for slot in range(a.k):
        term, perr = two_prod(a.vals[:, slot], gathered[:, slot])
        acc, e = two_sum(acc, term)
        comp = comp + e + perr
    return acc, comp


def bsr_matvec_comp(a, x) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Compensated BSR SpMV: block-gather once, then TwoProd + TwoSum over
    the kb×bn scalar slots of each (row-block, row) — the exact blocked
    analog of `ell_matvec_comp`. Returns (y_hi, y_err)."""
    n, m = a.shape
    bn = a.bn
    ncb = -(-m // bn)
    xp = jnp.pad(x, (0, ncb * bn - m)) if ncb * bn != m else x
    g = xp.reshape(ncb, bn)[a.block_cols]  # (nrb, kb, bn)
    acc = jnp.zeros((a.nrb, a.bm), x.dtype)
    comp = jnp.zeros_like(acc)
    for k in range(a.kb):
        for j in range(bn):
            term, perr = two_prod(a.blocks[:, k, :, j], g[:, k, None, j])
            acc, e = two_sum(acc, term)
            comp = comp + e + perr
    acc, comp = acc.reshape(-1), comp.reshape(-1)
    return acc[:n], comp[:n]


def matvec_comp(A, x) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Dispatch the compensated matvec by operator type."""
    if hasattr(A, "cols"):  # ELLMatrix
        return ell_matvec_comp(A, x)
    if hasattr(A, "block_cols"):  # BSRMatrix
        return bsr_matvec_comp(A, x)
    return stencil_matvec_comp(A, x)


def ds_scale_add(y: DS, alpha, x: DS) -> DS:
    """y + alpha * x with f32 scalar alpha and DS vectors — the axpy of
    the double-single Krylov recurrences (compensated product of the hi
    part, plain product of the lo part)."""
    p, pe = two_prod(alpha, x.hi)
    s, e = two_sum(y.hi, p)
    return ds_renorm(s, e + y.lo + pe + alpha * x.lo)


def ds_dot(a: DS, b) -> jnp.ndarray:
    """Compensated dot product of a DS vector with an f32 or DS vector,
    returned as f32: Dekker TwoProd on the leading products, the error
    terms and cross terms summed separately (each XLA tree-reduce keeps
    ~eps*log n relative on its own magnitude scale)."""
    if isinstance(b, DS):
        p, pe = two_prod(a.hi, b.hi)
        small = pe + a.hi * b.lo + a.lo * b.hi
    else:
        p, pe = two_prod(a.hi, b)
        small = pe + a.lo * b
    return jnp.sum(p) + jnp.sum(small)


def ds_matvec(A, x: DS) -> DS:
    """y = A x with DS x and an operator given as a single op or an
    (A_hi, A_lo) double-single coefficient pair: compensated matvec of
    the leading term, plain matvecs of the three small terms. Accurate to
    ~f32 eps^2 relative — the matvec of the DS Krylov recurrences."""
    if isinstance(A, tuple):
        A_hi, A_lo = A
        y_hi, y_err = matvec_comp(A_hi, x.hi)
        small = y_err + (A_lo @ x.hi) + (A_hi @ x.lo)
    else:
        y_hi, y_err = matvec_comp(A, x.hi)
        small = y_err + (A @ x.lo)
    return ds_renorm(y_hi, small)


def ds_residual(A, b: DS, x: DS) -> DS:
    """r = b - A x with x, b, r in double-single. A x evaluated as a
    compensated matvec of hi plus a plain matvec of lo.

    A may be a single operator (f32 coefficients: r is exact wrt the
    ROUNDED operator) or an (A_hi, A_lo) pair of operators whose f32
    coefficient sum represents the f64 matrix (double-single operator:
    r is then accurate wrt the TRUE operator — required when kappa(A) is
    large enough that the 1e-7 coefficient rounding times ||x|| dominates
    a converged residual, e.g. the 157k-dof elasticity beam)."""
    if isinstance(A, tuple):
        A_hi, A_lo = A
        y_hi, y_err = matvec_comp(A_hi, x.hi)
        # low-order terms need only plain f32 accuracy (each is ~1e-7 of
        # the leading term; their own rounding is ~1e-14 relative)
        y_small = (A_lo @ x.hi) + (A_hi @ x.lo)
        s, e = two_sum(b.hi, -y_hi)
        return ds_renorm(s, b.lo - y_err - y_small + e)
    y_hi, y_err = matvec_comp(A, x.hi)
    y_lo = A @ x.lo
    s, e = two_sum(b.hi, -y_hi)
    small = b.lo - y_err - y_lo + e
    return ds_renorm(s, small)
