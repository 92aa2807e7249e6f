"""Outer PCG with any cycle as the preconditioner.

The reference injects its cycles into hypre's PCG as function pointers
(reference: src/DMEM_Setup.cpp:129-167,596-607; src/SMEM_Main.cpp:697-723).
Here the preconditioner is any callable M(r) -> z (typically one V-cycle or
additive cycle from a zero initial guess), and PCG itself is a jittable
lax.while_loop.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from amg_jax.ops.vector import axpy, dot, l2_norm


class PCGResult(NamedTuple):
    x: jnp.ndarray
    iters: jnp.ndarray
    rel_resnorm: jnp.ndarray
    history: jnp.ndarray  # per-iteration relative residual norms (nan-padded)


def pcg(
    matvec: Callable,
    precond: Callable,
    b: jnp.ndarray,
    x0: jnp.ndarray,
    tol: float = 1e-8,
    max_iters: int = 100,
) -> PCGResult:
    r0 = b - matvec(x0)
    bnorm = l2_norm(r0)
    safe_bnorm = jnp.where(bnorm == 0.0, 1.0, bnorm)
    z0 = precond(r0)
    history0 = jnp.full((max_iters + 1,), jnp.nan, dtype=b.dtype)
    history0 = history0.at[0].set(1.0)

    def cond(state):
        x, r, z, p, rz, it, hist = state
        return (it < max_iters) & (l2_norm(r) / safe_bnorm > tol)

    def body(state):
        x, r, z, p, rz, it, hist = state
        Ap = matvec(p)
        alpha = rz / dot(p, Ap)
        x = axpy(alpha, p, x)
        r = axpy(-alpha, Ap, r)
        z = precond(r)
        rz_new = dot(r, z)
        beta = rz_new / rz
        p = axpy(beta, p, z)
        hist = hist.at[it + 1].set(l2_norm(r) / safe_bnorm)
        return (x, r, z, p, rz_new, it + 1, hist)

    init = (x0, r0, z0, z0, dot(r0, z0), jnp.asarray(0, jnp.int32), history0)
    x, r, _, _, _, it, hist = jax.lax.while_loop(cond, body, init)
    return PCGResult(
        x=x, iters=it, rel_resnorm=l2_norm(r) / safe_bnorm, history=hist
    )


def ds_pcg(
    A,
    precond: Callable,
    b,
    x0,
    tol: float = 1e-8,
    max_iters: int = 100,
) -> PCGResult:
    """PCG with double-single (two-f32, ~48-bit) state on an f32-only
    device — the emulated-f64 Krylov solve for operators whose condition
    number defeats plain f32 CG (kappa * eps_f32 >~ 1, e.g. the 157k-dof
    elasticity beam where f32 PCG's first correction has no correct
    digits while f64 PCG converges in ~19 iterations; reference PCG:
    src/DMEM_Setup.cpp:129-167).

    x, r, p are DS vectors with compensated axpy recurrences; the matvec
    applies the operator as a double-single coefficient pair (A_hi, A_lo)
    via ops/ds.py::ds_matvec; dot products are Dekker-compensated. Only
    the PRECONDITIONER runs in plain f32 (one V-cycle on the f32
    hierarchy) — its rounding perturbs the trajectory, never the
    attainable accuracy. b, x0: DS vectors. Returns x as a DS pair packed
    in PCGResult.x = (hi, lo)."""
    from amg_jax.ops.ds import (
        ds_dot,
        ds_from,
        ds_matvec,
        ds_residual,
        ds_scale_add,
        ds_to_float,
    )

    r0 = ds_residual(A, b, x0)
    bnorm = l2_norm(ds_to_float(r0))
    safe_bnorm = jnp.where(bnorm == 0.0, 1.0, bnorm)
    z0 = precond(ds_to_float(r0))
    history0 = jnp.full((max_iters + 1,), jnp.nan, dtype=jnp.float32)
    history0 = history0.at[0].set(1.0)

    def cond(state):
        x, r, p, rz, it, hist = state
        return (it < max_iters) & (
            l2_norm(ds_to_float(r)) / safe_bnorm > tol
        )

    def body(state):
        x, r, p, rz, it, hist = state
        Ap = ds_matvec(A, p)
        alpha = rz / ds_dot(p, Ap)
        x = ds_scale_add(x, alpha, p)
        r = ds_scale_add(r, -alpha, Ap)
        z = precond(ds_to_float(r))
        rz_new = ds_dot(r, z)
        beta = rz_new / rz
        p = ds_scale_add(ds_from(z), beta, p)
        hist = hist.at[it + 1].set(l2_norm(ds_to_float(r)) / safe_bnorm)
        return (x, r, p, rz_new, it + 1, hist)

    init = (
        x0, r0, ds_from(z0), ds_dot(r0, z0), jnp.asarray(0, jnp.int32),
        history0,
    )
    x, r, _, _, it, hist = jax.lax.while_loop(cond, body, init)
    return PCGResult(
        x=(x.hi, x.lo),
        iters=it,
        rel_resnorm=l2_norm(ds_to_float(r)) / safe_bnorm,
        history=hist,
    )
