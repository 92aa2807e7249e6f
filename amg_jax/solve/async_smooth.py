"""Asynchronous one-level smoothing, including stochastic parallel Southwell.

Native model of the reference's finest-grid asynchronous relaxation family
(reference: DMEM_AsyncSmooth src/DMEM_Smooth.cpp:16-313): the domain is
partitioned into row blocks (the analog of MPI ranks / device shards), and
each step every block independently decides whether to relax its rows:

  fixed probability     fire ~ Bernoulli(p)          (async Jacobi et al.)
  Southwell exponential p = exp(-x * alpha)
  Southwell inverse     p = 1/(x * alpha)
  where x = number of NEIGHBOR blocks whose local residual L1-norm exceeds
  this block's — blocks with relatively large residuals relax eagerly
  (reference: StochasticParallelSouthwellUpdateProbability,
  src/DMEM_Smooth.cpp:548-572; neighbor norms ride the halo messages,
  src/DMEM_Comm.cpp:216-220).

Firing blocks apply one smoother sweep to their rows against the current
residual; the whole solve is one jitted lax.while_loop with a jax PRNG.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from amg_jax.smooth import SmootherData, SmootherType, smooth


@dataclass(frozen=True)
class AsyncSmoothConfig:
    smoother: SmootherType = SmootherType.L1_JACOBI
    num_blocks: int = 8  # rank/shard analog
    method: str = "southwell_exp"  # fixed | southwell_exp | southwell_inv
    sps_alpha: float = 1.0
    # > 0: derive each block's alpha from its neighbor count so the firing
    # probability at the worst rank (all neighbors larger) is exactly
    # sps_min_prob — the reference's -sps_min_prob,
    # alpha = -log(min_prob)/num_sends (src/DMEM_Setup.cpp:1168-1170)
    sps_min_prob: float = 0.0
    fire_prob: float = 0.5  # for method == "fixed"


class AsyncSmoothResult(NamedTuple):
    x: jnp.ndarray
    iters: jnp.ndarray
    rel_resnorm: jnp.ndarray
    history: jnp.ndarray
    block_updates: jnp.ndarray  # (B,) per-block relaxation counts


def block_neighbor_mask(A_csr, num_blocks: int) -> np.ndarray:
    """(B, B) bool: blocks coupled through A (excluding self) — the comm
    graph whose edges carry the Southwell residual-norm exchange."""
    n = A_csr.n_rows
    bs = -(-n // num_blocks)
    row_blocks = np.repeat(np.arange(n) // bs, np.diff(A_csr.indptr))
    col_blocks = A_csr.indices // bs
    m = np.zeros((num_blocks, num_blocks), dtype=bool)
    m[row_blocks, col_blocks] = True
    np.fill_diagonal(m, False)
    return m


def async_smooth_solve(
    A,
    sm: SmootherData,
    cfg: AsyncSmoothConfig,
    neighbor_mask: np.ndarray,
    b: jnp.ndarray,
    x0: Optional[jnp.ndarray] = None,
    key: Optional[jax.Array] = None,
    tol: float = 1e-8,
    max_cycles: int = 2000,
) -> AsyncSmoothResult:
    if x0 is None:
        x0 = jnp.zeros_like(b)
    if key is None:
        key = jax.random.PRNGKey(0)
    fn = jax.jit(
        _loop, static_argnames=("cfg", "tol", "max_cycles")
    )
    return fn(A, sm, cfg, jnp.asarray(neighbor_mask), b, x0, key, tol, max_cycles)


def _loop(A, sm, cfg, nbr, b, x0, key, tol, max_cycles):
    n = b.shape[0]
    B = cfg.num_blocks
    bs = -(-n // B)
    dtype = b.dtype
    # row → block segment ids (static)
    seg = jnp.asarray(np.arange(n) // bs, dtype=jnp.int32)

    r0 = b - A @ x0
    r0n = jnp.linalg.norm(r0)
    safe_r0 = jnp.where(r0n == 0.0, 1.0, r0n)
    hist0 = jnp.full((max_cycles + 1,), jnp.nan, dtype=dtype)
    hist0 = hist0.at[0].set(1.0)

    def body(state):
        x, k, relnorm, hist, counts, key = state
        key, kf = jax.random.split(key)
        r = b - A @ x
        # per-block residual L1 norms
        rnorms = jax.ops.segment_sum(jnp.abs(r), seg, num_segments=B)
        if cfg.method == "fixed":
            p = jnp.full((B,), cfg.fire_prob, dtype)
        else:
            # x_b = #neighbors with larger block residual norm
            bigger = (rnorms[None, :] > rnorms[:, None]) & nbr
            xcount = jnp.sum(bigger, axis=1).astype(dtype)
            if cfg.sps_min_prob > 0.0:
                # per-block alpha from the neighbor degree: the worst rank
                # (every neighbor larger) fires with exactly sps_min_prob
                # (reference: src/DMEM_Setup.cpp:1168-1170)
                deg = jnp.maximum(jnp.sum(nbr, axis=1).astype(dtype), 1.0)
                alpha = -jnp.log(cfg.sps_min_prob) / deg
            else:
                alpha = cfg.sps_alpha
            if cfg.method == "southwell_inv":
                p = 1.0 / jnp.maximum(xcount * alpha, 1.0)
            else:  # southwell_exp
                p = jnp.exp(-xcount * alpha)
        fire = jax.random.uniform(kf, (B,), dtype) < p
        x_new = smooth(A, sm, cfg.smoother, x, b, num_sweeps=1)
        du = x_new - x
        x = x + jnp.where(fire[seg], du, 0.0)
        counts = counts + fire.astype(jnp.int32)
        r_true = b - A @ x
        relnorm = jnp.linalg.norm(r_true) / safe_r0
        hist = hist.at[k + 1].set(relnorm)
        return (x, k + 1, relnorm, hist, counts, key)

    def cond(state):
        _, k, relnorm, _, _, _ = state
        return (k < max_cycles) & (relnorm > tol)

    state = (
        x0, jnp.asarray(0, jnp.int32), jnp.asarray(jnp.inf, dtype),
        hist0, jnp.zeros(B, jnp.int32), key,
    )
    x, it, relnorm, hist, counts, _ = jax.lax.while_loop(cond, body, state)
    return AsyncSmoothResult(
        x=x, iters=it, rel_resnorm=relnorm, history=hist, block_updates=counts
    )
