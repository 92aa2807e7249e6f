"""The structured solve path as XLA compiles it, against float64 scipy.

The constant-stencil matvec, the (L1-)Jacobi sweep chains, the structured
transfers and the multiplicative V-cycle are plain jnp code on every
platform. Each is checked here against an independent float64 reference
built from the assembled host matrices (scipy CSR and the assembled P).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from amg_jax.problems import difconv_3d, laplacian_3d_7pt, laplacian_3d_27pt
from amg_jax.setup.structured import (
    StructuredProlong,
    StructuredRestrict,
    _structured_P_csr,
    build_structured_hierarchy,
)
from amg_jax.smooth import SmootherType, make_smoother_data, smooth
from amg_jax.solve import CycleConfig, CycleType
from amg_jax.solve.cycles import mult_vcycle
from amg_jax.sparse.stencil import StencilOperator, stencil_to_csr

CASES = [
    ("27pt-box", lambda: laplacian_3d_27pt(8).stencil),
    ("7pt", lambda: laplacian_3d_7pt(6, 7, 5, cx=1.0, cy=2.0, cz=0.5).stencil),
    ("difconv", lambda: difconv_3d(6, atype=2, ax=-1.5).stencil),
]


def _op(st):
    return StencilOperator(
        weights=jnp.asarray(np.asarray(st.weights), jnp.float64),
        offsets=st.offsets, grid_shape=st.grid_shape,
    )


def _jacobi_ref(A, u, f, scale, k, zero_guess=False):
    u = np.zeros_like(f) if zero_guess else np.array(u)
    for _ in range(k):
        u = u + scale * (f - A @ u)
    return u


@pytest.mark.parametrize("name,gen", CASES, ids=[c[0] for c in CASES])
def test_spmv_matches_assembled(name, gen):
    st = gen()
    n = int(np.prod(st.grid_shape))
    x = np.random.default_rng(0).random(n)
    y = jax.jit(lambda a, v: a @ v)(_op(st), jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(y), stencil_to_csr(st) @ x,
                               atol=1e-12)


def test_jacobi_sweep_matches_assembled():
    st = laplacian_3d_27pt(8).stencil
    A = stencil_to_csr(st).to_scipy()
    rng = np.random.default_rng(1)
    u, b = rng.random(512), rng.random(512)
    alpha = 2.0 / 3.0 / 52.0
    got = jax.jit(lambda a, u_, b_: u_ + alpha * (b_ - a @ u_))(
        _op(st), jnp.asarray(u), jnp.asarray(b)
    )
    np.testing.assert_allclose(np.asarray(got), u + alpha * (b - A @ u),
                               atol=1e-12)


@pytest.mark.parametrize("k", [2, 3, 4])
@pytest.mark.parametrize("shape", [(10, 10, 10), (8, 9, 7)],
                         ids=["10x10x10", "8x9x7"])
@pytest.mark.parametrize("smoother", ["l1_jacobi", "jacobi"])
def test_ksweep_matches_assembled(k, shape, smoother):
    """k chained sweeps through smooth() (per-point L1 scale, or the scalar
    weighted-Jacobi scale) equal k sweeps on the host CSR, on cubic and
    uneven grids."""
    st = laplacian_3d_27pt(*shape).stencil
    Ah = stencil_to_csr(st)
    stype = SmootherType(smoother)
    sm = make_smoother_data(Ah, stype, w=0.6, dtype=jnp.float64)
    rng = np.random.default_rng(100 + k)
    u, f = rng.random(Ah.n_rows), rng.random(Ah.n_rows)
    got = smooth(_op(st), sm, stype, jnp.asarray(u), jnp.asarray(f),
                 num_sweeps=k)
    want = _jacobi_ref(Ah.to_scipy(), u, f, np.asarray(sm.inv_wscale), k)
    np.testing.assert_allclose(np.asarray(got), want, atol=1e-12)


@pytest.mark.parametrize("smoother", ["l1_jacobi", "jacobi"])
def test_zero_guess_sweeps_match_assembled(smoother):
    """zero_guess skips the first matvec; the result equals sweeping from
    u = 0 on the host."""
    st = laplacian_3d_27pt(9, 8, 7).stencil
    Ah = stencil_to_csr(st)
    stype = SmootherType(smoother)
    sm = make_smoother_data(Ah, stype, w=0.6, dtype=jnp.float64)
    f = np.random.default_rng(5).random(Ah.n_rows)
    got = smooth(_op(st), sm, stype, jnp.zeros(Ah.n_rows), jnp.asarray(f),
                 num_sweeps=3, zero_guess=True)
    want = _jacobi_ref(Ah.to_scipy(), None, f, np.asarray(sm.inv_wscale), 3,
                       zero_guess=True)
    np.testing.assert_allclose(np.asarray(got), want, atol=1e-12)


def _transfer_setup(n=20):
    st = laplacian_3d_27pt(n).stencil
    Ah = stencil_to_csr(st)
    fs = tuple(st.grid_shape)
    cs = tuple((s + 1) // 2 for s in fs)
    P = _structured_P_csr(fs, cs).to_scipy()
    sm = make_smoother_data(Ah, SmootherType.L1_JACOBI, w=0.7,
                            dtype=jnp.float64)
    return st, Ah.to_scipy(), fs, cs, P, sm


@pytest.mark.parametrize("zero_guess", [False, True])
def test_residual_restrict_matches_assembled(zero_guess):
    """Residual followed by full-weighting restriction, as the V-cycle
    composes them (zero_guess: after one sweep from u = 0), against
    P^T (b - A u) on the host."""
    st, A, fs, cs, P, sm = _transfer_setup()
    rng = np.random.default_rng(0)
    x, b = rng.random(A.shape[0]), rng.random(A.shape[0])
    R_dev = StructuredRestrict(fine_shape=fs, coarse_shape=cs)
    s = np.asarray(sm.inv_wscale)
    u = s * b if zero_guess else x

    def f(a, u_, b_):
        return R_dev @ (b_ - a @ u_)

    got = jax.jit(f)(_op(st), jnp.asarray(u), jnp.asarray(b))
    np.testing.assert_allclose(np.asarray(got), P.T @ (b - A @ u),
                               atol=1e-12)


@pytest.mark.parametrize("zero_guess", [False, True])
def test_prolong_sweep_matches_assembled(zero_guess):
    """Prolongation, correction and a post-sweep, as the V-cycle composes
    them (zero_guess: the fine iterate is one sweep from u = 0)."""
    st, A, fs, cs, P, sm = _transfer_setup()
    rng = np.random.default_rng(1)
    x, b = rng.random(A.shape[0]), rng.random(A.shape[0])
    ec = rng.random(P.shape[1])
    s = np.asarray(sm.inv_wscale)
    x1 = s * b if zero_guess else x
    P_dev = StructuredProlong(fine_shape=fs, coarse_shape=cs)

    def f(a, sm_, x_, b_, e_):
        u = x_ + P_dev @ e_
        return smooth(a, sm_, SmootherType.L1_JACOBI, u, b_, 1)

    got = jax.jit(f)(_op(st), sm, jnp.asarray(x1), jnp.asarray(b),
                     jnp.asarray(ec))
    u = x1 + P @ ec
    np.testing.assert_allclose(np.asarray(got), u + s * (b - A @ u),
                               atol=1e-12)


def _vcycle_ref(hh, hier, cfg, x, b):
    """Multiplicative V(pre, post) cycle in float64 with scipy from the
    host levels (assembled A, P = R^T) and the same smoother scales."""
    As = [lv.A.to_scipy() for lv in hh.levels]
    Ps = [lv.P.to_scipy() if lv.P is not None else None for lv in hh.levels]
    scales = [np.asarray(lv.sm.inv_wscale) for lv in hier.levels]
    Ainv = np.asarray(hier.coarse_Ainv)

    def cycle(k, x, f, zero):
        if k == len(As) - 1:
            return Ainv @ f
        u = _jacobi_ref(As[k], x, f, scales[k], cfg.num_pre_sweeps, zero)
        if cfg.num_pre_sweeps == 0 and zero:
            u = np.zeros_like(f)
        r = f - As[k] @ u
        ec = cycle(k + 1, None, Ps[k].T @ r, True)
        u = u + Ps[k] @ ec
        return _jacobi_ref(As[k], u, f, scales[k], cfg.num_post_sweeps)

    return cycle(0, x, b, False)


@pytest.mark.parametrize(
    "pre,post,smoother",
    [(1, 1, "l1_jacobi"), (0, 2, "l1_jacobi"), (3, 2, "l1_jacobi"),
     (3, 2, "jacobi")],
    ids=["V11-l1", "V02-l1", "V32-l1", "V32-jacobi"],
)
def test_vcycle_matches_scipy_reference(pre, post, smoother):
    """Two V-cycles of the structured hierarchy (device operators, exact
    RAP coarse levels) equal the scipy V-cycle on the host levels."""
    prob = laplacian_3d_27pt(12)
    stype = SmootherType(smoother)
    hh, hier = build_structured_hierarchy(
        prob.stencil, smoother=stype, coarse_op="var"
    )
    cfg = CycleConfig(cycle=CycleType.MULT, smoother=stype,
                      num_pre_sweeps=pre, num_post_sweeps=post)
    b = np.random.default_rng(0).random(prob.n)
    x = jnp.zeros(prob.n)
    xr = np.zeros(prob.n)
    step = jax.jit(lambda h, x_, b_: mult_vcycle(h, cfg, x_, b_))
    for _ in range(2):
        x = step(hier, x, jnp.asarray(b))
        xr = _vcycle_ref(hh, hier, cfg, xr, b)
    np.testing.assert_allclose(np.asarray(x), xr, atol=1e-11)


def test_fixed_cycle_loop_matches_python_loop():
    """k cycles inside one jitted fori_loop (how bench.py times a cycle)
    produce the iterate of k separately dispatched cycles."""
    prob = laplacian_3d_27pt(12)
    _, hier = build_structured_hierarchy(
        prob.stencil, smoother=SmootherType.L1_JACOBI
    )
    cfg = CycleConfig(cycle=CycleType.MULT, smoother=SmootherType.L1_JACOBI)
    b = jnp.asarray(np.random.default_rng(0).random(prob.n))
    k = 5
    looped = jax.jit(
        lambda h, b_: jax.lax.fori_loop(
            0, k, lambda _, v: mult_vcycle(h, cfg, v, b_), jnp.zeros_like(b_)
        )
    )(hier, b)
    x = jnp.zeros_like(b)
    for _ in range(k):
        x = mult_vcycle(hier, cfg, x, b)
    np.testing.assert_allclose(np.asarray(looped), np.asarray(x), atol=1e-13)
