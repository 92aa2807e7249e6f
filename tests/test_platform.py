"""The platform policy (amg_jax.dtypes): one decision per platform, an
error on any other platform, and the precision of every dense product.

The platform is simulated by replacing jax.default_backend, which only the
policy module reads; the arrays still live on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from amg_jax import dtypes


@pytest.fixture
def on(monkeypatch):
    def set_platform(name):
        monkeypatch.setattr(jax, "default_backend", lambda: name)

    return set_platform


@pytest.mark.parametrize("platform", ["cpu", "gpu"])
def test_platform_known(on, platform):
    on(platform)
    assert dtypes.platform() == platform


@pytest.mark.parametrize("platform", ["xpu", "rocm", "METAL"])
def test_platform_unknown_raises(on, platform):
    on(platform)
    with pytest.raises(dtypes.UnsupportedPlatformError, match=platform):
        dtypes.platform()


@pytest.mark.parametrize(
    "decision",
    [dtypes.default_solve_dtype, dtypes.auto_device_format,
     dtypes.prefer_dia, dtypes.mixed_pcg_single_program,
     lambda: dtypes.f32_floor_applies(1e-8, False)],
    ids=["solve_dtype", "device_format", "prefer_dia", "single_program",
         "f32_floor"],
)
def test_every_decision_refuses_unknown_platform(on, decision):
    on("xpu")
    with pytest.raises(dtypes.UnsupportedPlatformError):
        decision()


@pytest.mark.parametrize(
    "platform,solve_dtype,prefer_dia,single_program",
    [("cpu", jnp.float64, False, False), ("gpu", jnp.float32, True, True)],
)
def test_decisions_per_platform(on, platform, solve_dtype, prefer_dia,
                                single_program):
    on(platform)
    assert dtypes.default_solve_dtype() == solve_dtype
    assert dtypes.prefer_dia() is prefer_dia
    assert dtypes.mixed_pcg_single_program() is single_program
    assert dtypes.auto_device_format() == "ell"


@pytest.mark.parametrize(
    "platform,tol,mixed,expected",
    [("gpu", 1e-8, False, True), ("gpu", 1e-8, True, False),
     ("gpu", 1e-5, False, False), ("cpu", 1e-8, False, False)],
)
def test_f32_floor_warning(on, platform, tol, mixed, expected):
    on(platform)
    assert dtypes.f32_floor_applies(tol, mixed) is expected


@pytest.mark.parametrize("platform", ["cpu", "gpu"])
def test_auto_format_converter_builds_ell(on, platform):
    from amg_jax.problems import laplacian_2d_5pt
    from amg_jax.setup.hierarchy import HierarchyParams, _format_converter
    from amg_jax.sparse.ell import ELLMatrix

    on(platform)
    A = laplacian_2d_5pt(6).A
    m = _format_converter(HierarchyParams())(A, jnp.float64)
    assert isinstance(m, ELLMatrix)


def test_runner_follows_gpu_policy(on, capsys):
    """With the GPU policy, run_experiment builds a float32 hierarchy, warns
    below the float32 floor, and the structured solve still converges."""
    from amg_jax.utils.config import SolverOptions
    from amg_jax.utils.runner import build_problem, run_experiment

    on("gpu")
    opts = SolverOptions(problem="27pt", n=12, hierarchy="structured",
                         solver="mult", tol=1e-8, num_cycles=12)
    st = run_experiment(opts)
    assert "below the f32 stagnation floor" in capsys.readouterr().out
    assert st.solution.dtype == np.float64  # host copy
    prob = build_problem(opts)
    r = st.rhs - prob.A.to_scipy() @ st.solution
    rel = np.linalg.norm(r) / np.linalg.norm(st.rhs)
    assert 1e-8 < rel < 1e-5  # float32 iterate: converged to its floor


@pytest.mark.parametrize("platform", ["cpu", "gpu"])
def test_runner_dia_choice_per_platform(on, monkeypatch, platform):
    """On the GPU the algebraic runner path turns a translation-structured
    CSR (identity-BC elasticity) into the DIA operator; the CPU keeps the
    assembled matrix (ELL), which the goldens pin."""
    import amg_jax.setup.hierarchy as hmod
    from amg_jax.setup.structured import VarStencilOperator
    from amg_jax.utils.config import SolverOptions
    from amg_jax.utils.runner import run_experiment

    seen = {}
    orig = hmod.build_hierarchy

    def spy(A, params, fine_stencil=None, near_nullspace=None):
        seen["fine"] = fine_stencil
        return orig(A, params, fine_stencil=fine_stencil,
                    near_nullspace=near_nullspace)

    monkeypatch.setattr(hmod, "build_hierarchy", spy)
    on(platform)
    run_experiment(SolverOptions(
        problem="elasticity", nx=8, ny=2, nz=2, elast_bc="identity",
        setup_type="classical", only_setup=True,
    ))
    want = VarStencilOperator if platform == "gpu" else type(None)
    assert isinstance(seen["fine"], want)


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_dir(monkeypatch, tmp_path, env_set):
    """JAX_COMPILATION_CACHE_DIR wins and nothing is set in code; without
    it the cache goes to <repo>/.jax_cache."""
    import os

    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.append((k, v)))
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert dtypes.enable_compile_cache() == str(tmp_path)
        assert calls == []
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        path = dtypes.enable_compile_cache()
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert path == os.path.join(repo, ".jax_cache")
        assert calls == [("jax_compilation_cache_dir", path)]


def _dot_precisions(fn, *args):
    """Precision configs of every dot_general in fn's jaxpr."""
    out = []

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "dot_general":
                out.append(eqn.params["precision"])
            for sub in jax.core.jaxprs_in_params(eqn.params):
                walk(sub)

    walk(jax.make_jaxpr(fn)(*args).jaxpr)
    return out


def _coarse_solve_case():
    from amg_jax.solve.cycles import coarse_solve

    class H:  # the one field coarse_solve reads
        coarse_Ainv = jnp.eye(4, dtype=jnp.float32)

    return (lambda r: coarse_solve(H, r)), (jnp.ones(4, jnp.float32),)


def _block_solve_case():
    from amg_jax.smooth.smoothers import _block_solve

    inv = jnp.ones((2, 3, 3), jnp.float32)
    return (lambda r: _block_solve(inv, r)), (jnp.ones(5, jnp.float32),)


def _bsr_case():
    from amg_jax.problems import laplacian_2d_5pt
    from amg_jax.sparse.bsr import bsr_from_csr, bsr_spmv

    A = bsr_from_csr(laplacian_2d_5pt(4).A, bm=2, bn=2, dtype=jnp.float32)
    return (lambda x: bsr_spmv(A, x)), (jnp.ones(16, jnp.float32),)


def _transfer_case():
    from amg_jax.setup.structured import StructuredProlong, StructuredRestrict

    # strided-slice arithmetic: no dense product at all, so nothing on the
    # transfer can run in TF32 (an empty list of products passes below)
    R = StructuredRestrict(fine_shape=(5, 5, 5), coarse_shape=(3, 3, 3))
    P = StructuredProlong(fine_shape=(5, 5, 5), coarse_shape=(3, 3, 3))
    return (lambda x: P @ (R @ x)), (jnp.ones(125, jnp.float32),)


@pytest.mark.parametrize(
    "case",
    [_coarse_solve_case, _block_solve_case, _bsr_case, _transfer_case],
    ids=["coarse_solve", "jgs_block_solve", "bsr_tile_product",
         "structured_transfer"],
)
def test_dense_products_ask_highest_precision(case):
    """Every float32 dense product on the solve path asks for HIGHEST, so
    the GPU cannot run it in TF32; the structured transfer has none."""
    fn, args = case()
    precs = _dot_precisions(fn, *args)
    assert precs or case is _transfer_case, "no dot_general traced"
    for p in precs:
        assert p is not None
        assert all(q == jax.lax.Precision.HIGHEST for q in p), p
