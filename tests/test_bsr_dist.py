"""Sharded BSR: a distributed V-cycle with blocked-ELL operators must match
the single-device ELL solve (the format is a layout choice, not semantics).
Mirrors the reference's redistribution-correctness stance
(src/DMEM_Test.cpp:7-58: validate the distributed layout without solving)."""

import jax
import jax.numpy as jnp
import numpy as np

from amg_jax.parallel import make_row_mesh
from amg_jax.parallel.dist import build_dist_hierarchy, pad_vector, unpad_vector
from amg_jax.problems import laplacian_2d_5pt
from amg_jax.setup.hierarchy import HierarchyParams, build_hierarchy
from amg_jax.smooth import SmootherType
from amg_jax.solve import CycleConfig, CycleType, mult_vcycle


def test_dist_bsr_vcycle_matches_single_device():
    assert len(jax.devices()) >= 8
    prob = laplacian_2d_5pt(32)
    params = HierarchyParams(
        smoother=SmootherType.L1_JACOBI, keep_stencil_fine=False
    )
    hh, hier = build_hierarchy(prob.A, params)
    mesh = make_row_mesh(8)
    params_bsr = HierarchyParams(
        smoother=SmootherType.L1_JACOBI,
        keep_stencil_fine=False,
        device_format="bsr",
        bsr_bm=8,
        bsr_bn=8,
    )
    hier_s, pad_info = build_dist_hierarchy(hh, params_bsr, mesh)
    from amg_jax.sparse.bsr import BSRMatrix

    assert any(isinstance(lv.A, BSRMatrix) for lv in hier_s.levels)

    cfg = CycleConfig(cycle=CycleType.MULT, smoother=SmootherType.L1_JACOBI)
    b = jnp.asarray(np.random.default_rng(0).random(prob.n))
    x_ref = np.asarray(mult_vcycle(hier, cfg, jnp.zeros_like(b), b))

    bp = pad_vector(b, pad_info, mesh)
    xp = pad_vector(jnp.zeros_like(b), pad_info, mesh)
    step = jax.jit(lambda x, f: mult_vcycle(hier_s, cfg, x, f))
    x_dist = unpad_vector(np.asarray(step(xp, bp)), pad_info)
    np.testing.assert_allclose(x_dist, x_ref, rtol=1e-10, atol=1e-12)
