"""Sparse halo exchange for unstructured row-partitioned operators.

Round-1 verdict item 2: the sharded SpMV must ship only boundary segments
(reference: CreateCommData_LocalRes src/DMEM_Setup.cpp:666-1265,
src/DMEM_Comm.cpp:81-348), not all-gather the whole vector."""

import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from amg_jax.parallel import make_row_mesh
from amg_jax.parallel.dist import (
    _pad_csr,
    build_dist_hierarchy,
    pad_vector,
    shard_vector,
    unpad_vector,
)
from amg_jax.parallel.spcomm import build_halo_ell
from amg_jax.problems import laplacian_2d_5pt, laplacian_3d_7pt
from amg_jax.setup.hierarchy import HierarchyParams, build_host_hierarchy
from amg_jax.smooth import SmootherType
from amg_jax.solve import CycleConfig, CycleType, solve


class TestHaloSpmv:
    @pytest.mark.parametrize("D", [4, 8])
    def test_matches_scipy(self, D):
        prob = laplacian_2d_5pt(19)  # 361 rows, not divisible by D
        mesh = make_row_mesh(D)
        npad = -(-prob.n // D) * D
        A_pad = _pad_csr(prob.A, npad, npad, unit_diag_from=prob.n)
        h = build_halo_ell(A_pad, mesh)
        x = np.random.default_rng(0).random(npad)
        y_ref = A_pad.to_scipy() @ x
        y = jax.jit(lambda v: h @ v)(shard_vector(jnp.asarray(x), mesh))
        np.testing.assert_allclose(np.asarray(y), y_ref, rtol=1e-14)

    def test_all_to_all_fallback(self):
        """Dense-coupling fallback (max_ppermute_offsets=0 forces it) gives
        identical results through the padded all_to_all path."""
        prob = laplacian_2d_5pt(19)
        mesh = make_row_mesh(8)
        npad = -(-prob.n // 8) * 8
        A_pad = _pad_csr(prob.A, npad, npad, unit_diag_from=prob.n)
        h = build_halo_ell(A_pad, mesh, max_ppermute_offsets=0)
        assert h.offsets == ()
        x = np.random.default_rng(0).random(npad)
        y = jax.jit(lambda v: h @ v)(shard_vector(jnp.asarray(x), mesh))
        np.testing.assert_allclose(
            np.asarray(y), A_pad.to_scipy() @ x, rtol=1e-14
        )

    def test_rectangular(self):
        """P (fine x coarse) and R (coarse x fine) with different row/col
        partitions — the transfer-operator halo channels."""
        prob = laplacian_2d_5pt(16)
        hh = build_host_hierarchy(
            prob.A, HierarchyParams(smoother=SmootherType.L1_JACOBI)
        )
        P_csr = hh.levels[0].P
        D = 8
        mesh = make_row_mesh(D)
        nf = -(-P_csr.n_rows // D) * D
        nc = -(-P_csr.n_cols // D) * D
        P_pad = _pad_csr(P_csr, nf, nc)
        h = build_halo_ell(P_pad, mesh)
        xc = np.random.default_rng(1).random(nc)
        y_ref = P_pad.to_scipy() @ xc
        y = jax.jit(lambda v: h @ v)(shard_vector(jnp.asarray(xc), mesh))
        np.testing.assert_allclose(np.asarray(y), y_ref, rtol=1e-14)

    def test_comm_is_boundary_not_allgather(self):
        """Compiled HLO must contain the all_to_all of boundary segments and
        NO all-gather of the full vector; comm volume ∝ partition surface."""
        prob = laplacian_3d_7pt(16)  # 4096 rows; slab surface 256
        D = 8
        mesh = make_row_mesh(D)
        h = build_halo_ell(prob.A, mesh)
        x = shard_vector(jnp.zeros(prob.n), mesh)
        fn = jax.jit(lambda v: h @ v)
        txt = fn.lower(x).compile().as_text()
        assert "collective-permute" in txt
        assert "all-gather" not in txt and "all-to-all" not in txt
        # boundary bytes: a 16^3 7pt slab touches its two neighbor planes
        # (16x16 each) → ppermute mode with two offset classes of one plane
        assert h.offsets == (1, 7), h.offsets
        _, m, S = h.send_idx.shape
        assert (m, S) == (2, 16 * 16), (m, S)
        # exact wire accounting: 7 source pairs per offset class (the slab
        # chain is non-periodic: device 0 sends only up, device 7 only
        # down) -> mean 14*S/8 elements/device/matvec
        assert h.wire_send == (S, 2 * S, 2 * S, 2 * S, 2 * S, 2 * S, 2 * S, S)
        assert h.comm_bytes_per_matvec() == 14 * S * 8 // 8
        # every shipped segment is one full 16x16 plane -> zero padding,
        # payload == wire
        assert h.comm_payload_bytes_per_matvec() == h.comm_bytes_per_matvec()
        # far below the all-gather volume (n doubles)
        assert h.comm_bytes_per_matvec() < prob.n * 8 / 4


class TestHaloHierarchySolve:
    def test_vcycle_identical_to_single_device(self):
        prob = laplacian_2d_5pt(24)
        params = HierarchyParams(
            smoother=SmootherType.L1_JACOBI, keep_stencil_fine=False,
            device_format="ell",
        )
        hh = build_host_hierarchy(prob.A, params)
        cfg = CycleConfig(cycle=CycleType.MULT, smoother=SmootherType.L1_JACOBI)
        b_np = np.random.default_rng(0).random(prob.n)

        from amg_jax.setup.hierarchy import device_hierarchy

        hier1 = device_hierarchy(hh, params)
        res1 = solve(hier1, cfg, jnp.asarray(b_np), tol=1e-8, max_cycles=60)

        mesh = make_row_mesh(8)
        hier8, pad_info = build_dist_hierarchy(hh, params, mesh, comm="halo")
        b8 = pad_vector(jnp.asarray(b_np), pad_info, mesh)
        res8 = solve(hier8, cfg, b8, tol=1e-8, max_cycles=60)
        assert int(res8.iters) == int(res1.iters)
        x8 = unpad_vector(res8.x, pad_info)
        np.testing.assert_allclose(
            np.asarray(x8), np.asarray(res1.x), rtol=1e-9, atol=1e-12
        )

    def test_no_allgather_in_solve(self):
        """The full jitted V-cycle over the halo hierarchy compiles without
        any all-gather except the (small) coarse-grid direct solve."""
        prob = laplacian_2d_5pt(24)
        params = HierarchyParams(
            smoother=SmootherType.L1_JACOBI, keep_stencil_fine=False,
            device_format="ell",
        )
        hh = build_host_hierarchy(prob.A, params)
        mesh = make_row_mesh(8)
        hier8, pad_info = build_dist_hierarchy(hh, params, mesh, comm="halo")
        cfg = CycleConfig(cycle=CycleType.MULT, smoother=SmootherType.L1_JACOBI)
        from amg_jax.solve.cycles import mult_vcycle

        b8 = pad_vector(jnp.zeros(prob.n), pad_info, mesh)
        fn = jax.jit(lambda h, x, b: mult_vcycle(h, cfg, x, b))
        txt = fn.lower(hier8, b8, b8).compile().as_text()
        n0_pad = pad_info[1]
        # no all-gather of a fine-level-sized operand
        for m in re.finditer(r"all-gather[^\n]*f64\[(\d+)\]", txt):
            assert int(m.group(1)) < n0_pad, m.group(0)

    def test_runner_halo_end_to_end(self):
        from amg_jax.utils.config import SolverOptions
        from amg_jax.utils.runner import run_experiment

        st = run_experiment(SolverOptions(
            problem="5pt", n=24, solver="mult", num_devices=8, comm="halo",
            device_format="ell",
        ))
        assert st.rel_resnorm <= 1e-8


class TestHaloBSR:
    """Blocked halo exchange: BSR tiles + block-column boundary segments."""

    @pytest.mark.parametrize("D", [4, 8])
    def test_matches_scipy(self, D):
        from amg_jax.parallel.spcomm import build_halo_bsr

        prob = laplacian_3d_7pt(16)  # 4096 rows; % (8*8) == 0
        mesh = make_row_mesh(D)
        h = build_halo_bsr(prob.A, mesh, bm=8, bn=8)
        x = np.random.default_rng(0).random(prob.n)
        y_ref = prob.A.to_scipy() @ x
        y = jax.jit(lambda v: h @ v)(shard_vector(jnp.asarray(x), mesh))
        np.testing.assert_allclose(
            np.asarray(y), y_ref, rtol=1e-12, atol=1e-14
        )

    def test_comm_is_blocked_boundary(self):
        from amg_jax.parallel.spcomm import build_halo_bsr

        prob = laplacian_3d_7pt(16)
        mesh = make_row_mesh(8)
        h = build_halo_bsr(prob.A, mesh, bm=8, bn=8)
        # slab surface: one 16x16 plane = 256 scalars = 32 bn=8 blocks per
        # neighbor; two offset classes
        assert h.offsets == (1, 7), h.offsets
        x = shard_vector(jnp.zeros(prob.n), mesh)
        txt = jax.jit(lambda v: h @ v).lower(x).compile().as_text()
        assert "collective-permute" in txt
        assert "all-gather" not in txt and "all-to-all" not in txt
        assert h.comm_bytes_per_matvec() <= 2 * 256 * 8 * 2  # <= 2 planes+pad

    def test_all_to_all_fallback(self):
        from amg_jax.parallel.spcomm import build_halo_bsr

        prob = laplacian_3d_7pt(16)
        mesh = make_row_mesh(8)
        h = build_halo_bsr(prob.A, mesh, bm=8, bn=8, max_ppermute_offsets=0)
        assert h.offsets == ()
        x = np.random.default_rng(1).random(prob.n)
        y = jax.jit(lambda v: h @ v)(shard_vector(jnp.asarray(x), mesh))
        np.testing.assert_allclose(
            np.asarray(y), prob.A.to_scipy() @ x, rtol=1e-12, atol=1e-14
        )

    def test_smoother_runs_on_halo_bsr(self):
        """HaloBSR drops into the smoother/solver stack via @."""
        from amg_jax.parallel.spcomm import build_halo_bsr
        from amg_jax.smooth import SmootherType, make_smoother_data, smooth

        prob = laplacian_3d_7pt(16)
        mesh = make_row_mesh(8)
        h = build_halo_bsr(prob.A, mesh, bm=8, bn=8)
        sm = make_smoother_data(prob.A, SmootherType.L1_JACOBI, w=0.8)
        b = jnp.asarray(np.random.default_rng(2).random(prob.n))
        u = jnp.zeros_like(b)
        u1 = smooth(h, sm, SmootherType.L1_JACOBI, u, b, num_sweeps=3)
        # compare against the plain ELL path
        from amg_jax.sparse.ell import ell_from_csr

        A_ell = ell_from_csr(prob.A)
        u_ref = smooth(A_ell, sm, SmootherType.L1_JACOBI, u, b, num_sweeps=3)
        np.testing.assert_allclose(
            np.asarray(u1), np.asarray(u_ref), rtol=1e-13, atol=1e-15
        )


def test_dist_hierarchy_halo_bsr():
    """comm='halo' with device_format bsr builds HaloBSR levels where the
    tiling divides, and the V-cycle matches the ELL halo path."""
    from amg_jax.parallel.spcomm import HaloBSR
    from amg_jax.setup.hierarchy import build_host_hierarchy as bhh

    prob = laplacian_3d_7pt(12)
    params = HierarchyParams(
        smoother=SmootherType.L1_JACOBI, keep_stencil_fine=False,
        device_format="bsr", bsr_bm=8, bsr_bn=8, bsr_max_blowup=60.0,
    )
    hh = bhh(prob.A, params)
    mesh = make_row_mesh(8)
    hier, pad_info = build_dist_hierarchy(hh, params, mesh, comm="halo")
    assert isinstance(hier.levels[0].A, HaloBSR)
    cfg = CycleConfig(cycle=CycleType.MULT, smoother=SmootherType.L1_JACOBI)
    b = pad_vector(
        jnp.asarray(np.random.default_rng(0).random(prob.n)), pad_info, mesh
    )
    res = solve(hier, cfg, b, tol=1e-8, max_cycles=60)
    assert float(res.rel_resnorm) <= 1e-8
    # ELL-halo reference
    params_e = HierarchyParams(
        smoother=SmootherType.L1_JACOBI, keep_stencil_fine=False,
        device_format="ell",
    )
    hh_e = bhh(prob.A, params_e)
    hier_e, pad_e = build_dist_hierarchy(hh_e, params_e, mesh, comm="halo")
    b_e = pad_vector(
        jnp.asarray(np.random.default_rng(0).random(prob.n)), pad_e, mesh
    )
    res_e = solve(hier_e, cfg, b_e, tol=1e-8, max_cycles=60)
    assert int(res.iters) == int(res_e.iters)
