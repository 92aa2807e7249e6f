"""AMG hierarchy construction and the device-side hierarchy pytree.

The native replacement for the reference's setup stack: BoomerAMG setup +
per-level extraction + explicit transposes + scale arrays + coarse direct
solve (reference: src/SMEM_Setup.cpp:55-588, src/DMEM_Setup.cpp:39-519).

Host phase (float64 numpy/scipy, once per matrix):
    strength → C/F split (PMIS/HMIS) → interpolation (direct or ext+i,
    truncated) → explicit R = P^T → Galerkin RAP → recurse; plus smoothed
    transfer operators for multadd and per-level smoother scale arrays.

Device phase: each level's operators convert to ELL (level 0 optionally keeps
its stencil fast path), the coarsest A becomes a precomputed dense inverse
applied as a single matmul — the counterpart of the reference's gathered
Gaussian elimination (`hypre_GaussElimSetup/Solve(…,9|99)`,
src/DMEM_Setup.cpp:378-389, src/SMEM_Setup.cpp:138).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, NamedTuple, Optional, Tuple

import jax.numpy as jnp
import numpy as np

from amg_jax.setup.coarsen import C_PT, COARSENING, F_PT
from amg_jax.setup.interp import (
    direct_interpolation,
    extended_i_interpolation,
    truncate_interpolation,
)
from amg_jax.setup.rap import (
    estimate_rho_dinv_a,
    galerkin_product,
    smoothed_transfer,
)
from amg_jax.setup.strength import strength_graph
from amg_jax.smooth import SmootherData, SmootherType, make_smoother_data
from amg_jax.sparse.csr import CSRMatrix
from amg_jax.sparse.ell import ELLMatrix, ell_from_csr
from amg_jax.sparse.stencil import StencilOperator


@dataclass(frozen=True)
class HierarchyParams:
    """Setup knobs, mirroring the reference's hypre configuration
    (reference: src/SMEM_Setup.cpp:1673-1759, src/DMEM_Setup.cpp:554-594)."""

    strong_threshold: float = 0.25
    coarsen_type: str = "hmis"  # "pmis" | "hmis"
    interp_type: str = "ext+i"  # "direct" | "ext+i"
    trunc_factor: float = 0.0
    p_max_elmts: int = 4
    max_levels: int = 25
    max_coarse_size: int = 64
    seed: int = 0
    num_functions: int = 1  # >1: unknown-based systems AMG (elasticity)
    smoother: SmootherType = SmootherType.L1_JACOBI
    smooth_weight: Optional[float] = None  # None → 1/rho(S^-1 A) per level
    block_size: int = 128
    build_smoothed_transfers: bool = True  # multadd P~/R~
    dtype: Any = jnp.float64
    keep_stencil_fine: bool = True  # level-0 stencil fast path when available
    # device operator format: "ell" (scalar gather), "bsr" (blocked-ELL,
    # gather amortized over bm×bn tiles), or "auto" (the platform policy's
    # choice, amg_jax.dtypes.auto_device_format)
    device_format: str = "auto"
    bsr_bm: int = 8
    bsr_bn: int = 8
    bsr_max_blowup: float = 40.0  # fixed-tile mode: max padded/nnz ratio
    # aggressive coarsening on the first agg_num_levels levels: the CF split
    # is coarsened a second time and the interpolant composed through the
    # intermediate grid, P = P1 P2 — hypre's aggressive-coarsening +
    # two-stage/multipass interpolation as configured by the reference's
    # -agg_nl (HYPRE_BoomerAMGSetAggNumLevels, src/SMEM_Main.cpp:387-390,
    # src/DMEM_Main.cpp:517-520)
    agg_num_levels: int = 0
    # truncation of the additive smoothed transfers (reference -add_tr →
    # hypre add_trunc_factor / add_P_max_elmts, src/DMEM_Setup.cpp:589-593)
    add_trunc_factor: float = 0.0
    add_p_max_elmts: int = 0
    # setup family: "classical" (PMIS/HMIS + ext+i, the reference's hypre
    # path) or "sa" (smoothed aggregation with near-nullspace candidates —
    # required for elasticity-class problems; see setup/aggregation.py)
    setup_type: str = "classical"
    sa_theta: float = 0.0  # SA symmetric strength threshold
    sa_omega: float = 4.0 / 3.0  # prolongator smoothing: omega/rho(Dinv A)
    # hybrid-JGS damping: None = undamped, "auto" = damp only if the sweep
    # diverges (1/rho(M^-1 A)), or an explicit float weight
    jgs_weight: Any = "auto"


class Level(NamedTuple):
    """One device-side level. P maps level k+1 → k; R maps k → k+1
    (both None on the coarsest level)."""

    A: Any  # ELLMatrix | StencilOperator
    P: Optional[ELLMatrix]
    R: Optional[ELLMatrix]
    P_s: Optional[ELLMatrix]  # smoothed prolongation (multadd)
    R_s: Optional[ELLMatrix]
    R_inj: Optional[ELLMatrix]  # injection restriction
    sm: SmootherData
    # AFACj ideal interpolant P_id = [-D_ff^-1 A_fc; I] and its transpose —
    # the diagonal-Schur approximation of the true ideal [-A_ff^-1 A_fc; I],
    # the semantics of the hypre patch's P_array_afacj (reference:
    # src/DMEM_Setup.cpp:197-199, used src/DMEM_Mult.cpp:453-612)
    P_id: Optional[ELLMatrix] = None
    R_id: Optional[ELLMatrix] = None


class Hierarchy(NamedTuple):
    levels: Tuple[Level, ...]
    coarse_Ainv: jnp.ndarray  # dense inverse of the coarsest operator

    @property
    def num_levels(self) -> int:
        return len(self.levels)

    def level_sizes(self) -> Tuple[int, ...]:
        return tuple(lv.A.shape[0] for lv in self.levels)


@dataclass
class HostLevel:
    A: CSRMatrix
    P: Optional[CSRMatrix] = None
    R: Optional[CSRMatrix] = None
    P_s: Optional[CSRMatrix] = None
    R_s: Optional[CSRMatrix] = None
    R_inj: Optional[CSRMatrix] = None  # injection C-point restriction
    P_id: Optional[CSRMatrix] = None  # AFACj ideal interpolant (diag-Schur)
    R_id: Optional[CSRMatrix] = None
    cf: Optional[np.ndarray] = None
    weight: float = 1.0


@dataclass
class HostHierarchy:
    levels: List[HostLevel] = field(default_factory=list)
    params: Optional[HierarchyParams] = None

    @property
    def num_levels(self) -> int:
        return len(self.levels)

    def stats(self) -> dict:
        ns = [lv.A.n_rows for lv in self.levels]
        nnzs = [lv.A.nnz for lv in self.levels]
        return {
            "num_levels": len(ns),
            "n": ns,
            "nnz": nnzs,
            "operator_complexity": sum(nnzs) / nnzs[0] if nnzs else 0.0,
            "grid_complexity": sum(ns) / ns[0] if ns else 0.0,
        }


def build_host_hierarchy(A: CSRMatrix, params: HierarchyParams) -> HostHierarchy:
    hh = HostHierarchy(params=params)
    coarsen = COARSENING[params.coarsen_type]
    interp = {
        "direct": direct_interpolation,
        "ext+i": extended_i_interpolation,
    }[params.interp_type]
    level_A = A
    # unknown-based systems AMG: track each dof's function (component),
    # interleaved ordering on the fine grid, restricted through C/F splits
    func = np.arange(A.n_rows) % max(params.num_functions, 1)
    for lvl in range(params.max_levels):
        hl = HostLevel(A=level_A)
        if params.smooth_weight is not None:
            hl.weight = params.smooth_weight
        else:
            # per-level near-optimal damping w ≈ 1 / rho(S^-1 A), with S the
            # scaling the configured smoother actually uses
            scale = None
            if params.smoother in (
                SmootherType.L1_JACOBI,
                SmootherType.SYM_L1_JACOBI,
            ):
                scale = level_A.l1_row_norms()
            hl.weight = 1.0 / max(
                estimate_rho_dinv_a(level_A, seed=params.seed, scale=scale), 1e-12
            )
        hh.levels.append(hl)
        if level_A.n_rows <= params.max_coarse_size or lvl == params.max_levels - 1:
            break
        if params.num_functions > 1:
            S = strength_graph(
                level_A, params.strong_threshold, num_functions=1
            )
            # filter cross-function couplings by the tracked function vector
            # (component identity is positional only on the finest grid)
            S = S.tocoo()
            same = func[S.row] == func[S.col]
            import scipy.sparse as _sp

            S = _sp.coo_matrix(
                (S.data[same], (S.row[same], S.col[same])), shape=S.shape
            ).tocsr()
        else:
            S = strength_graph(level_A, params.strong_threshold)
        cf = coarsen(S, seed=params.seed)
        nc = int((cf == C_PT).sum())
        if nc == 0 or nc == level_A.n_rows:
            break  # coarsening stalled
        P = interp(level_A, S, cf)
        P = truncate_interpolation(P, params.trunc_factor, params.p_max_elmts)
        if lvl < params.agg_num_levels:
            # aggressive coarsening: coarsen the first-pass coarse grid again
            # and compose the interpolant through it (two-stage interpolation
            # P = P1 P2 over the Galerkin intermediate operator) — the
            # semantics of hypre's agg_num_levels the reference requests via
            # -agg_nl (src/SMEM_Main.cpp:387-390, src/DMEM_Main.cpp:517-520)
            import scipy.sparse as _spa

            A_mid = galerkin_product(P.transpose(), level_A, P)
            crows1 = np.flatnonzero(cf == C_PT)
            if params.num_functions > 1:
                func1 = func[crows1]
                S2 = strength_graph(A_mid, params.strong_threshold,
                                    num_functions=1).tocoo()
                same2 = func1[S2.row] == func1[S2.col]
                S2 = _spa.coo_matrix(
                    (S2.data[same2], (S2.row[same2], S2.col[same2])),
                    shape=S2.shape,
                ).tocsr()
            else:
                S2 = strength_graph(A_mid, params.strong_threshold)
            cf2 = coarsen(S2, seed=params.seed)
            nc2 = int((cf2 == C_PT).sum())
            if 0 < nc2 < A_mid.n_rows:
                P2 = interp(A_mid, S2, cf2)
                P2 = truncate_interpolation(
                    P2, params.trunc_factor, params.p_max_elmts
                )
                P = CSRMatrix.from_scipy(
                    (P.to_scipy() @ P2.to_scipy()).tocsr()
                )
                # composite CF split: final C-points are the second-pass
                # C-points mapped back to this level's rows
                cf_comp = np.full(level_A.n_rows, F_PT, dtype=cf.dtype)
                cf_comp[crows1[np.flatnonzero(cf2 == C_PT)]] = C_PT
                cf = cf_comp
                nc = nc2
        R = P.transpose()
        hl.P, hl.R, hl.cf = P, R, cf
        # injection interpolant: identity on C-points (the AFACj ideal/
        # injection interpolants the reference's hypre patch adds as
        # P_array_afacj — reference: src/DMEM_Setup.cpp:197-199,
        # src/DMEM_Mult.cpp:475-476)
        import scipy.sparse as _sp2

        crows = np.flatnonzero(cf == C_PT)
        hl.R_inj = CSRMatrix.from_scipy(
            _sp2.coo_matrix(
                (np.ones(nc), (np.arange(nc), crows)),
                shape=(nc, level_A.n_rows),
            ).tocsr()
        )
        # AFACj ideal interpolant: P_id = [-D_ff^-1 A_fc ; I] — one-point
        # Jacobi approximation of the ideal [-A_ff^-1 A_fc ; I] (the hypre
        # patch's P_array_afacj; reference: src/DMEM_Mult.cpp:453-612 uses
        # it for the AFACj restrict/prolong chains). Vectorized from A's COO.
        n_rows = level_A.n_rows
        cmap = np.full(n_rows, -1, np.int64)
        cmap[crows] = np.arange(nc)
        Aco = level_A.to_scipy().tocoo()
        diag = level_A.diagonal()
        diag = np.where(diag == 0.0, 1.0, diag)
        fc = (cf[Aco.row] != C_PT) & (cf[Aco.col] == C_PT)
        pid_rows = np.concatenate([Aco.row[fc], crows])
        pid_cols = np.concatenate([cmap[Aco.col[fc]], np.arange(nc)])
        pid_data = np.concatenate(
            [-Aco.data[fc] / diag[Aco.row[fc]], np.ones(nc)]
        )
        P_id_sp = _sp2.coo_matrix(
            (pid_data, (pid_rows, pid_cols)), shape=(n_rows, nc)
        ).tocsr()
        hl.P_id = CSRMatrix.from_scipy(P_id_sp)
        hl.R_id = CSRMatrix.from_scipy(P_id_sp.T.tocsr())
        if params.build_smoothed_transfers:
            scale = (
                level_A.l1_row_norms()
                if params.smoother
                in (SmootherType.L1_JACOBI, SmootherType.SYM_L1_JACOBI)
                else np.where(level_A.diagonal() == 0.0, 1.0, level_A.diagonal())
            )
            hl.P_s, hl.R_s = smoothed_transfer(level_A, P, scale, hl.weight)
            if params.add_trunc_factor > 0.0 or params.add_p_max_elmts > 0:
                # truncate the (denser) additive smoothed transfers — the
                # reference's -add_tr → hypre add_trunc_factor /
                # add_P_max_elmts (src/DMEM_Setup.cpp:589-593)
                P_t = truncate_interpolation(
                    hl.P_s, params.add_trunc_factor, params.add_p_max_elmts
                )
                hl.P_s, hl.R_s = P_t, P_t.transpose()
        level_A = galerkin_product(R, level_A, P)
        func = func[cf == C_PT]
    return hh


def _format_converter(params: HierarchyParams):
    """Pick the device operator format (SURVEY §7: blocked-ELL for the
    gather-bound unstructured path; "auto" asks the platform policy).
    Returns csr→device-matrix callable."""
    from amg_jax.dtypes import auto_device_format
    from amg_jax.sparse.bsr import bsr_fill_stats, bsr_from_csr

    fmt = params.device_format
    if fmt == "auto":
        fmt = auto_device_format()

    def convert(m, dtype):
        if m is None:
            return None
        if fmt == "bsr":
            st = bsr_fill_stats(m, bm=params.bsr_bm, bn=params.bsr_bn)
            if st["blowup"] <= params.bsr_max_blowup:
                return bsr_from_csr(
                    m, bm=params.bsr_bm, bn=params.bsr_bn, dtype=dtype
                )
        return ell_from_csr(m, dtype=dtype)

    return convert


def device_hierarchy(
    hh: HostHierarchy,
    params: HierarchyParams,
    fine_stencil: Optional[StencilOperator] = None,
) -> Hierarchy:
    levels = []
    dtype = params.dtype
    convert = _format_converter(params)
    for k, hl in enumerate(hh.levels):
        if k == 0 and fine_stencil is not None and params.keep_stencil_fine:
            from amg_jax.setup.structured import VarStencilOperator

            if isinstance(fine_stencil, VarStencilOperator):
                # generalized-diagonal (DIA) fine operator — gather-free
                # SpMV for translation-structured FEM systems (elasticity
                # bc='identity', vardifconv); csr_to_dia_stencil builds it
                A_dev: Any = VarStencilOperator(
                    coeffs=fine_stencil.coeffs.astype(dtype),
                    offsets=fine_stencil.offsets,
                    grid_shape=fine_stencil.grid_shape,
                )
            else:
                A_dev = StencilOperator(
                    weights=jnp.asarray(fine_stencil.weights, dtype=dtype),
                    offsets=fine_stencil.offsets,
                    grid_shape=fine_stencil.grid_shape,
                )
        else:
            A_dev = convert(hl.A, dtype)
        sm = make_smoother_data(
            hl.A,
            params.smoother,
            w=hl.weight,
            block_size=params.block_size,
            dtype=dtype,
            jgs_weight=params.jgs_weight,
        )
        levels.append(
            Level(
                A=A_dev,
                P=convert(hl.P, dtype),
                R=convert(hl.R, dtype),
                P_s=convert(hl.P_s, dtype),
                R_s=convert(hl.R_s, dtype),
                R_inj=convert(hl.R_inj, dtype),
                sm=sm,
                P_id=convert(hl.P_id, dtype),
                R_id=convert(hl.R_id, dtype),
            )
        )
    coarse_dense = hh.levels[-1].A.to_dense()
    coarse_Ainv = jnp.asarray(np.linalg.inv(coarse_dense), dtype=dtype)
    return Hierarchy(levels=tuple(levels), coarse_Ainv=coarse_Ainv)


def build_hierarchy(
    A: CSRMatrix,
    params: HierarchyParams = HierarchyParams(),
    fine_stencil: Optional[StencilOperator] = None,
    near_nullspace=None,
) -> Tuple[HostHierarchy, Hierarchy]:
    """Full setup: host hierarchy + device pytree. Returns (host, device).
    params.setup_type selects classical vs smoothed-aggregation setup;
    `near_nullspace` feeds the SA candidates (e.g. Problem.near_nullspace)."""
    if params.setup_type == "sa":
        from amg_jax.setup.aggregation import build_sa_host_hierarchy

        hh = build_sa_host_hierarchy(A, params, B=near_nullspace)
    else:
        hh = build_host_hierarchy(A, params)
    return hh, device_hierarchy(hh, params, fine_stencil)
