"""Experiment orchestrator: options → problem → setup → solve → stats.

The native equivalent of the reference's driver mains (reference:
src/SMEM_Main.cpp:13-767, src/DMEM_Main.cpp:12-948): build the problem,
run setup, dispatch to the configured solver family, aggregate stats.
"""

from __future__ import annotations

import numpy as np

from amg_jax.utils.config import SolverOptions
from amg_jax.utils.stats import SolveStats, Timer


def build_problem(opts: SolverOptions):
    from amg_jax.problems import (
        difconv_3d,
        laplacian_2d_5pt,
        laplacian_3d_7pt,
        laplacian_3d_27pt,
        vardifconv_3d,
    )

    nx, ny, nz = opts.grid_dims()
    if opts.problem == "5pt":
        return laplacian_2d_5pt(nx, ny)
    if opts.problem == "7pt":
        return laplacian_3d_7pt(nx, ny, nz)
    if opts.problem == "27pt":
        return laplacian_3d_27pt(nx, ny, nz)
    if opts.problem == "difconv":
        return difconv_3d(
            nx, ny, nz, eps=opts.eps, atype=opts.difconv_atype,
            ax=opts.ax, ay=opts.ay, az=opts.az,
            cx=opts.cx, cy=opts.cy, cz=opts.cz,
        )
    if opts.problem == "vardifconv":
        return vardifconv_3d(nx, ny, nz, eps=opts.eps, seed=opts.seed)
    if opts.problem == "elasticity":
        from amg_jax.problems.elasticity import elasticity_beam

        return elasticity_beam(
            nx=nx, ny=ny, nz=(nz if opts.nz else 0), bc=opts.elast_bc
        )
    if opts.problem == "maxwell":
        from amg_jax.problems.maxwell import maxwell_curlcurl

        return maxwell_curlcurl(n=nx, sigma=opts.sigma)
    if opts.problem == "graded":
        from amg_jax.problems.amr import laplacian_graded

        return laplacian_graded(nx, ny, gamma=opts.grading)
    if opts.problem == "amr":
        from amg_jax.problems.amr import amr_refine_loop

        rounds = amr_refine_loop(
            n0=nx, rounds=opts.amr_rounds, theta=opts.amr_theta
        )
        return rounds[-1]["problem"]
    if opts.problem == "file":
        from amg_jax.problems.io import problem_from_file

        return problem_from_file(
            opts.matrix_file,
            remove_disconnected=opts.include_disconnected_points,
        )
    raise ValueError(f"unknown problem {opts.problem}")


def _make_vectors(opts, n, dtype):
    import jax.numpy as jnp

    rng = np.random.default_rng(opts.seed)

    def make(kind):
        if kind == "rand":
            return jnp.asarray(rng.random(n), dtype=dtype)
        if kind == "ones":
            return jnp.ones(n, dtype=dtype)
        return jnp.zeros(n, dtype=dtype)

    return make(opts.rhs), make(opts.init_guess)


def _fine_operator_f64(prob):
    """The fine operator with float64 coefficients: mixed-precision
    refinement takes its outer residual against the unrounded matrix."""
    import jax.numpy as jnp

    if prob.stencil is not None:
        from amg_jax.sparse.stencil import StencilOperator

        return StencilOperator(
            weights=jnp.asarray(np.asarray(prob.stencil.weights), jnp.float64),
            offsets=prob.stencil.offsets,
            grid_shape=prob.stencil.grid_shape,
        )
    from amg_jax.sparse.ell import ell_from_csr

    return ell_from_csr(prob.A, dtype=jnp.float64)


def _ams_params(params):
    """AMS auxiliary hierarchies: library defaults at the solve dtype."""
    from amg_jax.setup.hierarchy import HierarchyParams

    return HierarchyParams(keep_stencil_fine=False, dtype=params.dtype)


def run_experiment(opts: SolverOptions) -> SolveStats:
    import jax
    import jax.numpy as jnp

    from amg_jax import dtypes

    if dtypes.f32_floor_applies(opts.tol, opts.mixed_precision):
        # f32 device arithmetic stagnates around relative residual
        # 1e-5/5e-5 at production sizes; tighter targets need refinement
        print(
            f"warning: tol={opts.tol:g} is below the f32 stagnation "
            "floor on this platform — pass -mixed_precision for "
            "float64 refinement"
        )

    from amg_jax.setup.hierarchy import HierarchyParams, build_hierarchy
    from amg_jax.smooth import SmootherType
    from amg_jax.solve import CycleConfig, CycleType, solve
    from amg_jax.solve.async_sim import AsyncConfig, async_solve
    from amg_jax.solve.driver import cheby_setup
    from amg_jax.utils.config import EXT_SOLVERS

    opts.fixup()
    stats = SolveStats(
        problem=opts.problem, solver=opts.solver, smoother=opts.smoother
    )
    timer = Timer()
    prob = build_problem(opts)
    if opts.print_matrix:
        # matrix dump in the reference's binary-triplet record format
        # (reference: DMEM_PrintParCSRMatrix / WriteCSR)
        from amg_jax.problems.io import write_binary_triplets

        write_binary_triplets(opts.print_matrix, prob.A)
    if opts.only_build_matrix:
        stats.n, stats.nnz = prob.n, prob.A.nnz
        stats.setup_wtime = timer.lap()
        return stats
    smoother = SmootherType(opts.smoother)
    if opts.num_functions > 0:
        num_functions = opts.num_functions
    elif opts.problem == "elasticity":
        num_functions = 3 if opts.nz else 2
    else:
        num_functions = 1
    params = HierarchyParams(
        strong_threshold=opts.strong_threshold,
        num_functions=num_functions,
        coarsen_type=opts.coarsen_type,
        interp_type=opts.interp_type,
        trunc_factor=opts.trunc_factor,
        p_max_elmts=opts.p_max_elmts,
        max_levels=opts.max_levels,
        max_coarse_size=opts.max_coarse_size,
        agg_num_levels=opts.agg_nl,
        add_trunc_factor=opts.add_tr,
        seed=opts.seed,
        smoother=smoother,
        smooth_weight=opts.smooth_weight,
        block_size=opts.block_size,
        keep_stencil_fine=(opts.num_devices <= 1),
        setup_type=opts.setup_type,
        device_format=opts.device_format,
        dtype=dtypes.default_solve_dtype(),
    )
    mesh = None
    grid_mesh = None
    dia_pair = None
    if opts.hierarchy == "structured":
        dtype_s = jnp.float32 if opts.mixed_precision else params.dtype
        if prob.stencil is not None:
            from amg_jax.setup.structured import build_structured_hierarchy

            hh, hier = build_structured_hierarchy(
                prob.stencil,
                max_levels=opts.max_levels,
                max_coarse_size=max(opts.max_coarse_size, 8),
                dtype=dtype_s,
                smoother=smoother,
                smooth_weight=opts.smooth_weight,
            )
        elif prob.grid_shape is not None:
            # variable-coefficient / interleaved-vector operator on a
            # structured grid (elasticity -elast_bc identity, vardifconv):
            # geometric hierarchy with DIA operators at every level
            from amg_jax.setup.structured import (
                build_dia_structured_hierarchy,
            )

            gs = prob.grid_shape
            nf = num_functions
            node_shape = tuple(gs[:-1]) + (gs[-1] // max(nf, 1),)
            if opts.mixed_precision:
                # double-single operator pair for the accurate outer
                # residual / DS-PCG matvec (solve/mixed.py::mixed_pcg)
                from amg_jax.setup.structured import csr_to_dia_stencil

                dia_pair = csr_to_dia_stencil(
                    prob.A, gs, jnp.float32, return_lo=True
                )
            hh, hier = build_dia_structured_hierarchy(
                prob.A,
                node_shape,
                num_functions=nf,
                max_levels=opts.max_levels,
                max_coarse_size=max(opts.max_coarse_size, 8),
                dtype=dtype_s,
                smoother=smoother,
                smooth_weight=opts.smooth_weight,
            )
        else:
            raise ValueError(
                "structured hierarchy needs a stencil or grid-structured "
                "problem"
            )
        if opts.num_devices > 1:
            # geometric hierarchy over the mesh: grid coefficient arrays
            # sharded along the major axis, GSPMD inserts the stencil halos
            from amg_jax.parallel import make_row_mesh
            from amg_jax.parallel.dist import (
                pad_vector,
                shard_structured_hierarchy,
                unpad_vector,
            )

            if prob.n % opts.num_devices == 0:
                mesh = make_row_mesh(opts.num_devices)
                hier = shard_structured_hierarchy(hier, mesh)
                pad_info = (prob.n, prob.n)  # no padding, structured path
            else:
                print(
                    f"warning: n={prob.n} not divisible by "
                    f"{opts.num_devices} devices — structured hierarchy "
                    "runs replicated (choose grid sizes with "
                    "n % num_devices == 0 to shard)"
                )
    elif opts.num_devices > 1:
        from amg_jax.parallel import make_row_mesh
        from amg_jax.parallel.dist import (
            build_dist_hierarchy,
            pad_vector,
            unpad_vector,
        )

        from amg_jax.setup.hierarchy import build_host_hierarchy

        if params.setup_type == "sa":
            from amg_jax.setup.aggregation import build_sa_host_hierarchy

            hh = build_sa_host_hierarchy(
                prob.A, params, B=getattr(prob, "near_nullspace", None)
            )
        else:
            hh = build_host_hierarchy(prob.A, params)
        mesh = make_row_mesh(opts.num_devices)
        if opts.solver in EXT_SOLVERS and opts.grid_parallel:
            # grid parallelism on the extended system: level blocks padded
            # to shard boundaries (pad_extended_layout), fine operators
            # replicated — the ext build below shards AA by block rows
            from amg_jax.setup.hierarchy import device_hierarchy

            hier = device_hierarchy(hh, params)
            grid_mesh, mesh = mesh, None
        elif opts.solver in EXT_SOLVERS:
            # -no_grid_parallel: the extended system's only supported
            # distribution is level-block (grid) sharding — a row-sharded
            # fine hierarchy would pad b to the mesh while the ext operator
            # keeps the true n0. Run the ext solve replicated instead.
            from amg_jax.setup.hierarchy import device_hierarchy

            hier = device_hierarchy(hh, params)
            mesh = None
        elif opts.is_async() and opts.grid_parallel:
            # level ("grid") parallelism: devices own level groups, operators
            # replicated (reference: AssignProcs) — build the plain device
            # hierarchy, the grid solver handles the mesh mapping below
            from amg_jax.setup.hierarchy import device_hierarchy

            hier = device_hierarchy(hh, params)
            grid_mesh, mesh = mesh, None
        else:
            hier, pad_info = build_dist_hierarchy(
                hh, params, mesh, comm=opts.comm
            )
    else:
        fine_op = prob.stencil
        if (
            fine_op is None
            and prob.grid_shape is not None
            and opts.device_format in ("auto", "dia")
        ):
            # translation-structured CSR without a constant stencil
            # (elasticity bc='identity', vardifconv): the DIA generalized-
            # diagonal form runs SpMV as shifted multiply-adds, no gathers
            from amg_jax.setup.structured import csr_to_dia_stencil

            if opts.device_format == "dia" or dtypes.prefer_dia():
                try:
                    fine_op = csr_to_dia_stencil(
                        prob.A, prob.grid_shape, params.dtype
                    )
                except ValueError:
                    fine_op = None  # not translation-structured — formats below
        hh, hier = build_hierarchy(
            prob.A,
            params,
            fine_stencil=fine_op,
            near_nullspace=getattr(prob, "near_nullspace", None),
        )
    hstats = hh.stats()
    stats.n, stats.nnz = prob.n, prob.A.nnz
    stats.num_levels = hstats["num_levels"]
    stats.operator_complexity = hstats["operator_complexity"]
    stats.level_n, stats.level_nnz = hstats["n"], hstats["nnz"]
    stats.setup_wtime = timer.lap()
    if opts.only_setup:
        return stats

    competitor = None
    if opts.background_program:
        # spawn a host busy-loop competitor for the solve's duration
        # (straggler-injection experiment; killed by exact PID afterwards)
        import subprocess, sys

        competitor = subprocess.Popen(
            [sys.executable, "-c", "while True:\n a = sum(range(10000))"]
        )
    dtype = params.dtype
    b, x0 = _make_vectors(opts, prob.n, dtype)
    if prob.rhs is not None and opts.rhs == "rand":
        # generators with a natural load (elasticity beam, maxwell source)
        b = jnp.asarray(np.asarray(prob.rhs) / np.linalg.norm(prob.rhs), dtype=dtype)
    if mesh is not None:
        b = pad_vector(b, pad_info, mesh)
        x0 = pad_vector(x0, pad_info, mesh)

    base = opts.solver.removeprefix("async_")
    cfg = CycleConfig(
        cycle=CycleType(base if base in (
            "mult", "multadd", "mult_multadd", "afacx", "afacj", "bpx"
        ) else "bpx"),
        smoother=smoother,
        num_pre_sweeps=opts.num_pre_smooth_sweeps,
        num_post_sweeps=opts.num_post_smooth_sweeps,
        num_fine_sweeps=opts.num_fine_smooth_sweeps,
        num_coarse_sweeps=opts.num_coarse_smooth_sweeps,
        num_add_sweeps=opts.num_add_smooth_sweeps,
        use_smoothed_transfers=(
            base in ("multadd", "mult_multadd") and opts.one_interpolant
        ),
        simple_add_smoother=opts.simple_jacobi,
        coarsest_mult_level=opts.coarsest_mult_level,
        num_inner_cycles=opts.num_inner_cycles,
        afacj_level=opts.afacj_level,
    )

    if opts.solver == "async_smooth":
        from amg_jax.solve.async_smooth import (
            AsyncSmoothConfig,
            async_smooth_solve,
            block_neighbor_mask,
        )

        ascfg = AsyncSmoothConfig(
            smoother=smoother,
            num_blocks=opts.num_blocks,
            method=opts.sps_method,
            sps_alpha=opts.sps_alpha,
            sps_min_prob=opts.sps_min_prob,
            fire_prob=opts.fire_prob,
        )
        nbr = block_neighbor_mask(prob.A, opts.num_blocks)
        A_s, sm_s = hier.levels[0].A, hier.levels[0].sm
        if (
            opts.num_devices > 1
            and int(sm_s.scale.shape[0]) == prob.n
        ):
            # distributed one-level async smoothing: explicit halo exchange
            # per sweep (the reference's finestIntra channel,
            # src/DMEM_Smooth.cpp:16-313) — ppermute plane exchange for
            # stencils, boundary-segment HaloELL for unstructured matrices
            from amg_jax.parallel import make_row_mesh
            from amg_jax.parallel.dist import shard_vector

            halo_mesh = make_row_mesh(opts.num_devices)
            D = opts.num_devices
            if (
                prob.stencil is not None
                and prob.stencil.grid_shape[0] % D == 0
            ):
                from amg_jax.parallel.halo import make_halo_stencil

                A_s = make_halo_stencil(prob.stencil, halo_mesh)
            elif prob.n % D == 0:
                from amg_jax.parallel.spcomm import build_halo_ell

                A_s = build_halo_ell(prob.A, halo_mesh, dtype=params.dtype)
            else:
                A_s = None  # row count doesn't divide; stay single-device
            if A_s is not None:
                sm_s = jax.tree_util.tree_map(
                    lambda v: shard_vector(v, halo_mesh)
                    if hasattr(v, "shape") and v.shape == (prob.n,)
                    else v,
                    sm_s,
                )
                b = shard_vector(b, halo_mesh)
                x0 = shard_vector(x0, halo_mesh)
            else:
                A_s = hier.levels[0].A
        res = async_smooth_solve(
            A_s, sm_s, ascfg, nbr, b, x0,
            key=jax.random.PRNGKey(opts.seed),
            tol=opts.tol, max_cycles=opts.num_cycles,
        )
        gw = None
    elif opts.solver in EXT_SOLVERS:
        from amg_jax.solve.accel import estimate_cycle_eigs
        from amg_jax.solve.extended import (
            build_extended_system,
            ext_matvec,
            ext_solve,
        )

        explicit = "explicit" in opts.solver
        if grid_mesh is not None:
            from amg_jax.solve.extended import build_sharded_extended_system

            # grid-mapped extended system (explicit AA, block rows sharded
            # onto assigned device groups)
            ext = build_sharded_extended_system(
                hh, params, grid_mesh, imbalance=opts.imbal,
                assign_policy=opts.assign_procs,
                assign_scalar=opts.assign_procs_scalar,
            )
        else:
            ext = build_extended_system(hh, params, explicit=explicit)
        A0 = hier.levels[0].A
        # operand form: the sharded extended system is passed as a jit
        # argument (required on multi-process meshes)
        coeffs = estimate_cycle_eigs(
            lambda op, u: op[0].inv_wdiag * ext_matvec(op[0], op[1], u),
            ext.offsets[-1], dtype,
            num_iters=opts.cheby_power_iters, range_start=True,
            operand=(ext, A0),
        )
        res = ext_solve(
            hier, ext, b, x0, tol=opts.tol, max_cycles=opts.num_cycles,
            cheby_coeffs=coeffs,
            async_fire_prob=(opts.fire_prob if opts.is_async() else 1.0),
            sim_read_delay=(opts.sim_read_delay if opts.is_async() else 0),
            key=jax.random.PRNGKey(opts.seed),
        )
        gw = None
    elif opts.solver == "async_ams":
        # config-5 LITERAL composition (round 5): the asynchronous
        # additive engine driving the full Hiptmair-Xu AMS correction
        # groups on the Maxwell edge system (reference:
        # src/Maxwell.cpp:50-208 fed into src/DMEM_Add.cpp:20-178).
        # Single device = the bounded-staleness simulator; num_devices>1 =
        # the grid-parallel engine: devices own AMS groups with owned
        # operator storage, corrections ride one ACCUMULATE psum.
        if not (prob.aux and "G" in prob.aux):
            raise ValueError("async_ams needs a problem with aux['G']")
        from amg_jax.solve.ams import (
            ams_async_additive_solve,
            ams_grid_parallel_solve,
            build_ams,
        )

        ams_data, _node_cfg = build_ams(
            prob.A, prob.aux["G"], params=_ams_params(params),
            Pi=prob.aux.get("Pi"),
        )
        A_dev = hier.levels[0].A
        key_a = jax.random.PRNGKey(opts.seed)
        if grid_mesh is not None:
            res, _owned = ams_grid_parallel_solve(
                A_dev, ams_data, grid_mesh, b, key=key_a,
                fire_prob=opts.fire_prob,
                sim_read_delay=opts.sim_read_delay,
                tol=opts.tol, max_cycles=opts.num_cycles,
            )
        else:
            res = ams_async_additive_solve(
                A_dev, ams_data, b, key=key_a,
                fire_prob=opts.fire_prob,
                sim_read_delay=opts.sim_read_delay,
                tol=opts.tol, max_cycles=opts.num_cycles,
            )
        gw = None
    elif opts.is_async():
        omega = 1.0
        accel_kw = {}
        if opts.accel in ("richardson", "cheby"):
            # the reference's ASYMMETRIC async acceleration (round 5;
            # DMEM_ChebyUpdate src/DMEM_Misc.cpp:612-666): each level group
            # advances its own 3-term recurrence at its own firing rate,
            # corrections scale by omega_k*delta, and the cheby_grid group
            # carries the (omega_k - 1)*d momentum. mu/delta come from eig
            # bounds of the SYNC additive operator (ChebySetup analog).
            # delta is damped 0.5x under per-row (FULL) staleness: stale
            # per-row reads raise the effective operator norm (measured on
            # 27pt/12 multadd, delay=4 fire=0.5: undamped diverges to 9e-3
            # at 900 steps, 0.5x converges in 140 — vs 178 for the round-4
            # scalar approximation; SEMI staleness needs no damping: 66 vs
            # 193). The coalescing path (comm_every>1) keeps the round-4
            # scalar-omega approximation — the momentum term does not
            # compose with pending-buffer publishes.
            coeffs = cheby_setup(hier, cfg, num_iters=opts.cheby_power_iters,
                                 method=opts.cheby_eig)
            if (
                max(opts.async_comm_save_divisor, 1) > 1
                or opts.converge_test_type == "local"
            ):
                # scalar fallback (local convergence freezes groups
                # mid-recurrence; coalescing batches publishes)
                omega = 0.5 * 2.0 / (coeffs.alpha + coeffs.beta)
            else:
                # measured on 27pt/12 + 5pt/32 smoothed-transfer multadd
                # (fire=0.5): FULL per-row staleness wants 0.35-0.4x delta
                # (122 -> 104-108 cycles vs the scalar baseline at
                # delay=4), SEMI per-level 0.6x (69 -> 63 at delay=2);
                # undamped diverges under either
                damp = 0.4 if opts.async_type == "full" else 0.6
                if opts.sim_read_delay == 0:
                    damp = 1.0  # no staleness: the recurrence is exact
                accel_kw = dict(
                    accel=opts.accel,
                    cheby_grid=opts.cheby_grid,
                    cheby_mu=coeffs.mu,
                    cheby_delta=coeffs.delta * damp,
                )
        # resolve the reference's delay-selection policies against the
        # built hierarchy's level count (reference: -delay_one delays thread
        # num_threads-1, -delay_some a random fraction, -delay_all everyone;
        # src/SMEM_Main.cpp:572-596, src/SMEM_Solve.cpp:108-126)
        L_h = stats.num_levels
        delay_levels = opts.delay_levels
        if opts.delay_type == "one":
            delay_levels = (L_h - 1,)
        elif opts.delay_type == "all":
            delay_levels = tuple(range(L_h))
        elif opts.delay_type == "some":
            rng_d = np.random.default_rng(opts.seed)
            k_d = min(max(1, int(round(opts.delay_frac * L_h))), L_h)
            delay_levels = tuple(
                sorted(rng_d.choice(L_h, size=k_d, replace=False).tolist())
            )
        fail_level, fail_start, fail_duration = (
            opts.fail_level, opts.fail_start, opts.fail_duration
        )
        if opts.fail_iter >= 0:
            # -fail_one <iter>: the last group misses one firing there
            fail_level, fail_start, fail_duration = L_h - 1, opts.fail_iter, 1
        acfg = AsyncConfig(
            read_type=opts.read_type,
            res_mode=("update" if opts.res_update_type == "accumulate"
                      else "recompute"),
            async_type=opts.async_type,
            sim_read_delay=opts.sim_read_delay,
            fire_prob=opts.fire_prob,
            sim_grid_wait=opts.sim_grid_wait,
            delay_levels=delay_levels,
            delay_prob=opts.delay_prob,
            fail_level=fail_level,
            fail_start=fail_start,
            fail_duration=fail_duration,
            omega=omega,
            comm_every=max(opts.async_comm_save_divisor, 1),
            converge_test_type=opts.converge_test_type,
            **accel_kw,
        )
        if grid_mesh is not None:
            # level→device-group parallelism (only built on the unstructured
            # path above; the structured multi-device path row-shards and
            # must use the data-parallel async solve below)
            from amg_jax.parallel.grid import (
                grid_parallel_solve,
                plan_grid_levels,
            )

            _, levels_of, lscale = plan_grid_levels(
                hh, opts.num_devices, imbalance=opts.imbal,
                smoothed_transfers=cfg.use_smoothed_transfers,
                assign_policy=opts.assign_procs,
                assign_scalar=opts.assign_procs_scalar,
            )
            res = grid_parallel_solve(
                hier, cfg, acfg, levels_of, lscale, grid_mesh, b, x0,
                key=jax.random.PRNGKey(opts.seed),
                tol=opts.tol, max_cycles=opts.num_cycles,
            )
        else:
            res = async_solve(
                hier, cfg, acfg, b, x0,
                key=jax.random.PRNGKey(opts.seed),
                tol=opts.tol, max_cycles=opts.num_cycles,
            )
        gw = res.grid_wait.summary()
    elif opts.mixed_precision:
        if dia_pair is not None:
            # ill-conditioned structured-FEM path (elasticity): DS-PCG
            # refinement against the double-single operator pair
            from amg_jax.solve.mixed import mixed_pcg

            res = mixed_pcg(
                hier, dia_pair, cfg, b, x0, tol=opts.tol,
                max_cycles=opts.num_cycles,
            )
        else:
            from amg_jax.solve.mixed import mixed_solve

            res = mixed_solve(
                hier, _fine_operator_f64(prob), cfg, b, x0, tol=opts.tol,
                max_cycles=opts.num_cycles,
            )
        gw = None
    elif opts.outer_solver == "ams_pcg":
        # auxiliary-space PCG (curl-curl): needs the problem's discrete
        # gradient (amg_jax.solve.ams)
        if not (prob.aux and "G" in prob.aux):
            raise ValueError("ams_pcg needs a problem with aux['G']")
        if opts.num_devices > 1:
            # distributed Maxwell (BASELINE config 5 as specified): sharded
            # AMS with halo-segment comm
            from amg_jax.parallel import make_row_mesh
            from amg_jax.solve.ams import (
                build_sharded_ams,
                solve_sharded_ams_pcg,
            )

            mesh_a = mesh if mesh is not None else make_row_mesh(
                opts.num_devices
            )
            A_halo, ams, node_cfg, pad_e, _ = build_sharded_ams(
                prob.A, prob.aux["G"], mesh_a, params=_ams_params(params)
            )
            b_un = b[: prob.n]  # the sharded solver pads to ITS layout
            res = solve_sharded_ams_pcg(
                A_halo, ams, node_cfg, b_un, mesh_a, pad_e,
                tol=opts.tol, max_iters=opts.num_cycles,
            )
        else:
            from amg_jax.setup.hierarchy import _format_converter
            from amg_jax.solve.ams import build_ams, solve_ams_pcg

            ams, node_cfg = build_ams(
                prob.A, prob.aux["G"], params=_ams_params(params),
                Pi=(prob.aux or {}).get("Pi"),
            )
            A_dev = _format_converter(params)(prob.A, params.dtype)
            res = solve_ams_pcg(
                A_dev, ams, node_cfg, b, x0, tol=opts.tol,
                max_iters=opts.num_cycles,
            )
        gw = None
    else:
        coeffs = None
        accel = None if opts.accel == "none" else opts.accel
        if accel:
            coeffs = cheby_setup(hier, cfg, num_iters=opts.cheby_power_iters,
                                 method=opts.cheby_eig)
        res = solve(
            hier, cfg, b, x0, tol=opts.tol, max_cycles=opts.num_cycles,
            accel=accel, cheby_coeffs=coeffs,
            outer=None if opts.outer_solver == "none" else opts.outer_solver,
            no_resnorm=opts.no_resnorm,
        )
        gw = None
    jax.block_until_ready(res.x)
    stats.solve_wtime = timer.lap()
    if competitor is not None:
        competitor.kill()
        competitor.wait()
    stats.cycles = int(res.iters)
    stats.rel_resnorm = float(res.rel_resnorm)
    # host float64 copies of the solved system, for checks against the
    # assembled matrix (a double-single iterate carries its low part)
    stats.rhs = np.asarray(b, np.float64)[: prob.n]
    x_host = np.asarray(res.x, np.float64)
    if getattr(res, "x_lo", None) is not None:
        x_host = x_host + np.asarray(res.x_lo, np.float64)
    stats.solution = x_host[: prob.n]
    if opts.rhs == "zeros" and opts.init_guess != "zeros":
        # zero-RHS experiment: the iterate IS the error; report the relative
        # A-norm error (reference: e_Anorm/e0_Anorm, src/DMEM_Misc.cpp:63-65)
        A_np = prob.A
        x_np = np.asarray(res.x)[: prob.n]
        x0_np = np.asarray(x0)[: prob.n]
        eA = float(np.sqrt(max(x_np @ (A_np @ x_np), 0.0)))
        e0A = float(np.sqrt(max(x0_np @ (A_np @ x0_np), 1e-300)))
        stats.e_anorm_rel = eA / e0A
    h = np.asarray(res.history)
    stats.history = h[~np.isnan(h)].tolist()
    stats.grid_wait = gw
    if (
        opts.print_level_stats
        # the segmented profiler is duck-typed over the level operators,
        # so structured/DIA hierarchies profile too (round 4); only
        # multi-device runs are excluded (phase timers would include the
        # sharded launch overheads, not per-phase device time)
        and opts.hierarchy in ("algebraic", "structured")
        and opts.num_devices <= 1
        and opts.solver in ("mult", "multadd", "afacx", "afacj", "bpx")
    ):
        # per-phase instrumented re-run (segmented cycle; reference:
        # src/Main.hpp:159-185 per-phase timers)
        from amg_jax.utils.phases import profile_phases

        stats.phase = profile_phases(
            hier, cfg, b, x0, num_cycles=min(max(stats.cycles, 1), 5)
        )
    return stats
