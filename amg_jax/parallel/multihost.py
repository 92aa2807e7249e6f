"""Multi-host (multi-process) execution.

The reference's multi-host substrate is MPI: one rank per process, hypre
ParCSR row blocks per rank, point-to-point halo exchange across hosts
(reference: src/DMEM_Main.cpp, src/DMEM_Comm.cpp:81-348). The equivalent
here is jax.distributed: one process per host, a GLOBAL device mesh
spanning all processes, and the SAME sharded programs — GSPMD/shard_map
collectives ride NVLink within a host and the network across hosts; nothing in
the solver stack changes.

Because setup is deterministic (seeded PRNGs, identical host hierarchies in
every process), operators are materialized with `jax.device_put` onto global
shardings from replicated host data — the analog of the reference's
matrix redistribution (DMEM_DistributeHypreParCSRMatrix_FineToGridk) without
the Alltoallv: every process already holds the (setup-time, host-side)
global matrix and contributes its addressable shards.

Validated by tests/test_multiprocess.py: 2 processes x 4 virtual CPU devices
running the halo-exchange V-cycle and the grid-parallel async solve with
cross-process Gloo collectives (the CI realization of BASELINE config 5's
N>=2-host requirement).
"""

from __future__ import annotations

import jax


def init_multihost(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
) -> None:
    """Initialize the distributed runtime. Call before ANY jax computation.

    No cluster environment is assumed: pass the coordinator address
    (e.g. localhost:<port>), the process count and this process's id."""
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def global_mesh_info() -> dict:
    """Topology summary (the reference prints ranks/grids at startup)."""
    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "local_devices": jax.local_device_count(),
        "global_devices": jax.device_count(),
    }
