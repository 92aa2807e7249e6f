from amg_jax.solve.cycles import (
    CycleConfig,
    CycleType,
    additive_correction,
    mult_vcycle,
    sync_additive_cycle,
)
from amg_jax.solve.driver import SolveResult, solve
from amg_jax.solve.mixed import MixedSolveResult, mixed_pcg, mixed_solve

__all__ = [
    "CycleConfig",
    "CycleType",
    "mult_vcycle",
    "additive_correction",
    "sync_additive_cycle",
    "SolveResult",
    "solve",
    "MixedSolveResult",
    "mixed_pcg",
    "mixed_solve",
]
