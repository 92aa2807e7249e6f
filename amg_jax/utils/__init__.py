from amg_jax.utils.config import SolverOptions
from amg_jax.utils.stats import SolveStats

__all__ = ["SolverOptions", "SolveStats"]
