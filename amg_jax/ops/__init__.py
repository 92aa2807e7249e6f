from amg_jax.ops.vector import axpy, dot, ivaxpy, l1_norm, l2_norm, residual

__all__ = ["axpy", "dot", "ivaxpy", "l1_norm", "l2_norm", "residual"]
