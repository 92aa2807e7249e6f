"""Dense vector ops used throughout the solvers.

Counterparts of the reference's vector helpers: hypre axpy/inner-product and the
CUDA `hypreDevice_IVAXPY` elementwise-scaled axpy (reference:
src/DMEM_Misc.cpp:469-582). All are trivially XLA-fused; they exist as named
functions so solver code reads like the algorithm.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def dot(x, y):
    # HIGHEST: without it a float32 product may run in TF32 on the GPU
    return jnp.dot(x, y, precision=jax.lax.Precision.HIGHEST)


def l2_norm(x):
    return jnp.sqrt(dot(x, x))


def l1_norm(x):
    return jnp.sum(jnp.abs(x))


def axpy(alpha, x, y):
    """y + alpha*x."""
    return y + alpha * x


def ivaxpy(x, scale, y):
    """x + y/scale elementwise — the reference's IVAXPY
    (reference: src/DMEM_Misc.cpp:477-492)."""
    return x + y / scale


def residual(A, u, f):
    """r = f - A u; reference: hypre_ParCSRMatrixMatvecOutOfPlace residual
    form (src/DMEM_Mult.cpp:134-141)."""
    return f - (A @ u)
