"""Platform policy: the one module that turns the JAX platform into choices.

Every decision that depends on where the solve runs is made here, so no
other module asks JAX for its backend. Two platforms are known:

  * ``cpu`` — tests and parity runs. The device solve runs in float64, the
    same precision as the all-double reference, so goldens compare exactly.
  * ``gpu`` — the NVIDIA H100. The cycles run in float32 (bytes per point
    halve on a memory-bound solver); float64 is native on the card, so
    mixed-precision refinement accumulates in plain float64.

Any other platform raises :class:`UnsupportedPlatformError`: no path is
picked silently.

Host-side setup is float64 (numpy) everywhere; index arrays are int32
(n < 2^31 per shard).
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np

INDEX_DTYPE = np.int32
SETUP_DTYPE = np.float64

PLATFORMS = ("cpu", "gpu")
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class UnsupportedPlatformError(RuntimeError):
    """Raised when JAX runs on a platform this policy does not know."""


def platform() -> str:
    """The JAX default backend, checked against the known platforms."""
    p = jax.default_backend()
    if p not in PLATFORMS:
        raise UnsupportedPlatformError(
            f"JAX platform {p!r} is not supported; known: {PLATFORMS}"
        )
    return p


def default_solve_dtype() -> jnp.dtype:
    """Device dtype of the solve: float64 on the CPU (parity with the
    all-double reference), float32 on the GPU."""
    return jnp.float64 if platform() == "cpu" else jnp.float32


def f32_floor_applies(tol: float, mixed_precision: bool) -> bool:
    """True when a plain float32 solve is asked for a tolerance below the
    float32 stagnation floor (~1e-5 relative at card-filling sizes)."""
    return (
        default_solve_dtype() == jnp.float32
        and tol < 1e-5
        and not mixed_precision
    )


def auto_device_format() -> str:
    """What ``device_format="auto"`` means for unstructured operators: the
    scalar-gather ELL layout on every platform (BSR stays selectable)."""
    platform()
    return "ell"


def prefer_dia() -> bool:
    """Whether ``device_format="auto"`` converts a translation-structured
    CSR operator (elasticity with bc='identity', vardifconv) into the DIA
    form (`VarStencilOperator`): on the GPU its shifted multiply-adds fuse
    into one gather-free loop; the CPU keeps ELL, which the goldens pin."""
    return platform() == "gpu"


def mixed_pcg_single_program() -> bool:
    """Whether `mixed_pcg` runs its whole refinement as one jitted program
    (GPU: one launch) or as a host loop with a per-iteration history (CPU:
    the history the goldens pin)."""
    return platform() == "gpu"


def enable_compile_cache() -> str:
    """Keep JAX's persistent compile cache across processes.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and no
    path is set here. Otherwise the cache goes to ``<repo>/.jax_cache``
    (listed in .gitignore). Returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(_REPO_ROOT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
