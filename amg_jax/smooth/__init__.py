from amg_jax.smooth.smoothers import (
    SmootherData,
    SmootherType,
    make_smoother_data,
    smooth,
    smooth_transpose,
)

__all__ = [
    "SmootherData",
    "SmootherType",
    "make_smoother_data",
    "smooth",
    "smooth_transpose",
]
