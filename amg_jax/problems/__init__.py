from amg_jax.problems.laplacian import (
    Problem,
    difconv_3d,
    laplacian_2d_5pt,
    laplacian_3d_7pt,
    laplacian_3d_27pt,
    vardifconv_3d,
)

__all__ = [
    "Problem",
    "laplacian_2d_5pt",
    "laplacian_3d_7pt",
    "laplacian_3d_27pt",
    "difconv_3d",
    "vardifconv_3d",
]
