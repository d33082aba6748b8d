"""Stencil, reduction and transfer ops, and the CUDA kernel wrappers.

``KERNELS`` lists the wrapper of every hand-written kernel with the TPU
kernel it replaces; ``launch_counts``/``reset_launch_counts`` read and
zero their launch counters, ``plain_cuda_counts`` the number of times a
plain version ran on a CUDA tensor.
"""

from . import df, zc
from .stencils import (
    first_color_parity,
    poisson_residual,
    rb_sweep,
    stencil_weights,
    subtract_mean,
)
from .reduce import du_metrics, trapz_2d
from .transfer import apply_axis_matrices, interp_matrix_1d, restrict_matrix_1d

#: (wrapper, plain version, replaced TPU kernel)
KERNELS = (
    (zc.zc_smooth_3d, zc.zc_smooth_3d_plain, "ndsm_tpu/ops/pallas_zc.py:740"),
    (zc.zc_smooth_residual_3d, zc.zc_smooth_residual_3d_plain,
     "ndsm_tpu/ops/pallas_zc.py:825"),
    (zc.zc_smooth_cor_3d, zc.zc_smooth_cor_3d_plain, "ndsm_tpu/ops/pallas_zc.py:796"),
    (df.df_residual_3d, df.df_residual_3d_plain, "ndsm_tpu/ops/pallas_df.py:520"),
)


def launch_counts() -> dict:
    return {k.__name__: k.launches for k, _, _ in KERNELS}


def plain_cuda_counts() -> dict:
    return {p.__name__: p.plain_cuda_calls for _, p, _ in KERNELS}


def reset_launch_counts() -> None:
    for k, p, _ in KERNELS:
        k.launches = 0
        p.plain_cuda_calls = 0


__all__ = [
    "rb_sweep",
    "poisson_residual",
    "first_color_parity",
    "stencil_weights",
    "subtract_mean",
    "interp_matrix_1d",
    "restrict_matrix_1d",
    "apply_axis_matrices",
    "du_metrics",
    "trapz_2d",
    "KERNELS",
    "launch_counts",
    "plain_cuda_counts",
    "reset_launch_counts",
]
