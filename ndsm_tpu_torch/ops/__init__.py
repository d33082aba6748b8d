"""Stencil, reduction and transfer ops, and the CUDA kernel wrappers.

``KERNELS`` lists the wrapper of every hand-written kernel with its plain
version, the TPU kernel it replaces and its CUDA source;
``launch_counts``/``reset_launch_counts`` read and zero their launch
counters, ``plain_cuda_counts`` the number of times a plain version ran on
a CUDA tensor.
"""

from . import df, v2d, zc
from .stencils import (
    first_color_parity,
    poisson_residual,
    rb_sweep,
    stencil_weights,
    subtract_mean,
)
from .reduce import du_metrics, trapz_2d
from .transfer import apply_axis_matrices, interp_matrix_1d, restrict_matrix_1d

_ZC = "ndsm_tpu_torch/csrc/zc_smooth.cu"
_V2D = "ndsm_tpu_torch/csrc/v2d_smooth.cu"

#: (wrapper, plain version, replaced TPU kernel, CUDA source)
KERNELS = (
    (zc.zc_smooth_3d, zc.zc_smooth_3d_plain, "ndsm_tpu/ops/pallas_zc.py:740", _ZC),
    (zc.zc_smooth_residual_3d, zc.zc_smooth_residual_3d_plain,
     "ndsm_tpu/ops/pallas_zc.py:825", _ZC),
    (zc.zc_smooth_cor_3d, zc.zc_smooth_cor_3d_plain, "ndsm_tpu/ops/pallas_zc.py:796", _ZC),
    (df.df_residual_3d, df.df_residual_3d_plain, "ndsm_tpu/ops/pallas_df.py:520",
     "ndsm_tpu_torch/csrc/defect.cu"),
    (zc.zc_smooth_mean_3d, zc.zc_smooth_mean_3d_plain, "ndsm_tpu/ops/pallas_zc.py:766", _ZC),
    (v2d.v2d_smooth, v2d.v2d_smooth_plain, "ndsm_tpu/ops/pallas_v2d.py:451", _V2D),
    (v2d.v2d_smooth_residual, v2d.v2d_smooth_residual_plain,
     "ndsm_tpu/ops/pallas_v2d.py:463", _V2D),
    (v2d.v2d_smooth_cor, v2d.v2d_smooth_cor_plain, "ndsm_tpu/ops/pallas_v2d.py:475", _V2D),
)


def launch_counts() -> dict:
    return {k[0].__name__: k[0].launches for k in KERNELS}


def plain_cuda_counts() -> dict:
    return {k[1].__name__: k[1].plain_cuda_calls for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k[0].launches = 0
        k[1].plain_cuda_calls = 0


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
