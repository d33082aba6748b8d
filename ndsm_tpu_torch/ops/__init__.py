"""Stencil, reduction and transfer ops, and the CUDA kernel wrappers.

``KERNELS`` lists the wrapper of every hand-written kernel with its plain
version, the TPU kernel it replaces and its CUDA source.  The launch
counters are counters of the registry (utils/profiling.py; names under
``zc.LAUNCHES`` and its siblings), so every per-call record carries them;
these functions are views of it: ``launch_counts``/``reset_launch_counts``
read and zero the wrappers' counters (calls that launched),
``pass_launches`` the launches of the 3D red-black pass kernel behind them,
``compact_pass_launches`` those of its halves form behind the colour-split
wrappers, ``v2d_route_launches`` the v2d launches of each route
(``v2d.v2d_plan``), ``plain_cuda_counts`` the number of times a plain
version ran on a CUDA tensor.
"""

from ..utils.profiling import counter, reset
from . import compact, df, df_sharded, diffusion, fused, v2d, zc, zc_sharded
from .fused import (
    fused_smooth_3d,
    fused_smooth_3d_batched,
    fused_smooth_cor_3d_batched,
    fused_smooth_residual_3d_batched,
)
from .stencils import (
    first_color_parity,
    poisson_residual,
    rb_sweep,
    stencil_weights,
    subtract_mean,
)
from .reduce import du_metrics, trapz_2d
from .transfer import (
    apply_axis_matrices,
    inner_product,
    interp_matrix_1d,
    ninterp,
    prolong,
    restrict,
    restrict_matrix_1d,
)

_ZC = "ndsm_tpu_torch/csrc/zc_smooth.cu"
_V2D = "ndsm_tpu_torch/csrc/v2d_smooth.cu"
_FUSED = "ndsm_tpu_torch/csrc/fused_smooth.cu"
_COMPACT = "ndsm_tpu_torch/csrc/compact_smooth.cu"
_SHARDED = "ndsm_tpu_torch/csrc/zc_sharded.cu"
_DEFECT = "ndsm_tpu_torch/csrc/defect.cu"
_DIFFUSION = "ndsm_tpu_torch/csrc/diffusion.cu"

#: (name, wrapper, plain version, replaced TPU kernel, CUDA source).  The
#: 3D red-black wrappers are calls of one lane kernel family (B lanes or
#: one); "fused_smooth_3d" and "zc_smooth_3d" are one wrapper, which ports
#: both TPU kernels, so they share its launch counter.  The colour-split
#: smoother has a one-lane and a lane wrapper over one kernel; its split and
#: merge passes replace tensor code that the JAX engine leaves to XLA
#: around the TPU kernel.  The per-shard kernels of the sharded engine
#: (parallel/sm_engine.py) close the list: the sweeps on a halo-extended
#: block with and without the fused residual, and the shard's defect
#: without and with the pending correction, each on a z-partitioned mesh
#: and (``_zy``, with its own counter) on the 2-D (z, y) mesh.  Last,
#: ``DiffusionOperator``'s sweep and residual (mg/operator.py), which replace
#: no TPU kernel: the JAX package runs that operator on XLA.
KERNELS = (
    ("zc_smooth_3d", zc.zc_smooth_3d, zc.zc_smooth_3d_plain,
     "ndsm_tpu/ops/pallas_zc.py:740", _FUSED),
    ("zc_smooth_residual_3d", zc.zc_smooth_residual_3d, zc.zc_smooth_residual_3d_plain,
     "ndsm_tpu/ops/pallas_zc.py:825", _FUSED),
    ("zc_smooth_cor_3d", zc.zc_smooth_cor_3d, zc.zc_smooth_cor_3d_plain,
     "ndsm_tpu/ops/pallas_zc.py:796", _FUSED),
    ("df_residual_3d", df.df_residual_3d, df.df_residual_3d_plain,
     "ndsm_tpu/ops/pallas_df.py:520", _DEFECT),
    ("zc_smooth_mean_3d", zc.zc_smooth_mean_3d, zc.zc_smooth_mean_3d_plain,
     "ndsm_tpu/ops/pallas_zc.py:766", _ZC),
    ("v2d_smooth", v2d.v2d_smooth, v2d.v2d_smooth_plain, "ndsm_tpu/ops/pallas_v2d.py:451",
     _V2D),
    ("v2d_smooth_residual", v2d.v2d_smooth_residual, v2d.v2d_smooth_residual_plain,
     "ndsm_tpu/ops/pallas_v2d.py:463", _V2D),
    ("v2d_smooth_cor", v2d.v2d_smooth_cor, v2d.v2d_smooth_cor_plain,
     "ndsm_tpu/ops/pallas_v2d.py:475", _V2D),
    ("fused_smooth_3d_batched", fused.fused_smooth_3d_batched,
     fused.fused_smooth_3d_batched_plain, "ndsm_tpu/ops/pallas_fused.py:405", _FUSED),
    ("fused_smooth_residual_3d_batched", fused.fused_smooth_residual_3d_batched,
     fused.fused_smooth_residual_3d_batched_plain, "ndsm_tpu/ops/pallas_fused.py:405", _FUSED),
    ("fused_smooth_cor_3d_batched", fused.fused_smooth_cor_3d_batched,
     fused.fused_smooth_cor_3d_batched_plain, "ndsm_tpu/ops/pallas_fused.py:405", _FUSED),
    ("fused_smooth_3d", fused.fused_smooth_3d, fused.fused_smooth_3d_plain,
     "ndsm_tpu/ops/pallas_fused.py:319", _FUSED),
    ("compact_smooth_3d", compact.compact_smooth_3d, compact.compact_smooth_3d_plain,
     "ndsm_tpu/ops/pallas_compact.py:306", _COMPACT),
    ("compact_smooth_3d_batched", compact.compact_smooth_3d_batched,
     compact.compact_smooth_3d_batched_plain, "ndsm_tpu/ops/pallas_compact.py:306", _COMPACT),
    ("split_colors_3d", compact.split_colors_3d, compact.split_colors_3d_plain,
     "ndsm_tpu/ops/stencils_compact.py:109", _COMPACT),
    ("merge_colors_3d", compact.merge_colors_3d, compact.merge_colors_3d_plain,
     "ndsm_tpu/ops/stencils_compact.py:122", _COMPACT),
    ("zc_smooth_sharded_3d", zc_sharded.zc_smooth_sharded_3d,
     zc_sharded.zc_smooth_sharded_3d_plain, "ndsm_tpu/ops/pallas_zc.py:1275", _SHARDED),
    ("zc_smooth_residual_sharded_3d", zc_sharded.zc_smooth_residual_sharded_3d,
     zc_sharded.zc_smooth_residual_sharded_3d_plain, "ndsm_tpu/ops/pallas_zc.py:1275",
     _SHARDED),
    ("df_residual_sharded_3d", df_sharded.df_residual_sharded_3d,
     df_sharded.df_residual_sharded_3d_plain, "ndsm_tpu/ops/pallas_df.py:922", _DEFECT),
    ("df_update_residual_sharded_3d", df_sharded.df_update_residual_sharded_3d,
     df_sharded.df_update_residual_sharded_3d_plain, "ndsm_tpu/ops/pallas_df.py:922",
     _DEFECT),
    ("zc_smooth_sharded_3d_zy", zc_sharded.zc_smooth_sharded_3d_zy,
     zc_sharded.zc_smooth_sharded_3d_zy_plain, "ndsm_tpu/ops/pallas_zc.py:1275", _SHARDED),
    ("zc_smooth_residual_sharded_3d_zy", zc_sharded.zc_smooth_residual_sharded_3d_zy,
     zc_sharded.zc_smooth_residual_sharded_3d_zy_plain, "ndsm_tpu/ops/pallas_zc.py:1275",
     _SHARDED),
    ("df_residual_sharded_3d_zy", df_sharded.df_residual_sharded_3d_zy,
     df_sharded.df_residual_sharded_3d_zy_plain, "ndsm_tpu/ops/pallas_df.py:922", _DEFECT),
    ("df_update_residual_sharded_3d_zy", df_sharded.df_update_residual_sharded_3d_zy,
     df_sharded.df_update_residual_sharded_3d_zy_plain, "ndsm_tpu/ops/pallas_df.py:922",
     _DEFECT),
    ("diffusion_sweep", diffusion.diffusion_sweep, diffusion.diffusion_sweep_plain,
     "none (XLA in JAX)", _DIFFUSION),
    ("diffusion_residual", diffusion.diffusion_residual, diffusion.diffusion_residual_plain,
     "none (XLA in JAX)", _DIFFUSION),
)


def launch_counts() -> dict:
    return {k[0]: counter(zc.LAUNCHES + k[1].__name__) for k in KERNELS}


def pass_launches() -> int:
    return counter(zc.PASSES + "zc")


def compact_pass_launches() -> int:
    return counter(zc.PASSES + "compact")


def v2d_route_launches() -> dict:
    return {route: counter(zc.V2D_ROUTE + route) for route in v2d.ROUTES}


def plain_cuda_counts() -> dict:
    return {k[2].__name__: counter(zc.PLAIN_CUDA + k[2].__name__) for k in KERNELS}


def reset_launch_counts() -> None:
    for prefix in (zc.LAUNCHES, zc.PLAIN_CUDA, zc.PASSES, zc.V2D_ROUTE):
        reset(prefix)


__all__ = [
    "rb_sweep",
    "poisson_residual",
    "first_color_parity",
    "stencil_weights",
    "subtract_mean",
    "interp_matrix_1d",
    "restrict_matrix_1d",
    "apply_axis_matrices",
    "prolong",
    "restrict",
    "ninterp",
    "inner_product",
    "du_metrics",
    "trapz_2d",
    "fused_smooth_3d",
    "fused_smooth_3d_batched",
    "fused_smooth_residual_3d_batched",
    "fused_smooth_cor_3d_batched",
    "KERNELS",
    "launch_counts",
    "pass_launches",
    "compact_pass_launches",
    "v2d_route_launches",
    "plain_cuda_counts",
    "reset_launch_counts",
]
