"""Mixed-precision outer defect for 3D levels (port of
``ndsm_tpu/ops/pallas_df.py``: ``df_residual_3d`` with its ``zero_rhs``
and ``update`` variants).

``df_residual_3d(u, rhs, e, dq, bcs)`` returns ``(r32, mx, u_new)``:

  * ``u_new = u + e`` in float64 when ``e`` (float32) is given, else ``u``
    itself — the previous defect group's pending correction, applied in
    the same pass as the next defect (the TPU kernel's ``update`` form);
  * ``r32 = f32(rhs - L[u_new])``, zero on Dirichlet faces, with
    ``rhs=None`` the zero-rhs form;
  * ``mx = max|r32|`` as a 0-d float32 tensor on the device.

With ``r32_out`` (a contiguous float32 tensor of u's shape, e.g. one lane
of a stack) r32 is written there and returned, instead of a new tensor.

Float64 throughout: the TPU kernel carried u as an f32 (hi, lo) pair only
because f64 was emulated there; Hopper has it natively.  On a CUDA tensor
the wrapper launches the z-marching tile of ``csrc/defect.cu`` (one
launch; one maximum per block, reduced here) and adds one to
``launches``, or raises.  On a CPU tensor it
runs the plain version, built from ``stencils.poisson_residual`` in f64 —
the same expression order as the kernel, so the two agree bit for bit.
The wrapper never modifies its inputs: the updated iterate is a new tensor.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import stencils
from .zc import check_level, dirichlet_mask

__all__ = ["df_residual_3d", "df_residual_3d_plain"]


def df_residual_3d_plain(u, rhs: Optional[torch.Tensor], e: Optional[torch.Tensor],
                         dq, bcs, r32_out: Optional[torch.Tensor] = None):
    """Plain PyTorch version of :func:`df_residual_3d`."""
    if u.device.type == "cuda":
        df_residual_3d_plain.plain_cuda_calls += 1
    if e is not None:
        u = u + e.to(torch.float64)
    r = stencils.poisson_residual(
        u, torch.zeros_like(u) if rhs is None else rhs, dq, bcs
    )
    r32 = r.to(torch.float32) if r32_out is None else r32_out.copy_(r)
    return r32, torch.max(torch.abs(r32)), u


df_residual_3d_plain.plain_cuda_calls = 0


def df_residual_3d(u, rhs: Optional[torch.Tensor], e: Optional[torch.Tensor],
                   dq, bcs, r32_out: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Outer defect of ``laplace(u) = rhs`` (see module docstring).
    Replaces ndsm_tpu/ops/pallas_df.py:df_residual_3d."""
    check_level("df_residual_3d", (u,) if rhs is None else (u, rhs), torch.float64)
    for t in (e, r32_out):
        if t is not None:
            check_level("df_residual_3d", (t,), torch.float32, shape=u.shape)
            if t.device != u.device:
                raise ValueError("df_residual_3d: e or r32_out on another device than u")
    bcs = stencils.validate_bcs(bcs, 3)
    if len(dq) != 3:
        raise ValueError("df_residual_3d: dq must have 3 entries")
    if u.device.type == "cpu":
        return df_residual_3d_plain(u, rhs, e, dq, bcs, r32_out)

    r32, mx, u_new = _defect_cuda(u, rhs, e, dq, bcs, r32_out)
    df_residual_3d.launches += 1
    return r32, mx, u_new


def _defect_cuda(u, rhs, e, dq, bcs, r32_out=None, previous: bool = False):
    """One launch of the tile kernel, or (``previous``) of the previous
    design, one thread a point (chip_smoke.py times the two in turns)."""
    from ..utils import cuda_build

    lib = cuda_build.kernels()
    nz, ny, nx = (int(s) for s in u.shape)
    (wz, wy, wx), _ = stencils.stencil_weights(dq, torch.float64)
    r32 = torch.empty(u.shape, dtype=torch.float32, device=u.device) if r32_out is None \
        else r32_out
    u_new = torch.empty_like(u) if e is not None else u
    launch, blocks = ((lib.ndsm_defect_point_f64, lib.ndsm_defect_blocks) if previous
                      else (lib.ndsm_defect_f64, lib.ndsm_defect_tile_blocks))
    with torch.cuda.device(u.device):
        block_max = torch.empty(blocks(nz, ny, nx), dtype=torch.float32, device=u.device)
        stream = torch.cuda.current_stream(u.device).cuda_stream
        rc = launch(
            u.data_ptr(),
            None if e is None else e.data_ptr(),
            None if e is None else u_new.data_ptr(),
            None if rhs is None else rhs.data_ptr(),
            r32.data_ptr(), block_max.data_ptr(), nz, ny, nx,
            dirichlet_mask(bcs), wz, wy, wx, stream,
        )
        cuda_build.check(rc, "df_residual_3d")
    return r32, torch.max(block_max), u_new


df_residual_3d.launches = 0
