"""User-facing API (port of ``ndsm_tpu/api.py``): the reference's
``ndsm.vector_potential`` signature (reference ndsm.py:66-210) and its
``(ierr, A, B)`` return with numpy arrays, plus one keyword-only
``device`` argument.

``device="cuda"`` (the default) runs on the CUDA device and raises when
there is none; ``device="cpu"`` runs the same pipeline on the CPU with the
kernels' plain PyTorch versions.  Nothing chooses the device for you.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from .options import Options
from .potential.vector_potential import compute_vector_potential

__all__ = ["vector_potential"]


def vector_potential(
    x,
    y,
    z,
    b,
    niterex_max: int = 10000,
    ncycles_max: int = 1024,
    ex_tol: float = 1e-13,
    vc_tol: float = 1e-10,
    ms: int = 5,
    mean: bool = False,
    libname: Optional[str] = None,  # accepted for reference compatibility
    libpath: Optional[str] = None,  # accepted for reference compatibility
    debug: bool = False,
    *,
    precision: str = "auto",
    options: Optional[Options] = None,
    full_output: bool = False,
    dist=None,
    device: str = "cuda",
):
    """Compute the potential magnetic field and Coulomb-gauge vector
    potential from boundary Bn (see ``ndsm_tpu.api.vector_potential``).

    Returns (ierr, A, B) with A, B numpy arrays of shape (3, nz, ny, nx)
    (float64 unless ``options.output_dtype`` says float32), plus the
    diagnostics record when ``full_output``; its ``phases`` gain a
    "fetch" entry, the copy of A and B to the host (with
    ``Options.host_curl``, the pipeline's own "host_alloc", "slab_split",
    "fetch" and "curl": A alone is copied and B is its curl taken on the
    host).  ``options`` carries
    what the signature does not name, such as ``batch_components`` and
    ``smoother`` ("compact": the component solves smooth on colour-split
    state, with the same iterates; see ``Options``).

    ``dist``: optional ``ndsm_tpu_torch.parallel.shard.DistConfig`` -- run
    every sub-solve on the sharded engine over a device mesh (spatial
    domain decomposition; sub-problems whose shapes cannot be partitioned
    run on one device).  Its mesh's devices must be of ``device``'s type,
    e.g. ``DistConfig(make_mesh(2, devices=["cuda:0"] * 2))`` on one card
    or ``make_mesh(4, devices=["cpu"] * 4)`` with ``device="cpu"``.  A 2-D
    (z, y) mesh, ``DistConfig(make_mesh_nd((2, 2), devices=["cuda:0"] *
    4), ("z", "y"))``, partitions the 3D component solves in z and y and
    the 2D chi faces in z.
    """
    if options is None:
        options = Options(
            ms=ms,
            ncycles_max=ncycles_max,
            niterex_max=niterex_max,
            ex_tol=ex_tol,
            vc_tol=vc_tol,
            mean=mean,
            debug=debug,
            precision=precision,
        )
    ierr, A, B, info = compute_vector_potential(
        (x, y, z), np.asarray(b), options, device=device, dist=dist
    )
    if isinstance(A, torch.Tensor):  # not the host-curl pipeline: copy A and B
        t0 = time.perf_counter()
        A = A.cpu().numpy()
        B = B.cpu().numpy()
        if info.phases is not None:
            info.phases["fetch"] = time.perf_counter() - t0
    if full_output:
        return ierr, A, B, info
    return ierr, A, B
