"""``DiffusionOperator``'s relax and residual on 3D levels (mg/operator.py):
the wrappers of ``csrc/diffusion.cu`` and their plain versions.

``diffusion_sweep(u, rhs, a, w, bcs, flip)`` is one red-black sweep of
``div(a grad u) = rhs`` without the all-Neumann mean pinning (the operator
pins the mean after it), ``diffusion_residual(u, rhs, a, w, bcs)`` is
``rhs - L[u]``, zero on Dirichlet faces.  ``a`` is the coefficient at the
level's nodes (one array of u's shape), ``w`` the per-axis weights of
``stencils.stencil_weights``, ``flip`` the parity of the level's global index
of the array's first point (a block of a sharded level, mg/operator.Window),
which flips the colours as ``stencils.color_masks`` does.  The discretization
is ``DiffusionOperator``'s: face coefficients ``0.5 * (a + a_nb)`` with the
stencil's Neumann index reflection of ``a`` as of ``u``.

On a CUDA tensor each wrapper checks device, dtype, shape and contiguity,
launches its kernel once (float32 or float64), checks the returned error and
adds one to its launch counter (``ops.launch_counts()``), or raises.  On a
CPU tensor it runs its plain version.  The plain versions are the operator's
arithmetic as it ran before the kernels, for any number of axes:
``plain_terms`` forms the face coefficients and ``den`` from ``a``
(``face_coefficients``, then ``with_diagonal``), and
``sweep_terms`` / ``residual_terms`` take them, so the operator can keep them
for a solve (``terms=``) where it runs plain code.  The kernels equal the
plain versions bit for bit (same expression order, no multiply-add
contraction, IEEE division).  The wrappers are functional: the sweep writes
a new tensor.
"""

from __future__ import annotations

import torch

from . import stencils
from .zc import check_level, count_launch, count_plain, dirichlet_mask

__all__ = [
    "diffusion_sweep",
    "diffusion_residual",
    "diffusion_sweep_plain",
    "diffusion_residual_plain",
    "face_coefficients",
    "with_diagonal",
    "plain_terms",
    "sweep_terms",
    "residual_terms",
]


def face_coefficients(a: torch.Tensor):
    """``halves[ax] = (a_lo, a_hi)``: the face coefficients ``0.5 * (a +
    a_nb)`` of ``a`` with the neighbours of ``stencils._neighbors``."""
    halves = []
    for ax in range(a.ndim):
        lo, hi = stencils._neighbors(a, ax)
        halves.append((0.5 * (a + lo), 0.5 * (a + hi)))
    return halves


def with_diagonal(halves, w):
    """``(halves, den)``: ``den = sum_ax (a_lo + a_hi) * w[ax]`` in axis
    order."""
    den = None
    for ax, (alo, ahi) in enumerate(halves):
        t = (alo + ahi) * w[ax]
        den = t if den is None else den + t
    return halves, den


def plain_terms(a: torch.Tensor, w):
    """What the plain versions compute from: ``with_diagonal`` of
    ``face_coefficients(a)``."""
    return with_diagonal(face_coefficients(a), w)


def sweep_terms(u, rhs, terms, w, bcs, flip: int = 0) -> torch.Tensor:
    """The sweep from ``plain_terms``: per colour ``u = (num - rhs) / den``
    where the colour is, ``num = sum_ax (a_lo * u_lo + a_hi * u_hi) * w[ax]``
    in axis order."""
    halves, den = terms
    for mask in stencils.color_masks(tuple(u.shape), bcs, u.device, (flip,)):
        num = None
        for ax in range(u.ndim):
            lo, hi = stencils._neighbors(u, ax)
            alo, ahi = halves[ax]
            t = (alo * lo + ahi * hi) * w[ax]
            num = t if num is None else num + t
        u = torch.where(mask, (num - rhs) / den, u)
    return u


def residual_terms(u, rhs, terms, w, bcs) -> torch.Tensor:
    """The residual from ``plain_terms``: ``rhs - sum_ax (a_hi * (u_hi - u)
    - a_lo * (u - u_lo)) * w[ax]``, zero on Dirichlet faces."""
    halves, _ = terms
    out = None
    for ax in range(u.ndim):
        lo, hi = stencils._neighbors(u, ax)
        alo, ahi = halves[ax]
        term = (ahi * (hi - u) - alo * (u - lo)) * w[ax]
        out = term if out is None else out + term
    r = rhs - out
    return r.masked_fill(~stencils.interior_mask(tuple(u.shape), bcs, u.device), 0.0)


def diffusion_sweep_plain(u, rhs, a, w, bcs, flip: int = 0, terms=None) -> torch.Tensor:
    """Plain PyTorch version of :func:`diffusion_sweep` (``terms``: the
    ``plain_terms`` of ``a`` and ``w``, if the caller keeps them)."""
    count_plain(diffusion_sweep_plain, u)
    return sweep_terms(u, rhs, plain_terms(a, w) if terms is None else terms, w, bcs, flip)


def diffusion_residual_plain(u, rhs, a, w, bcs, terms=None) -> torch.Tensor:
    """Plain PyTorch version of :func:`diffusion_residual`."""
    count_plain(diffusion_residual_plain, u)
    return residual_terms(u, rhs, plain_terms(a, w) if terms is None else terms, w, bcs)


def _check(name: str, u, rhs, a, w, bcs):
    if not isinstance(u, torch.Tensor) or u.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: u must be a float32 or float64 tensor")
    check_level(name, (u, rhs, a), u.dtype)
    if len(w) != 3:
        raise ValueError(f"{name}: w must have 3 entries")
    return stencils.validate_bcs(bcs, 3)


def diffusion_sweep(u, rhs, a, w, bcs, flip: int = 0, terms=None) -> torch.Tensor:
    """One red-black sweep of ``div(a grad u) = rhs`` (module docstring):
    on a CUDA tensor one launch of ``csrc/diffusion.cu``; ``terms`` is the
    plain version's and is not used there."""
    bcs = _check("diffusion_sweep", u, rhs, a, w, bcs)
    if flip not in (0, 1):
        raise ValueError(f"diffusion_sweep: flip must be 0 or 1, got {flip}")
    if u.device.type == "cpu":
        return diffusion_sweep_plain(u, rhs, a, w, bcs, flip, terms)
    c0 = stencils.first_color_parity(bcs) ^ flip
    out = _launch("sweep", u, rhs, a, bcs, w, c0)
    count_launch(diffusion_sweep)
    return out


def diffusion_residual(u, rhs, a, w, bcs, terms=None) -> torch.Tensor:
    """``rhs - L[u]``, zero on Dirichlet faces (module docstring): on a CUDA
    tensor one launch of ``csrc/diffusion.cu``."""
    bcs = _check("diffusion_residual", u, rhs, a, w, bcs)
    if u.device.type == "cpu":
        return diffusion_residual_plain(u, rhs, a, w, bcs, terms)
    out = _launch("residual", u, rhs, a, bcs, w)
    count_launch(diffusion_residual)
    return out


def _launch(kind: str, u, rhs, a, bcs, w, *extra) -> torch.Tensor:
    """One launch of the ``kind`` kernel into a new tensor of u's shape,
    which it returns."""
    from ..utils import cuda_build

    lib = cuda_build.kernels()
    out = torch.empty_like(u)
    f32 = u.dtype == torch.float32
    if kind == "sweep":
        fn = lib.ndsm_diffusion_sweep_f32 if f32 else lib.ndsm_diffusion_sweep_f64
    else:
        fn = lib.ndsm_diffusion_residual_f32 if f32 else lib.ndsm_diffusion_residual_f64
    nz, ny, nx = u.shape
    with torch.cuda.device(u.device):
        rc = fn(u.data_ptr(), rhs.data_ptr(), a.data_ptr(), out.data_ptr(), nz, ny, nx,
                dirichlet_mask(bcs), *extra, *w,
                torch.cuda.current_stream(u.device).cuda_stream)
    cuda_build.check(rc, f"diffusion_{kind}")
    return out
