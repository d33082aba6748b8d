"""Typed options and result records (port of ``ndsm_tpu/options.py``).

Same fields and the same defaults as the JAX package, so one
configuration can drive both (``convert.options_from_reference``).
Every field and value that ``ndsm_tpu.Options`` accepts is accepted here.
``resolve_precision`` keys on a torch device instead of the JAX platform:
"auto" is "mixed" on a CUDA device and "fp64" on the CPU.  Values the port
has no meaning for raise ``ValueError``; it never accepts an option it
would silently ignore.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# Error codes (reference: fortran/ndsm_poisson.f90:46-47)
IERR_SUCCESS = 0  #: solve converged within ncycles_max
IERR_COVFAIL = 1  #: V-cycle iteration hit ncycles_max without du < vc_tol
#: invalid mesh (< 2 points along an axis, or non-uniform spacing);
#: returned by vector_potential with A = 0 and B = the input b.
IERR_BADMESH = 2

@dataclasses.dataclass(frozen=True)
class Options:
    """Solver options with the reference defaults (reference: ndsm.py:66).

    See ``ndsm_tpu.options.Options`` for the meaning of every field.
    Port-specific notes:

      use_pallas: kept for configuration parity.  The port routes by
        device, not by this flag: on a CUDA device every float32 3D
        level smooths through the hand-written CUDA kernels, on the CPU
        through their plain PyTorch versions.  "auto" and "on" are
        accepted; "off" and "interpret" raise, because the port has no
        switch that turns its kernels off on the card.
      mixed_defect: "auto" and "df32" run the outer defect in the native
        float64 CUDA kernel (ops/df.py; the f32 pair of the TPU kernel
        existed only because f64 was emulated there); "f64" runs the
        scaled plain-torch defect group of ``PoissonBVP._mixed_group``.
      smoother: "auto" and "masked" smooth float32 3D levels through the
        dense kernels (ops/zc.py, ops/fused.py).  "compact" smooths every
        float32 3D level that is not all-Neumann and has nx >= 4 on
        colour-split state through ops/compact.py (split once, the sweeps
        on the half-width colour arrays, merge once), in ``PoissonBVP``,
        ``MultiBCSolver`` and both component routes of
        ``vector_potential``; all-Neumann 3D levels, 2D levels and float64
        levels smooth as under "auto".  The iterates are the same bit for
        bit.  JAX reaches its compact kernel only where its z-compact
        kernel declines a shape; the port's dense kernels decline nothing,
        so here the compact route is an explicit request.  Any other value
        raises.
      batch_components: "on" runs the three 3D component solves of
        ``vector_potential`` as one lane-batched ``MultiBCSolver`` solve,
        "off" one after the other; "auto" batches on a CUDA device in
        mixed/fp32 precision when the three-lane working set (~48 B a
        point a lane) fits 85% of the card's memory (JAX's rule, whose
        kernel-coverage probe has no counterpart: the port's kernels take
        every shape), and runs them one after the other on the CPU.
      host_curl: compute B = curl(A) on the host (numpy, ``ops/deriv.
        curl_np_into``) from the A that is copied to the host anyway,
        instead of on the device: the same expressions, differenced in
        float64 for both output dtypes, so B agrees with the device curl
        to ~1e-14 relative, and half as many bytes cross PCIe.  The copy
        runs in z slabs into pinned host buffers on a side stream while a
        small thread pool takes the curl of each slab whose neighbours
        have landed.  Honoured only with ``flux_correction_order == 0``
        (where B is a function of the returned A alone) and without
        ``dist``; otherwise B comes from the device path.  Off by
        default: whether it pays depends on the host's PCIe link against
        its memory bandwidth and cores.  With float32 outputs B is the
        curl of the float32 A (as in JAX), so it carries A's rounding
        divided by h, which at the finest golden size shows in Eb_max.
      fetch_encoding: the wire format of the host-curl copy of float64
        outputs.  "split16" ships float32 plus an int16 fixed-point
        correction (6 bytes a point instead of 8), reconstructed on the
        host with an error of at most max|A - f32(A)| / 32767; it applies
        from 16 MB of output up (``vector_potential.SPLIT16_MIN_MB``),
        and raises if the encoding fails.  Any other value, "f64"
        included, copies the raw array.  Ignored for float32 outputs and
        on the device-curl path.  Not validated, as in the JAX package.
      per_face: solve the 3D problems one face at a time and sum them
        (the reference's IOPT_FACE1 path, dead code there, quirk Q1): 18
        component solves, one after the other, named ``A{x,y,z}_face{f}``.
        Never batched; under ``dist`` each runs on the sharded engine.
    """

    ms: int = 5
    ncycles_max: int = 1024
    niterex_max: int = 10000
    use_pallas: str = "auto"
    mixed_inner_max: int = 6
    mixed_defect: str = "auto"
    coarse_solver: str = "auto"
    smoother: str = "auto"
    batch_components: str = "auto"
    output_dtype: str = "float64"
    fetch_encoding: str = "f64"
    ex_tol: float = 1e-13
    vc_tol: float = 1e-10
    mean: bool = False
    debug: bool = False
    precision: str = "auto"
    flux_correction_order: int = 0
    host_curl: bool = False
    per_face: bool = False
    honor_ms_for_az: bool = True
    reference_flux_quirk: bool = False

    def __post_init__(self):
        if self.use_pallas not in ("auto", "on"):
            raise ValueError(
                f"use_pallas={self.use_pallas!r}: the port has no switch that "
                "turns its CUDA kernels off ('auto' or 'on' only)"
            )
        if self.mixed_defect not in ("auto", "f64", "df32"):
            raise ValueError(f"unknown mixed_defect {self.mixed_defect!r}")
        if self.smoother not in ("auto", "masked", "compact"):
            raise ValueError(f"unknown smoother {self.smoother!r}")
        if self.batch_components not in ("auto", "on", "off"):
            raise ValueError(f"unknown batch_components {self.batch_components!r}")
        if self.output_dtype not in ("float64", "float32"):
            raise ValueError(f"unknown output_dtype {self.output_dtype!r}")

    @property
    def du_max(self) -> bool:
        """True when the max-metric is in use (reference IOPT_DUMAX)."""
        return not self.mean

    def resolve_precision(self, device=None) -> str:
        """The precision mode: the explicit one, else "mixed" on a CUDA
        device and "fp64" on the CPU (``device`` is a ``torch.device`` or
        a string; None means the CPU)."""
        if self.precision != "auto":
            return self.precision
        kind = "cpu" if device is None else str(device).split(":")[0]
        return "fp64" if kind == "cpu" else "mixed"


@dataclasses.dataclass
class SolveInfo:
    """Per-solve diagnostics (same fields as ``ndsm_tpu.options.SolveInfo``)."""

    ierr: int = IERR_SUCCESS
    du_last: float = 0.0
    cycles: int = 0
    name: str = ""
    wall_time: float = 0.0
    coarse_noconv: bool = False
    batch_size: int = 1
    du_history: Optional[Tuple[float, ...]] = None


@dataclasses.dataclass
class VectorPotentialInfo:
    """Aggregate diagnostics for a full vector-potential solve."""

    ierr: int = IERR_SUCCESS
    chi: Tuple[SolveInfo, ...] = ()
    components: Tuple[SolveInfo, ...] = ()
    wall_time: float = 0.0
    #: per-phase wall seconds (keys: faces, chi, solve3d, post).
    phases: Optional[dict] = None
