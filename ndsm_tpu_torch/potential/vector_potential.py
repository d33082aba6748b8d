"""3D Coulomb-gauge vector-potential pipeline on torch tensors (port of
``ndsm_tpu/potential/vector_potential.py``).

Given the normal component of B on the six faces of a box, computes the
current-free field B and a vector potential A with ``B = curl(A)``,
``div(A) = 0`` (Yang, Wheatland & Gilchrist 2020; reference
compute_vector_potential, fortran/ndsm_vector_potential.f90:130-497):

  1. Bn on the six faces and their trapezoid fluxes (``_phase_pre``);
  2. six flux-balanced all-Neumann 2D solves for chi, lane-batched per
     face hierarchy (``PoissonBVP.solve_batch``);
  3. tangential boundary data At = -grad(chi) x n (``_phase_at_u0``);
  4. three 3D mixed-BC solves, one per component: as one lane-batched
     ``MultiBCSolver`` solve (mg/batched.py, the lane kernels of
     ops/fused.py) when ``Options.batch_components`` says so
     (``_batch_components``: "on", or "auto" on a CUDA device outside
     fp64 when three lanes fit the card), else one ``PoissonBVP`` solve
     after the other.  A lane's result does not depend on the other lanes
     and agrees with the sequential solve to within 5e-9 and one cycle.
     ``Options.smoother`` rides in ``options`` to both routes: "compact"
     smooths their float32 levels through ops/compact.py, with the same
     iterates as the dense kernels;
  5. the analytic flux-balance correction and B = curl(A) on the device
     (``_phase_post``).

With ``dist`` (a ``parallel.shard.DistConfig``) every sub-solve whose
shapes can be partitioned runs on the sharded engine
(``parallel/sm_engine.py``) over ``dist.mesh``, as the JAX pipeline does:
each group of chi faces as one lane-masked ``solve_batch``, the three
components one after the other (no component batching under ``dist``),
each a zero-rhs ``solve``; a sub-problem that cannot be partitioned runs
on ``device``.  A sub-problem partitions the leading ``ndim - 1`` names of
``dist.axis_names``: on a (z, y) mesh the 3D components partition z and
y, and the 2D chi faces z alone, on the mesh's z line at y index 0 (the
other lines would hold copies, which one controller need not compute).
The mesh's devices must be of ``device``'s type.

``Options.per_face`` solves the 3D problems one face at a time, the
tangential data of that face alone, and sums them: 18 component solves,
one after the other (never batched), each under ``dist`` on the sharded
engine (JAX ``vector_potential.py:449-452``).

Everything after the face extraction stays on the device, and the API
copies A and B to the host at the end, unless ``Options.host_curl`` says
otherwise (with ``flux_correction_order == 0`` and no ``dist``): then only
A is copied, in z slabs into pinned host buffers on a side stream, and B
is its curl taken on the host slab by slab while later slabs are still
in flight (``_fetch_and_curl``); ``fetch_encoding="split16"`` ships large
float64 outputs as float32 plus an int16 correction.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import threading
import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..grids import GridHierarchy, mesh_uniformity_error
from ..mg.batched import MultiBCSolver
from ..mg.poisson import get_poisson_bvp
from ..ops.deriv import curl, curl_np_into
from ..ops.reduce import trapz_2d
from ..options import IERR_BADMESH, Options, VectorPotentialInfo
from ..parallel.sm_engine import ShardedPoissonBVP, seam_of
from ..utils.caching import BoundedCache
from ..utils.device import resolve_device
from ..utils.msgs import debug_msg
from . import faces as F

__all__ = ["compute_vector_potential"]

_SUB = "compute_vector_potential"

_DTYPES = {"float64": torch.float64, "float32": torch.float32}

#: torch.profiler ranges around the chi and solve3d phases (each
#: synchronised at its end).
CHI_RANGE = "ndsm.chi_phase"
SOLVE3D_RANGE = "ndsm.solve3d_phase"

_MBS_CACHE: BoundedCache = BoundedCache(maxsize=8)
_DIST_BVP_CACHE: BoundedCache = BoundedCache(maxsize=32)

#: Working set of the batched component solve, bytes a point a lane (the
#: float64 iterate and defect, the float32 correction hierarchy and
#: temporaries), as in the JAX package's rule.
_BATCH_BYTES_PER_POINT = 48.0

#: ``fetch_encoding="split16"`` applies to float64 outputs of at least this
#: many MB (1e6 bytes); below it the encoding's fixed cost outweighs the
#: bytes it saves (the JAX package's NDSM_TPU_SPLIT16_MIN_MB default).
SPLIT16_MIN_MB = 16.0
#: The host-curl copy cuts each component into at most FETCH_SLABS z
#: slabs, one per FETCH_SLAB_MB of output and at least 3 planes a slab (the
#: one-sided z stencils at the faces span 3 planes).
FETCH_SLABS = 8
FETCH_SLAB_MB = 8.0
#: Threads of the host curl (and of the split16 reconstruction).
CURL_WORKERS = 3


def _dbg(options: Options, msg: str) -> None:
    if options.debug:
        debug_msg(_SUB, msg)


def _central_diff_zero_edges(c: torch.Tensor, h: float, axis: int) -> torch.Tensor:
    """Central difference along ``axis``, zero on the first and last layer
    (reference compute_At_bcs, ndsm_vector_potential.f90:1006-1017)."""
    npdt = np.float32 if c.dtype == torch.float32 else np.float64
    inv2h = float(npdt(0.5 / h))
    n = c.shape[axis]
    interior = (c.narrow(axis, 2, n - 2) - c.narrow(axis, 0, n - 2)) * inv2h
    z = torch.zeros_like(c.narrow(axis, 0, 1))
    return torch.cat([z, interior, z], dim=axis)


def _phase_pre(bn, spacings, areas):
    """Fluxes and flux-balanced chi right-hand sides for all six faces."""
    phi = torch.stack(
        [trapz_2d(bn[f], spacings[f][0], spacings[f][1]) for f in range(6)]
    )
    rhs = tuple(bn[f] - phi[f] / areas[f] for f in range(6))
    return rhs, phi


def _phase_at_u0(chi, hs, signs, vol_shape, dtype, device, active_face: Optional[int] = None):
    """At = -grad(chi) x n on every face, scattered into the three
    component initial guesses (their Dirichlet data); with ``active_face``
    only that face's data is scattered (``Options.per_face``)."""
    At1, At2 = [], []
    for f in range(6):
        h1, h2 = hs[f]
        dchi_d1 = _central_diff_zero_edges(chi[f], h1, axis=1)
        dchi_d2 = _central_diff_zero_edges(chi[f], h2, axis=0)
        s1, s2 = signs[f]
        At1.append(s1 * dchi_d2)
        At2.append(s2 * dchi_d1)
    u0s = []
    for comp in range(3):
        u0 = torch.zeros(vol_shape, dtype=dtype, device=device)
        for f in range(6):
            if F.FACE_COMP[f] == comp or active_face not in (None, f):
                continue
            slot = F.face_at_component(f, comp)
            u0[F.face_volume_index(f, vol_shape)] = At1[f] if slot == 1 else At2[f]
        u0s.append(u0)
    return u0s


def _add_flux_balance_fields(mesh_xyz, Lq, phi, B, A):
    """Analytic flux-balance fields (reference add_flux_balance_fields,
    ndsm_vector_potential.f90:880-950); ``B=None`` skips the field part."""
    dtype = A.dtype
    x = mesh_xyz[0].to(dtype)[None, None, :]
    y = mesh_xyz[1].to(dtype)[None, :, None]
    z = mesh_xyz[2].to(dtype)[:, None, None]
    V = float(np.prod(np.asarray(Lq)))
    g = torch.stack(
        [(phi[1] - phi[0]) / V, (phi[3] - phi[2]) / V, (phi[5] - phi[4]) / V]
    ).to(dtype)
    bc = None
    if B is not None:
        bc = torch.stack(
            [
                g[0] * x + phi[0] * Lq[0] / V + 0.0 * (y + z),
                g[1] * y + phi[2] * Lq[1] / V + 0.0 * (x + z),
                g[2] * z + phi[4] * Lq[2] / V + 0.0 * (x + y),
            ]
        )
    # A1_l + A2_l + A3_l = [(g2-g3) y z, (g3-g1) x z, (g1-g2) x y] (:932-934)
    lin = torch.stack(
        [
            (g[1] - g[2]) * y * z + 0.0 * x,
            (g[2] - g[0]) * x * z + 0.0 * y,
            (g[0] - g[1]) * x * y + 0.0 * z,
        ]
    )
    # Constant-term potential (:937-939)
    Ac = torch.stack(
        [
            -phi[4] * Lq[2] * y / V + 0.0 * (x + z),
            -phi[0] * Lq[0] * z / V + 0.0 * (x + y),
            -phi[2] * Lq[1] * x / V + 0.0 * (y + z),
        ]
    )
    B_out = None if B is None else B + bc
    return B_out, A + Ac + lin / 3.0


def _phase_post(A, phi, xs, ys, zs, Lq, dq, order, out_dtype):
    """Flux-balance correction and curl, in the selected order (:453-477)."""
    mesh_xyz = (xs, ys, zs)
    if order == 1:
        B = curl(A, dq)
        B, A = _add_flux_balance_fields(mesh_xyz, Lq, phi, B, A)
    else:
        _, A = _add_flux_balance_fields(mesh_xyz, Lq, phi, None, A)
        B = curl(A, dq)
    return A.to(out_dtype), B.to(out_dtype)


def _phase_post_acorr(A, phi, xs, ys, zs, Lq, out_dtype):
    """The order-0 flux-balance A correction without the curl, then the
    cast to the output dtype: the device side of ``Options.host_curl``,
    after which B = curl(A) is a function of this A alone (JAX
    ``_phase_post_acorr``)."""
    _, A = _add_flux_balance_fields((xs, ys, zs), Lq, phi, None, A)
    return A.to(out_dtype)


def _fetch_and_curl(A, dq, out_dtype, mark, encoding) -> Tuple[np.ndarray, np.ndarray]:
    """Copy A (3, nz, ny, nx) to the host in z slabs and take B = curl(A)
    there, slab by slab as each slab's neighbourhood lands (JAX
    ``_fetch_and_curl_pipelined``).  Returns numpy (A, B) of A's dtype.

    On a CUDA device every slab is copied, component by component and
    slab after slab, into pinned host buffers on a side stream, all
    copies enqueued at once; the host waits on each slab's event in turn,
    and a pool of ``CURL_WORKERS`` threads runs ``curl_np_into`` on each
    half of slab j once slabs j - 1 .. j + 1 of all three components have
    landed, while the later slabs still copy.  On the CPU the same
    function copies the slabs on the host.  Phases marked: "host_alloc"
    (the host buffers), "slab_split" (the split16 encoding on the
    device), "fetch" (every slab on the host) and "curl" (the last curl).

    ``encoding="split16"`` with float64 A of at least ``SPLIT16_MIN_MB``:
    the device computes hi = f32(A), corr = A - f64(hi), s = max|corr|
    and q = round(corr * 32767 / s) as int16 (scale 0 when s = 0), the
    slabs of hi and q cross (6 bytes a point instead of 8), and the host
    rebuilds hi + q * (s / 32767), within max|A - f32(A)| / 32767 of A.
    A failure of the encoding raises; nothing falls back to the raw copy.

    Left out of the JAX pipeline: its several concurrent download streams
    (``NDSM_TPU_FETCH_STREAMS``), which served a network relay that capped
    each stream's rate.  Copies to the host share the one PCIe link, so
    more streams add no bandwidth: one side stream carries every slab.
    The returned A of the raw copy is a view of its pinned buffer, which
    it keeps alive."""
    dev = A.device
    cuda = dev.type == "cuda"
    nz = int(A.shape[1])
    total_mb = A.numel() * A.element_size() / 1e6
    nslab = max(1, min(FETCH_SLABS, nz // 3, int(total_mb / FETCH_SLAB_MB)))
    bounds = [(k * nz) // nslab for k in range(nslab)] + [nz]
    tasks = [(i, k) for k in range(nslab) for i in range(3)]
    split16 = encoding == "split16" and A.dtype == torch.float64 and total_mb >= SPLIT16_MIN_MB

    # host buffers: what crosses is pinned on a CUDA device
    shape = tuple(A.shape)
    wire = (torch.float32, torch.int16) if split16 else (A.dtype,)
    if cuda:
        pinned = [torch.empty(shape, dtype=d, pin_memory=True) for d in wire]
    host = np.empty(shape, dtype=out_dtype) if split16 or not cuda else pinned[0].numpy()
    B = np.empty(shape, dtype=host.dtype)
    mark("host_alloc")

    inv_scale = 0.0
    if split16:
        hi = A.to(torch.float32)
        corr = A - hi.to(torch.float64)
        s = torch.max(torch.abs(corr))
        scale = torch.where(s > 0, 32767.0 / s, torch.zeros_like(s))
        src = (hi, torch.round(corr * scale).to(torch.int16))
        del corr
        inv_scale = float(s) / 32767.0
    else:
        src = (A,)
    mark("slab_split")

    events = {}
    if cuda:
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for i, k in tasks:
                z = slice(bounds[k], bounds[k + 1])
                for a, p in zip(src, pinned):
                    p[i, z].copy_(a[i, z], non_blocking=True)
                events[(i, k)] = torch.cuda.Event()
                events[(i, k)].record(side)
        wire_np = [p.numpy() for p in pinned]
    else:
        wire_np = [a.numpy() for a in src]

    done = np.zeros((3, nslab), dtype=bool)
    curled = np.zeros(nslab, dtype=bool)
    lock = threading.Lock()
    curl_futs = []
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=CURL_WORKERS)

    def ready(j):
        return done[:, max(0, j - 1): j + 2].all()

    def land(i, k):
        """Slab (i, k) is on the host: finish it, then start every curl
        slab whose neighbourhood is now complete (two halves each)."""
        z = slice(bounds[k], bounds[k + 1])
        if split16:
            host[i, z] = wire_np[0][i, z] + wire_np[1][i, z] * inv_scale
        elif not cuda:
            host[i, z] = wire_np[0][i, z]
        with lock:
            done[i, k] = True
            for j in range(max(0, k - 1), min(nslab, k + 2)):
                if not curled[j] and ready(j):
                    curled[j] = True
                    z0, z1 = bounds[j], bounds[j + 1]
                    zm = (z0 + z1) // 2
                    curl_futs.extend(pool.submit(curl_np_into, host, dq, B, a, b)
                                     for a, b in ((z0, zm), (zm, z1)) if b > a)

    try:
        rebuilt = []
        for t in tasks:
            if cuda:
                events[t].synchronize()
            if split16:
                rebuilt.append(pool.submit(land, *t))
            else:
                land(*t)
        for f in rebuilt:
            f.result()
        mark("fetch")
        for f in curl_futs:
            f.result()
    finally:
        pool.shutdown(wait=True)
    if not curled.all():
        raise AssertionError("the host curl missed a slab")
    mark("curl")
    return host, B


def _batch_components(options: Options, mode: str, shape, dev: torch.device) -> bool:
    """Whether the three component solves run as one ``MultiBCSolver``
    solve: JAX's rule (ndsm_tpu/potential/vector_potential.py:395-448)
    restated for the card.  Never with ``per_face`` or with
    ``honor_ms_for_az`` False (the lanes' ms would differ); "auto" batches
    on a CUDA device in mixed/fp32 precision when three lanes of ~48 B a
    point fit 85% of its memory."""
    bc = options.batch_components
    if bc == "off" or options.per_face or not options.honor_ms_for_az:
        return False
    if bc == "on":
        return True
    if mode == "fp64" or dev.type != "cuda":
        return False
    total = torch.cuda.get_device_properties(dev).total_memory
    return 3.0 * float(np.prod(shape)) * _BATCH_BYTES_PER_POINT < 0.85 * total


def _dist_bvp(hierarchy, bcs, options: Options, dist):
    """The sharded engine of this sub-problem, or None when its shapes
    cannot be partitioned over the mesh (it then runs on one device).
    Keyed by the whole options tuple, as in the JAX pipeline."""
    key = (hierarchy, tuple(tuple(b) for b in bcs), dataclasses.astuple(options), dist)
    bvp = _DIST_BVP_CACHE.get(key)
    if bvp is None:
        bvp = False  # (cached too: not partitionable)
        names = tuple(dist.axis_names[: hierarchy.ndim - 1])
        counts = dist.mesh.submesh(names).shape  # the shards of the axes it partitions
        if seam_of(hierarchy, counts, dist.min_rows_per_shard):
            bvp = ShardedPoissonBVP(
                hierarchy, bcs, options, mesh=dist.mesh, axis_names=names,
                min_rows_per_shard=dist.min_rows_per_shard,
            )
        _DIST_BVP_CACHE.put(key, bvp)
    return bvp or None


def _solve_components(u0s, hierarchy, bcs_list, options: Options, out_dtype, dev, dist=None,
                      active_face: Optional[int] = None):
    """The three component solves one after the other (``PoissonBVP``, or
    the sharded engine under ``dist``); ``u0s`` is emptied as they go.
    ``active_face`` names the solves of one face (``Options.per_face``).
    Returns (A, infos)."""
    comp_info = []
    comps = []
    for comp, bcs in enumerate(bcs_list):
        opts = options
        if comp == 2 and not options.honor_ms_for_az:
            opts = dataclasses.replace(options, ms=5)  # quirk Q3 (:685)
        name = f"A{'xyz'[comp]}" + ("" if active_face is None else f"_face{active_face}")
        sbvp = _dist_bvp(hierarchy, bcs, opts, dist) if dist is not None else None
        if sbvp is not None:
            u, info = sbvp.solve(u0s[comp], None, zero_rhs=True, name=name)
            u = u.to(dev)
        else:
            bvp = get_poisson_bvp(hierarchy, bcs, opts, device=dev)
            u, info = bvp.solve(
                u0s[comp], None, vc_tol=options.vc_tol, ex_tol=options.ex_tol,
                ncycles_max=options.ncycles_max, niterex_max=options.niterex_max,
                name=name, zero_rhs=True,
            )
        u0s[comp] = None
        comp_info.append(info)
        # float32 outputs: downcast early (frees the f64 solution)
        comps.append(u.to(out_dtype) if out_dtype == torch.float32 else u)
    return torch.stack(comps), comp_info


def compute_vector_potential(
    meshes: Sequence[np.ndarray],
    b,
    options: Options = Options(),
    device="cuda",
    dist=None,
) -> Tuple[int, torch.Tensor, torch.Tensor, VectorPotentialInfo]:
    """Compute (ierr, A, B, info) from boundary Bn on ``device``.

    Args:
      meshes: (x, y, z) 1-D coordinate vectors (uniform spacing each).
      b: (3, nz, ny, nx) array; only the normal components on the six
        boundary faces are read (quirk Q12) — B is recomputed in full.
      options: solver options.
      device: "cuda" (raises without a CUDA device) or "cpu".
      dist: optional ``parallel.shard.DistConfig`` (module docstring); a
        mesh whose devices are not of ``device``'s type raises ValueError.

    Returns:
      ierr (max over all sub-solves), A and B as (3, nz, ny, nx) tensors
      on ``device`` (numpy arrays on the host when ``Options.host_curl``
      applies), and the per-solve diagnostics.
    """
    dev = resolve_device(device)
    if dist is not None and any(torch.device(d).type != dev.type for d in dist.mesh.devices):
        raise ValueError(f"dist.mesh devices {dist.mesh.devices} do not match "
                         f"device={str(device)!r}")
    t0 = time.perf_counter()
    phases: dict = {}
    t_last = [t0]

    def _mark(name):
        """Wall time since the previous mark, after the device is idle."""
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        now = time.perf_counter()
        phases[name] = phases.get(name, 0.0) + (now - t_last[0])
        t_last[0] = now

    mesh_in = tuple(np.asarray(m) for m in meshes)
    x, y, z = (np.asarray(m, dtype=np.float64) for m in meshes)
    mesh_xyz = (x, y, z)
    mode = options.resolve_precision(dev)
    dtype = torch.float32 if mode == "fp32" else torch.float64

    def _badmesh_return():
        # The reference returns a nonzero flag for a bad mesh
        # (ndsm_vector_potential.f90:212-215): A = 0, B = the input b.
        b_t = torch.as_tensor(np.asarray(b), dtype=dtype, device=dev)
        info = VectorPotentialInfo(ierr=IERR_BADMESH, wall_time=time.perf_counter() - t0)
        return IERR_BADMESH, torch.zeros_like(b_t), b_t.clone(), info

    for i, m in enumerate(mesh_xyz):
        if m.ndim != 1:
            raise ValueError(f"mesh vector {i} must be 1-D")
        if m.size < 2 or mesh_uniformity_error(mesh_in[i]) is not None:
            return _badmesh_return()
    # Narrow-dtype meshes are regenerated as exactly uniform f64 over the
    # same extent (f64 inputs stay bit-identical).
    x, y, z = (
        m if mi.dtype == np.float64 else np.linspace(float(m[0]), float(m[-1]), m.size)
        for mi, m in zip(mesh_in, mesh_xyz)
    )
    mesh_xyz = (x, y, z)
    b = np.asarray(b)
    nz, ny, nx = len(z), len(y), len(x)
    if b.shape != (3, nz, ny, nx):
        raise ValueError(f"b shape {b.shape} != (3, {nz}, {ny}, {nx})")

    Lq = np.array([m.max() - m.min() for m in mesh_xyz])
    dq = np.array([m[1] - m[0] for m in mesh_xyz])

    # ---- faces: Bn, fluxes, areas (only the six faces are uploaded)
    _dbg(options, "Extract boundary conditions and face fluxes...")
    bn = []
    for f in range(6):
        comp = F.FACE_COMP[f]
        idx = F.face_volume_index(f, (nz, ny, nx))
        bn.append(torch.as_tensor(np.ascontiguousarray(b[comp][idx]), dtype=dtype, device=dev))
    spacings = []
    for f in range(6):
        d1, d2 = F.FACE_DIMS[f]
        if options.reference_flux_quirk:
            spacings.append((float(dq[0]), float(dq[1])))
        else:
            spacings.append((float(dq[d2]), float(dq[d1])))
    areas = tuple(float(Lq[d1] * Lq[d2]) for (d1, d2) in F.FACE_DIMS)
    chi_rhs, phi = _phase_pre(bn, spacings, areas)
    _mark("faces")

    # ---- six all-Neumann 2D solves, one lane-batched solve per hierarchy
    _dbg(options, "Solve BVP on each boundary...")
    chi = [None] * 6
    chi_info = [None] * 6
    groups = {}
    for f in range(6):
        d1, d2 = F.FACE_DIMS[f]
        hierarchy = GridHierarchy.from_mesh((mesh_xyz[d2], mesh_xyz[d1]))
        groups.setdefault(hierarchy, []).append(f)
    # The named range lets a torch.profiler trace attribute device work and
    # launches to this phase (chip_smoke.py reads it).
    with torch.profiler.record_function(CHI_RANGE):
        for hierarchy, faces_in_group in groups.items():
            rhss = [chi_rhs[f] for f in faces_in_group]
            u0s = [torch.zeros_like(r) for r in rhss]
            names = [f"chi_face{f}" for f in faces_in_group]
            bcs2 = (("N", "N"), ("N", "N"))
            sbvp = _dist_bvp(hierarchy, bcs2, options, dist) if dist is not None else None
            if sbvp is not None:
                us, infos = sbvp.solve_batch(u0s, rhss, names=names)
            else:
                bvp = get_poisson_bvp(hierarchy, bcs2, options, device=dev)
                us, infos = bvp.solve_batch(
                    u0s, rhss, vc_tol=options.vc_tol, ex_tol=options.ex_tol,
                    ncycles_max=options.ncycles_max, niterex_max=options.niterex_max,
                    names=names,
                )
            for k, f in enumerate(faces_in_group):
                chi[f] = us[k].to(dev)
                chi_info[f] = infos[k]
        _mark("chi")

    # ---- At = -grad(chi) x n (:387-399, 977-1031)
    _dbg(options, "Compute vector potential boundary conditions...")
    hs = []
    for f in range(6):
        d1, d2 = F.FACE_DIMS[f]
        if options.reference_flux_quirk:
            hs.append((float(dq[F.FACE_COMP[f]]),) * 2)
        else:
            hs.append((float(dq[d1]), float(dq[d2])))
    signs = tuple(F.at_signs(f) for f in range(6))

    # ---- three 3D mixed-BC solves (:598-691): batched or one at a time
    _dbg(options, "Solve BVP 3D...")
    out_dtype = _DTYPES[options.output_dtype]
    hierarchy = GridHierarchy.from_mesh((z, y, x))
    # Neumann on the faces normal to the component, Dirichlet elsewhere
    bcs_list = tuple(
        tuple(("N", "N") if (2 - axis) == comp else ("D", "D") for axis in range(3))
        for comp in range(3)
    )
    with torch.profiler.record_function(SOLVE3D_RANGE):
        if options.per_face:
            # one face at a time, summed; each solve is cast to the output
            # dtype before the add into A of the working dtype (as in JAX)
            A = torch.zeros((3, nz, ny, nx), dtype=dtype, device=dev)
            comp_info = []
            for f in range(6):
                u0s = _phase_at_u0(chi, hs, signs, (nz, ny, nx), dtype, dev, active_face=f)
                A_f, infos = _solve_components(u0s, hierarchy, bcs_list, options, out_dtype,
                                               dev, dist, active_face=f)
                A = A + A_f
                comp_info += infos
                del A_f
        elif dist is None and _batch_components(options, mode, (nz, ny, nx), dev):
            u0s = _phase_at_u0(chi, hs, signs, (nz, ny, nx), dtype, dev)
            key = (hierarchy, bcs_list, dataclasses.astuple(options), str(dev))
            mbs = _MBS_CACHE.get(key)
            if mbs is None:
                mbs = MultiBCSolver(hierarchy, bcs_list, options, device=dev)
                _MBS_CACHE.put(key, mbs)
            u0 = torch.stack(u0s)
            del u0s
            A, comp_info = mbs.solve(u0, names=["Ax", "Ay", "Az"])
            del u0
            A = A.to(out_dtype) if out_dtype == torch.float32 else A
        else:
            u0s = _phase_at_u0(chi, hs, signs, (nz, ny, nx), dtype, dev)
            A, comp_info = _solve_components(u0s, hierarchy, bcs_list, options, out_dtype, dev,
                                             dist)
        _mark("solve3d")

    # ---- flux-balance correction + curl (:453-477)
    _dbg(options, "Compute B = curl(A) and flux correction...")
    xs, ys, zs = (torch.as_tensor(m, dtype=dtype, device=dev) for m in (x, y, z))
    Lq_t, dq_t = tuple(float(v) for v in Lq), tuple(float(v) for v in dq)
    if options.host_curl and int(options.flux_correction_order) == 0 and dist is None:
        # B = curl(final A) under order 0: take it on the host from the A
        # that is copied there anyway (Options.host_curl).  Under order 1 B
        # holds the analytic field correction as well, and under dist JAX
        # keeps the device path: both take the branch below.
        A = _phase_post_acorr(A, phi, xs, ys, zs, Lq_t, out_dtype)
        _mark("post")
        A, B = _fetch_and_curl(A, dq_t, options.output_dtype, _mark, options.fetch_encoding)
    else:
        A, B = _phase_post(A, phi, xs, ys, zs, Lq_t, dq_t, int(options.flux_correction_order),
                           out_dtype)
        _mark("post")

    ierr = max([s.ierr for s in chi_info] + [s.ierr for s in comp_info])
    info = VectorPotentialInfo(
        ierr=ierr, chi=tuple(chi_info), components=tuple(comp_info),
        wall_time=time.perf_counter() - t0, phases=phases,
    )
    return ierr, A, B, info
