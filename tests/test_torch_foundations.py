"""Port foundations against ndsm_tpu: options, grid hierarchies, transfer
and coarse-solve matrices, face tables, message texts.

Tolerance: none — everything here is numpy or plain Python arithmetic in
the same order in both packages, so it must be bitwise equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

import ndsm_tpu
import ndsm_tpu_torch
from ndsm_tpu.grids import GridHierarchy as JGrid, mesh_uniformity_error as j_uniform
from ndsm_tpu.mg import coarse as jcoarse, poisson as jpoisson
from ndsm_tpu.ops import transfer as jtransfer
from ndsm_tpu.potential import faces as jfaces
from ndsm_tpu.utils.testing import build_test_mesh
from ndsm_tpu_torch import convert
from ndsm_tpu_torch.grids import GridHierarchy as TGrid, mesh_uniformity_error as t_uniform
from ndsm_tpu_torch.mg import coarse as tcoarse, poisson as tpoisson
from ndsm_tpu_torch.mg.engine import MGEngine
from ndsm_tpu_torch.ops import transfer as ttransfer
from ndsm_tpu_torch.potential import faces as tfaces

torch.set_num_threads(1)

GOLDEN_SIZES = (22, 44, 66, 77, 88, 99, 160, 176, 220)
ODD_SIZES = (13, 37, 101, 255)


def _same_hierarchy(a, b):
    assert a.ndim == b.ndim and a.ngrids == b.ngrids
    assert a.shapes == b.shapes
    assert a.dq == b.dq
    for la, lb in zip(a.meshes, b.meshes):
        for ma, mb in zip(la, lb):
            assert ma.dtype == mb.dtype and np.array_equal(ma, mb)


def test_options_defaults_equal():
    assert dataclasses.asdict(ndsm_tpu.Options()) == dataclasses.asdict(ndsm_tpu_torch.Options())
    assert [f.name for f in dataclasses.fields(ndsm_tpu.Options)] == [
        f.name for f in dataclasses.fields(ndsm_tpu_torch.Options)
    ]
    assert dataclasses.asdict(ndsm_tpu.SolveInfo()) == dataclasses.asdict(ndsm_tpu_torch.SolveInfo())
    assert (ndsm_tpu.IERR_SUCCESS, ndsm_tpu.IERR_COVFAIL, ndsm_tpu.IERR_BADMESH) == (
        ndsm_tpu_torch.IERR_SUCCESS, ndsm_tpu_torch.IERR_COVFAIL, ndsm_tpu_torch.IERR_BADMESH)


@pytest.mark.parametrize("kw", [
    {},
    {"ms": 3, "vc_tol": 1e-9, "ex_tol": 1e-12, "mean": True, "precision": "mixed"},
    {"ncycles_max": 7, "mixed_inner_max": 1, "coarse_solver": "relax", "output_dtype": "float32",
     "flux_correction_order": 1, "honor_ms_for_az": False, "reference_flux_quirk": True},
])
def test_options_from_reference_round_trip(kw):
    ref = ndsm_tpu.Options(**kw)
    port = convert.options_from_reference(dataclasses.asdict(ref))
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.du_max == ref.du_max


@pytest.mark.parametrize("n", GOLDEN_SIZES + ODD_SIZES)
def test_hierarchy_3d_bitwise(n):
    x, y, z = build_test_mesh(n)
    j, t = JGrid.from_mesh((z, y, x)), TGrid.from_mesh((z, y, x))
    _same_hierarchy(j, t)
    back = convert.hierarchy_from_reference(j.shapes, j.meshes, j.dq)
    _same_hierarchy(back, j)
    assert back == t


@pytest.mark.parametrize("shape", [(22, 22), (21, 35), (64, 48), (220, 220)])
def test_hierarchy_2d_and_float32_meshes(shape):
    meshes = [np.linspace(0.0, 1.3, n) for n in shape]
    _same_hierarchy(JGrid.from_mesh(meshes), TGrid.from_mesh(meshes))
    m32 = [m.astype(np.float32) for m in meshes]
    _same_hierarchy(JGrid.from_mesh(m32), TGrid.from_mesh(m32))


def test_mesh_uniformity_error_equal():
    rng = np.random.default_rng(0)
    cases = [np.linspace(0, 1, 17), np.linspace(0, 1, 17).astype(np.float32),
             np.cumsum(rng.uniform(0.5, 1.5, 12)), np.zeros(5), np.arange(9) * 0.1 + 1e6]
    for m in cases:
        assert j_uniform(m) == t_uniform(m)
    with pytest.raises(ValueError):
        TGrid.from_mesh((cases[2], cases[0]))


def test_hierarchy_from_reference_rejects_inconsistent():
    j = JGrid.from_mesh(build_test_mesh(22)[::-1])
    with pytest.raises(ValueError):
        convert.hierarchy_from_reference(j.shapes, j.meshes, j.dq[:-1])
    bad_dq = (tuple(2 * v for v in j.dq[0]),) + j.dq[1:]
    with pytest.raises(ValueError):
        convert.hierarchy_from_reference(j.shapes, j.meshes, bad_dq)


@pytest.mark.parametrize("n", (22, 37, 220))
def test_transfer_matrices_bitwise(n):
    h = TGrid.from_mesh(build_test_mesh(n)[::-1])
    for lvl in range(h.ngrids - 1):
        for qf, qc in zip(h.meshes[lvl], h.meshes[lvl + 1]):
            assert np.array_equal(jtransfer.interp_matrix_1d(qf, qc), ttransfer.interp_matrix_1d(qf, qc))
            assert np.array_equal(jtransfer.restrict_matrix_1d(qc, qf), ttransfer.restrict_matrix_1d(qc, qf))


def test_engine_matrices_equal_reference_builders():
    """The engine's float64 transfer and coarse tensors hold exactly the
    JAX builders' matrices."""
    x, y, z = build_test_mesh(22)
    h = TGrid.from_mesh((z, y, x))
    bcs = (("N", "N"), ("D", "D"), ("D", "N"))
    eng = MGEngine(h, bcs, ms=5, du_max=True, dtype=torch.float64, device="cpu", coarse_direct=True)
    for lvl in range(h.ngrids - 1):
        for ax in range(3):
            qf, qc = h.meshes[lvl][ax], h.meshes[lvl + 1][ax]
            assert np.array_equal(eng._interp_mats[lvl][ax].numpy(), jtransfer.interp_matrix_1d(qf, qc))
            assert np.array_equal(eng._restrict_mats[lvl][ax].numpy(), jtransfer.restrict_matrix_1d(qc, qf))
    S, mask = jcoarse.build_coarse_solver_matrix(h.shapes[-1], h.dq[-1], bcs)
    assert np.array_equal(eng._coarse_S.numpy(), S)
    assert np.array_equal(eng._coarse_rows.numpy(), np.flatnonzero(mask))


@pytest.mark.parametrize("shape,bcs", [
    ((5, 5, 5), (("D", "D"), ("D", "D"), ("N", "N"))),
    ((6, 5, 7), (("N", "N"), ("D", "D"), ("D", "D"))),
    ((5, 5), (("N", "N"), ("N", "N"))),
    ((4, 6), (("N", "D"), ("D", "N"))),
])
def test_coarse_matrix_bitwise(shape, bcs):
    dq = tuple(1.0 / (n - 1) for n in shape)
    Sj, mj = jcoarse.build_coarse_solver_matrix(shape, dq, bcs)
    St, mt = tcoarse.build_coarse_solver_matrix(shape, dq, bcs)
    assert np.array_equal(Sj, St) and np.array_equal(mj, mt)


def test_face_tables_equal():
    for name in ("FACE_COMP", "FACE_SIDE", "FACE_DIMS"):
        assert getattr(jfaces, name) == getattr(tfaces, name)
    for name in ("TVECS1", "TVECS2", "NVECS"):
        assert np.array_equal(getattr(jfaces, name), getattr(tfaces, name))
    shape = (7, 8, 9)
    for f in range(6):
        assert jfaces.at_signs(f) == tfaces.at_signs(f)
        assert jfaces.face_volume_index(f, shape) == tfaces.face_volume_index(f, shape)
        for comp in range(3):
            if comp != jfaces.FACE_COMP[f]:
                assert jfaces.face_at_component(f, comp) == tfaces.face_at_component(f, comp)


def test_warning_texts_equal():
    assert jpoisson._COVFAIL_WARNING == tpoisson._COVFAIL_WARNING
    assert jpoisson._COARSE_NOCONV_WARNING == tpoisson._COARSE_NOCONV_WARNING
