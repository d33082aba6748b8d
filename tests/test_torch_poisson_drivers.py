"""The port's PoissonBVP drivers beyond ``solve`` (mg/poisson.py,
mg/engine.py): ``solve(history=True)``, ``solve_checkpointed``, the
reduced drivers ``vcycle``/``two_grid``/``one_grid`` and
``solve_poisson_bvp``, each against ndsm_tpu on the CPU (the oracles of
tests/test_mg.py).

Tolerances: fp64 within 1e-12 of JAX with equal cycle counts (the
transfers and means sum in another order); the port against itself
bitwise wherever the contract says the iterates do not change (history
on or off, any checkpoint interval); ``solve_checkpointed`` within 5e-11
of ``solve`` (tests/test_mg.py:185).
"""

import os

import numpy as np
import pytest
import torch

import ndsm_tpu
import ndsm_tpu_torch
from ndsm_tpu_torch import GridHierarchy, Options, PoissonBVP, solve_poisson_bvp

torch.set_num_threads(1)


def _poly_neumann_2d(nx, ny, Lx=1.0, Ly=1.3, a1=0.75, b1=-0.35):
    """The pure-Neumann polynomial case of unit_test_2D_solve.f90 (as
    tests/test_mg.py builds it)."""
    x = np.linspace(0, Lx, nx)
    y = np.linspace(0, Ly, ny)
    X, Y = np.meshgrid(x, y, indexing="xy")
    rhs = a1 * (2 * X - Lx) + b1 * (2 * Y - Ly)
    u = a1 * (X**3 / 3 - Lx * X**2 / 2) + b1 * (Y**3 / 3 - Ly * Y**2 / 2)
    return (y, x), rhs, u - u.mean()


def _pair(meshes, bcs, ngrids=None, **opts):
    hj = ndsm_tpu.GridHierarchy.from_mesh(meshes, ngrids=ngrids)
    ht = GridHierarchy.from_mesh(meshes, ngrids=ngrids)
    return (ndsm_tpu.PoissonBVP(hj, bcs, ndsm_tpu.Options(**opts)),
            PoissonBVP(ht, bcs, Options(**opts), device="cpu"))


NEUMANN_2D = (("N", "N"), ("N", "N"))
AX = (("D", "D"), ("D", "D"), ("N", "N"))


def _ax_case(n):
    x = np.linspace(0.0, 1.0, n)
    ue = (np.sin(np.pi * x)[:, None, None] * np.sin(np.pi * x)[None, :, None]
          * np.cos(np.pi * x)[None, None, :])
    return x, -3.0 * np.pi**2 * ue


def test_du_history_fp64_matches_jax():
    """history=True records du per V-cycle without changing the iterates
    (tests/test_mg.py:124), entry by entry within 1e-12 of JAX's."""
    meshes, rhs, _ = _poly_neumann_2d(27, 36)
    bj, bt = _pair(meshes, NEUMANN_2D, precision="fp64")
    u_h, i_h = bt.solve(np.zeros_like(rhs), rhs, history=True)
    u_p, i_p = bt.solve(np.zeros_like(rhs), rhs)
    _, i_j = bj.solve(np.zeros_like(rhs), rhs, history=True)
    assert i_h.ierr == 0 and i_p.du_history is None
    assert torch.equal(u_h, u_p)
    assert len(i_h.du_history) == i_h.cycles == i_p.cycles == i_j.cycles
    assert i_h.du_history[-1] == i_h.du_last == i_p.du_last
    assert i_h.du_history[0] > i_h.du_history[-1]
    assert np.abs(np.array(i_h.du_history) - np.array(i_j.du_history)).max() < 1e-12


@pytest.mark.parametrize("case", ["mixed_3d_df", "mixed_2d_neumann", "fp32_3d"])
def test_du_history_iterates_unchanged(case):
    """Mixed defect groups write one entry per inner V-cycle (the f64 du_e
    on the df path, du_of(du_new) on the scaled-defect path); the
    iterates are bit for bit those of history=False."""
    if case == "mixed_2d_neumann":
        meshes, rhs, _ = _poly_neumann_2d(27, 36)
        bcs, precision = NEUMANN_2D, "mixed"
    else:
        x, rhs = _ax_case(17)
        meshes, bcs = (x, x, x), AX
        precision = "mixed" if case == "mixed_3d_df" else "fp32"
    vc_tol = 2e-6 if precision == "fp32" else 1e-10
    bvp = PoissonBVP(GridHierarchy.from_mesh(meshes), bcs,
                     Options(precision=precision, mixed_inner_max=3, vc_tol=vc_tol),
                     device="cpu")
    assert bvp.df_defect == (case == "mixed_3d_df")
    u_h, i_h = bvp.solve(np.zeros_like(rhs), rhs, history=True)
    u_p, i_p = bvp.solve(np.zeros_like(rhs), rhs)
    assert i_h.ierr == 0 and torch.equal(u_h, u_p)
    assert len(i_h.du_history) == i_h.cycles == i_p.cycles
    assert i_h.du_history[-1] == i_h.du_last == i_p.du_last
    assert all(np.isfinite(i_h.du_history))


def test_one_grid_two_grid():
    """The reduced drivers solve a small problem (tests/test_mg.py:149),
    each within 1e-12 of JAX's."""
    n = 17
    x = np.linspace(0, 1, n)
    X, Y = np.meshgrid(x, x, indexing="xy")
    U = np.sin(np.pi * X) * np.sin(np.pi * Y)
    rhs = -2 * np.pi**2 * U
    bj, bt = _pair((x, x), (("D", "D"), ("D", "D")), precision="fp64")
    for name in ("one_grid", "two_grid", "vcycle"):
        got = getattr(bt, name)(np.zeros_like(U), rhs, ex_tol=1e-12)
        want = np.asarray(getattr(bj, name)(np.zeros_like(U), rhs, ex_tol=1e-12))
        assert got.dtype == torch.float64 and got.device.type == "cpu"
        assert np.abs(got.numpy() - want).max() < 1e-12, name
        if name != "vcycle":
            assert np.abs(got.numpy() - U).max() < 5e-2


def test_two_grid_sequencing_differential():
    """two_grid against the reference sequencing on the native sweeps
    (tests/test_mg.py:227: ms pre-smooth, residual, restrict, solve_exact
    on level 1 with niterex_max = 4, ms coarse sweeps, interpolate + add,
    ms post-smooth) and against JAX's two_grid within 1e-12; one_grid
    against relax-to-ex_tol from u0."""
    from ndsm_tpu.native.solver import _apply_axis_mats, _residual, _sweep
    from ndsm_tpu.ops.transfer import interp_matrix_1d, restrict_matrix_1d

    meshes, rhs, _ = _poly_neumann_2d(27, 36)
    opts = dict(precision="fp64", ms=5, ex_tol=1e-12, niterex_max=4)
    bj, bt = _pair(meshes, NEUMANN_2D, ngrids=2, **opts)
    h = bj.h
    u0 = np.random.default_rng(7).standard_normal(rhs.shape)
    dq = [np.asarray(d, dtype=np.float64) for d in h.dq]
    R = [restrict_matrix_1d(c, f) for f, c in zip(h.meshes[0], h.meshes[1])]
    P = [interp_matrix_1d(f, c) for f, c in zip(h.meshes[0], h.meshes[1])]

    def solve_exact_np(u, rhs_l, level, nmax):
        u_sav, du, it = np.zeros_like(u), np.inf, 0
        while du > opts["ex_tol"] and it < nmax:
            u = _sweep(u, rhs_l, dq[level], NEUMANN_2D)
            du = np.abs(u - u_sav).max()
            u_sav, it = u.copy(), it + 1
        return u

    u = u0.copy()
    for _ in range(opts["ms"]):
        u = _sweep(u, rhs, dq[0], NEUMANN_2D)
    rhs_c = _apply_axis_mats(_residual(u, rhs, dq[0], NEUMANN_2D), R)
    u_c = solve_exact_np(np.zeros_like(rhs_c), rhs_c, 1, opts["niterex_max"])
    for _ in range(opts["ms"]):
        u_c = _sweep(u_c, rhs_c, dq[1], NEUMANN_2D)
    u = u + _apply_axis_mats(u_c, P)
    for _ in range(opts["ms"]):
        u = _sweep(u, rhs, dq[0], NEUMANN_2D)

    got = bt.two_grid(u0, rhs, ex_tol=opts["ex_tol"], niterex_max=opts["niterex_max"]).numpy()
    want_j = np.asarray(bj.two_grid(u0, rhs, ex_tol=opts["ex_tol"],
                                    niterex_max=opts["niterex_max"]))
    assert np.abs(got - u).max() < 1e-10
    assert np.abs(got - want_j).max() < 1e-12

    got1 = bt.one_grid(u0, rhs, ex_tol=opts["ex_tol"], niterex_max=10000).numpy()
    want1 = solve_exact_np(u0.copy(), rhs, 0, 10000)
    assert np.abs(got1 - want1).max() < 1e-10


def test_4d_all_neumann_solve_matches_jax():
    """N-D beyond 3D (tests/test_mg.py:165): a 4D all-Neumann fp64 solve,
    cycles equal to JAX's and u within 1e-12."""
    n = 12
    x = np.linspace(0, 1, n)
    grids = np.meshgrid(*([x] * 4), indexing="ij")
    U = np.ones_like(grids[0])
    for g in grids:
        U = U * np.cos(np.pi * g)
    rhs = -4 * np.pi**2 * U
    bcs = (("N", "N"),) * 4
    uj, ij = ndsm_tpu.solve_poisson_bvp(np.zeros_like(U), rhs, (x,) * 4, bcs,
                                        options=ndsm_tpu.Options(precision="fp64"))
    ut, it = solve_poisson_bvp(np.zeros_like(U), rhs, (x,) * 4, bcs,
                               options=Options(precision="fp64"), device="cpu")
    assert ij.ierr == it.ierr == 0 and ij.cycles == it.cycles
    assert np.abs(ut.numpy() - np.asarray(uj)).max() < 1e-12
    u = ut.numpy() - ut.numpy().mean()
    assert np.abs(u - (U - U.mean())).max() < 0.1


def test_solve_checkpointed_fp64(tmp_path):
    """Chunks of 1, 4 and 32 V-cycles give the same iterates bit for bit,
    within 5e-11 of solve and within 1e-12 of JAX's solve_checkpointed;
    a second call resumes from the file and runs no cycle
    (tests/test_mg.py:185)."""
    meshes, rhs, _ = _poly_neumann_2d(27, 36)
    bj, bt = _pair(meshes, NEUMANN_2D, precision="fp64")
    u_ref, i_ref = bt.solve(np.zeros_like(rhs), rhs)
    outs = {}
    for every in (1, 4, 32):
        ck = str(tmp_path / f"state{every}.npz")
        outs[every] = bt.solve_checkpointed(np.zeros_like(rhs), rhs, checkpoint_path=ck,
                                            checkpoint_every=every)
        assert outs[every][1].ierr == 0 and outs[every][1].cycles == i_ref.cycles
        assert torch.equal(outs[every][0], outs[1][0])
    u_ck, i_ck = outs[4]
    assert np.abs(u_ck.numpy() - u_ref.numpy()).max() < 5e-11
    uj, ij = bj.solve_checkpointed(np.zeros_like(rhs), rhs,
                                   checkpoint_path=str(tmp_path / "jax.npz"),
                                   checkpoint_every=4)
    assert ij.cycles == i_ck.cycles
    assert np.abs(u_ck.numpy() - np.asarray(uj)).max() < 1e-12
    u2, i2 = bt.solve_checkpointed(np.zeros_like(rhs), rhs,
                                   checkpoint_path=str(tmp_path / "state4.npz"),
                                   checkpoint_every=4)
    assert i2.cycles == i_ck.cycles and torch.equal(u2, u_ck)


def test_solve_checkpointed_mixed_3d_is_strict_solve(tmp_path):
    """Mixed 3D (the df defect path): every interval gives the iterates of
    solve on a BVP with mixed_inner_max=1, bit for bit (a chunk applies
    its last correction after its loop, the next chunk's first defect
    starts from there: the same float64 sum as inside one loop)."""
    x, rhs = _ax_case(17)
    h = GridHierarchy.from_mesh((x, x, x))
    bvp = PoissonBVP(h, AX, Options(precision="mixed"), device="cpu")
    strict = PoissonBVP(h, AX, Options(precision="mixed", mixed_inner_max=1), device="cpu")
    assert bvp.df_defect
    u_s, i_s = strict.solve(np.zeros_like(rhs), rhs)
    for every in (1, 3, 32):
        u, info = bvp.solve_checkpointed(np.zeros_like(rhs), rhs, checkpoint_every=every,
                                         checkpoint_path=str(tmp_path / f"m{every}.npz"))
        assert info.ierr == 0 and info.cycles == i_s.cycles and info.du_last == i_s.du_last
        assert torch.equal(u, u_s)


def test_checkpoint_file(tmp_path):
    """The file holds u, cycles, du and shape; no temporary file is left;
    a file of another shape is not resumed from; checkpoint_every < 1
    raises."""
    meshes, rhs, _ = _poly_neumann_2d(27, 36)
    bvp = PoissonBVP(GridHierarchy.from_mesh(meshes), NEUMANN_2D, Options(precision="fp64"),
                     device="cpu")
    ck = str(tmp_path / "state.npz")
    np.savez(ck, u=np.ones((3, 3)), cycles=99, du=0.0, shape=np.asarray((3, 3)))
    u, info = bvp.solve_checkpointed(np.zeros_like(rhs), rhs, checkpoint_path=ck,
                                     checkpoint_every=5)
    assert info.ierr == 0 and 0 < info.cycles < 99
    assert sorted(os.listdir(tmp_path)) == ["state.npz"]
    with np.load(ck) as f:
        assert sorted(f.files) == ["cycles", "du", "shape", "u"]
        assert int(f["cycles"]) == info.cycles and float(f["du"]) == info.du_last
        assert tuple(f["shape"]) == rhs.shape and np.array_equal(f["u"], u.numpy())
    with pytest.raises(ValueError):
        bvp.solve_checkpointed(np.zeros_like(rhs), rhs, checkpoint_path=ck,
                               checkpoint_every=0)


def test_solve_poisson_bvp_runs_on_cuda_by_default():
    """Like every entry point of the port, solve_poisson_bvp runs on the
    card unless told device="cpu"; without a card it raises."""
    x = np.linspace(0, 1, 9)
    rhs = np.zeros((9, 9))
    if torch.cuda.is_available():
        u, _ = solve_poisson_bvp(np.zeros_like(rhs), rhs, (x, x), NEUMANN_2D)
        assert u.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            solve_poisson_bvp(np.zeros_like(rhs), rhs, (x, x), NEUMANN_2D)
    u, info = ndsm_tpu_torch.solve_poisson_bvp(np.zeros_like(rhs), rhs, (x, x), NEUMANN_2D,
                                               device="cpu")
    assert u.device.type == "cpu" and info.ierr == 0
