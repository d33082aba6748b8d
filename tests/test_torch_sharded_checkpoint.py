"""``ShardedPoissonBVP.solve_checkpointed`` of the port on CPU meshes of 2
and 2 x 2, against the oracles of tests/test_dist.py's
test_sharded_engine_checkpointed_resume and JAX's own sharded engine.

Tolerances:
  * every checkpoint interval, a resumed and an uninterrupted run, and the
    strict sibling's ``solve``: bitwise (mixed, as JAX's own test asserts);
  * fp64 against JAX's ``ShardedPoissonBVP.solve_checkpointed`` on a mesh
    of 2: 1e-12 relative, the same cycles (summation orders differ).
"""

import dataclasses

import numpy as np
import pytest
import torch

import ndsm_tpu
from ndsm_tpu.parallel.shard import make_mesh as j_make_mesh
from ndsm_tpu.parallel.sm_engine import ShardedPoissonBVP as JSharded
from ndsm_tpu.utils.msgs import suppress_warnings as j_suppress_warnings
from ndsm_tpu_torch import GridHierarchy, Options
from ndsm_tpu_torch.parallel.shard import make_mesh_nd
from ndsm_tpu_torch.parallel.sm_engine import ShardedPoissonBVP
from ndsm_tpu_torch.utils.msgs import suppress_warnings

torch.set_num_threads(1)

N = 16
BCS = (("D", "D"), ("N", "N"), ("D", "D"))
GRIDS = [(2,), (2, 2)]


def _problem():
    x = np.linspace(0, 1, N)
    rhs = np.random.default_rng(3).standard_normal((N, N, N))
    return x, rhs, np.zeros((N, N, N))


def _bvp(grid, opts):
    x, _, _ = _problem()
    names = ("z", "y")[: len(grid)]
    mesh = make_mesh_nd(grid, names, devices=["cpu"] * int(np.prod(grid)))
    return ShardedPoissonBVP(GridHierarchy.from_mesh((x, x, x)), BCS, opts, mesh=mesh,
                             axis_names=names, min_rows_per_shard=2)


@pytest.mark.parametrize("grid", GRIDS)
def test_intervals_bitwise_and_strict_solve(grid, tmp_path):
    _, rhs, u0 = _problem()
    sb = _bvp(grid, Options(precision="mixed", vc_tol=1e-8))
    assert sb.df_defect and sb._strict_sibling() is sb._strict_sibling() is not sb
    assert sb._strict_sibling().options.mixed_inner_max == 1
    outs = [sb.solve_checkpointed(u0, rhs, checkpoint_path=str(tmp_path / f"c{e}.npz"),
                                  checkpoint_every=e) for e in (1, 4, 32)]
    u_ref, i_ref = sb._strict_sibling().solve(u0, rhs)
    assert i_ref.ierr == 0
    for u, info in outs:
        assert info.ierr == 0 and info.cycles == i_ref.cycles
        assert torch.equal(u, u_ref)


@pytest.mark.parametrize("grid", GRIDS)
def test_resume_equals_uninterrupted(grid, tmp_path):
    _, rhs, u0 = _problem()
    opts = Options(precision="mixed", vc_tol=1e-8)
    ck = str(tmp_path / "sck.npz")
    with suppress_warnings():  # the capped run stops short: covfail is expected
        _, i_short = _bvp(grid, dataclasses.replace(opts, ncycles_max=3)).solve_checkpointed(
            u0, rhs, checkpoint_path=ck, checkpoint_every=1)
    assert i_short.cycles == 3 and i_short.ierr != 0
    sb = _bvp(grid, opts)
    u_res, i_res = sb.solve_checkpointed(u0, rhs, checkpoint_path=ck, checkpoint_every=2)
    u_full, i_full = sb.solve_checkpointed(u0, rhs, checkpoint_path=str(tmp_path / "sck2.npz"),
                                           checkpoint_every=4)
    assert i_res.ierr == i_full.ierr == 0 and i_res.cycles == i_full.cycles
    assert torch.equal(u_res, u_full)
    # a converged file: a second call runs no cycle and returns its u
    u_again, i_again = sb.solve_checkpointed(u0, rhs, checkpoint_path=ck, checkpoint_every=2)
    assert i_again.cycles == i_res.cycles and torch.equal(u_again, u_res)


def test_file_keys_other_shape_and_interval(tmp_path):
    _, rhs, u0 = _problem()
    sb = _bvp((2,), Options(precision="mixed", vc_tol=1e-8))
    ck = str(tmp_path / "ck.npz")
    np.savez(ck, u=np.ones((4, 4, 4)), cycles=7, du=0.0, shape=np.array([4, 4, 4]))
    u, info = sb.solve_checkpointed(u0, rhs, checkpoint_path=ck, checkpoint_every=4)
    u_ref, info_ref = sb._strict_sibling().solve(u0, rhs)
    assert info.cycles == info_ref.cycles and torch.equal(u, u_ref)  # the file was ignored
    with np.load(ck) as f:
        assert sorted(f.files) == ["cycles", "du", "shape", "u"]
        assert tuple(f["shape"]) == (N, N, N) and int(f["cycles"]) == info.cycles
        assert float(f["du"]) == info.du_last and np.array_equal(f["u"], u.numpy())
    assert not (tmp_path / "ck.npz.tmp.npz").exists()
    for bad in (0, -1):
        with pytest.raises(ValueError, match="checkpoint_every"):
            sb.solve_checkpointed(u0, rhs, checkpoint_path=ck, checkpoint_every=bad)


def test_fp64_against_jax(tmp_path):
    x, rhs, u0 = _problem()
    opts = dict(precision="fp64", vc_tol=1e-9)
    jsb = JSharded(ndsm_tpu.GridHierarchy.from_mesh((x, x, x)), BCS, ndsm_tpu.Options(**opts),
                   mesh=j_make_mesh(2), min_rows_per_shard=2)
    with j_suppress_warnings():
        u_j, i_j = jsb.solve_checkpointed(u0, rhs, checkpoint_path=str(tmp_path / "j.npz"),
                                          checkpoint_every=3)
    sb = _bvp((2,), Options(**opts))
    assert sb._strict_sibling() is sb
    u, info = sb.solve_checkpointed(u0, rhs, checkpoint_path=str(tmp_path / "p.npz"),
                                    checkpoint_every=3)
    u_j = np.asarray(u_j)
    assert info.ierr == i_j.ierr == 0 and info.cycles == i_j.cycles
    assert np.abs(u.numpy() - u_j).max() <= 1e-12 * np.abs(u_j).max()
    with np.load(tmp_path / "p.npz") as f, np.load(tmp_path / "j.npz") as g:
        assert sorted(f.files) == sorted(g.files)
        assert int(f["cycles"]) == int(g["cycles"])
