"""Injected operators on the port's sharded engine
(``PoissonBVP(shard_spec=..., operator=...)``: parallel/sm_engine.py's
``_OperatorBVP``, the operator's ``window`` of mg/operator.py) against
ndsm_tpu's GSPMD route on its 8 virtual CPU devices (tests/conftest.py),
and against the port's unsharded operator route, on the same numpy inputs.

Tolerances:
  * JAX's own two cases (tests/test_operator.py:307 and :615: Helmholtz
    and diffusion, 32^3, D/N/D, fp64, 8 shards, ``min_rows_per_shard=2``):
    u within 1e-11 of JAX's, equal cycles, as there; the same on a 4 x 2
    (z, y) mesh;
  * mixed precision: cycles within 1 of JAX's and u within 5e-10 (the
    vc_tol contract of tests/test_torch_operator.py's unsharded solves);
  * an all-Neumann diffusion (singular: the engine pins the global mean
    after every sweep and after every defect group): equal cycles, u
    within 1e-11 of JAX's and of the port's unsharded solve, mean within
    1e-15 of 0 (both sides with the direct coarse solve);
  * one sweep, and the residual, of each built-in operator on the blocks:
    bitwise the unsharded operator in float64, on a level whose blocks
    start at odd offsets (36 rows over 4 shards), on z and (z, y) meshes;
  * no wrapper of ``ops.KERNELS`` is called under ``HelmholtzOperator``
    (each is replaced by a counter; the same solve without an operator
    calls the Poisson ones; ``DiffusionOperator``'s own kernels are
    tests/test_torch_diffusion_kernel.py's);
  * ``solve_batch`` lane by lane, ``solve_checkpointed`` and
    ``solve_poisson_bvp(..., shard_spec=...)``: bitwise the spec route's
    own ``solve`` (the same engine);
  * an operator that does not declare ``supports_window`` raises.
"""

import numpy as np
import pytest
import torch

import ndsm_tpu
from ndsm_tpu.parallel.shard import ShardSpec as JShardSpec
from ndsm_tpu.parallel.shard import make_mesh as j_make_mesh
from ndsm_tpu.parallel.shard import make_mesh_nd as j_make_mesh_nd
from ndsm_tpu_torch import (
    DiffusionOperator,
    GridHierarchy,
    HelmholtzOperator,
    Options,
    PoissonBVP,
    PoissonOperator,
    ops,
    solve_poisson_bvp,
)
from ndsm_tpu_torch.mg.operator import MGOperator, Window
from ndsm_tpu_torch.ops import (compact, df, df_sharded, diffusion, fused, stencils, v2d, zc,
                                zc_sharded)
from ndsm_tpu_torch.parallel import collectives as C
from ndsm_tpu_torch.parallel.shard import ShardSpec, make_mesh, make_mesh_nd
from ndsm_tpu_torch.parallel.sm_engine import _OperatorBVP

torch.set_num_threads(1)

DND = (("D", "D"), ("N", "N"), ("D", "D"))
NNN = (("N", "N"),) * 3


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape)


def _coef_jax(*q):
    """tests/test_operator.py's ``_coef_smooth``."""
    import jax.numpy as jnp

    a = 1.0
    for i, qi in enumerate(q):
        a = a + 0.4 * jnp.sin((1.3 + 0.7 * i) * qi + 0.2 * i)
    return a


def _coef_torch(*q):
    a = 1.0
    for i, qi in enumerate(q):
        a = a + 0.4 * torch.sin((1.3 + 0.7 * i) * qi + 0.2 * i)
    return a


def _poly_coef(*q):
    a = 1.0
    for i, qi in enumerate(q):
        a = a + (0.3 + 0.2 * i) * qi * qi
    return a


def _ops(kind):
    if kind == "helmholtz":
        return ndsm_tpu.HelmholtzOperator(2.2), HelmholtzOperator(2.2)
    return ndsm_tpu.DiffusionOperator(_coef_jax), DiffusionOperator(_coef_torch)


def _specs(zy, k=8):
    """(JAX spec, port spec): 8 shards on z, or a 4 x 2 (z, y) mesh."""
    if zy:
        return (JShardSpec(mesh=j_make_mesh_nd((4, 2), ("z", "y")), min_rows_per_shard=2,
                           extra_axes=((1, "y"),)),
                ShardSpec(mesh=make_mesh_nd((4, 2), ("z", "y"), devices=["cpu"] * 8),
                          min_rows_per_shard=2, extra_axes=((1, "y"),)))
    return (JShardSpec(mesh=j_make_mesh(k), min_rows_per_shard=2),
            ShardSpec(mesh=make_mesh(k, devices=["cpu"] * k), min_rows_per_shard=2))


def _solve_both(kind, opts, zy, bcs=DND, n=32, seed=12, mean_free=False):
    x = np.linspace(0.0, 1.0, n)
    rhs = _rand((n, n, n), seed)
    if mean_free:
        rhs -= rhs.mean()
    opj, opt = _ops(kind)
    jspec, spec = _specs(zy)
    uj, ij = ndsm_tpu.PoissonBVP(ndsm_tpu.GridHierarchy.from_mesh((x, x, x)), bcs,
                                 ndsm_tpu.Options(**opts), shard_spec=jspec,
                                 operator=opj).solve(np.zeros_like(rhs), rhs)
    bvp = PoissonBVP(GridHierarchy.from_mesh((x, x, x)), bcs, Options(**opts), device="cpu",
                     operator=opt, shard_spec=spec)
    assert isinstance(bvp._sharded, _OperatorBVP) and bvp._sharded.seam >= 2
    ut, it = bvp.solve(np.zeros_like(rhs), rhs)
    return np.asarray(uj), ij, ut, it, rhs


@pytest.mark.parametrize("kind", ["helmholtz", "diffusion"])
def test_jax_gspmd_operator_cases(kind):
    """tests/test_operator.py:307 (Helmholtz) and :615 (diffusion)."""
    uj, ij, ut, it, _ = _solve_both(kind, dict(precision="fp64", vc_tol=1e-10), zy=False)
    assert ij.ierr == it.ierr == 0 and it.cycles == ij.cycles
    np.testing.assert_allclose(ut.numpy(), uj, rtol=0, atol=1e-11)


@pytest.mark.parametrize("kind,precision,zy", [("helmholtz", "fp64", True),
                                               ("diffusion", "mixed", False)],
                         ids=["helmholtz-fp64-zy", "diffusion-mixed-z"])
def test_mixed_and_zy_cases(kind, precision, zy):
    uj, ij, ut, it, _ = _solve_both(kind, dict(precision=precision, vc_tol=1e-10), zy=zy,
                                    seed=13)
    assert ij.ierr == it.ierr == 0
    err = float(np.abs(ut.numpy() - uj).max())
    if precision == "fp64":
        assert it.cycles == ij.cycles and err <= 1e-11, (it.cycles, ij.cycles, err)
    else:
        assert abs(it.cycles - ij.cycles) <= 1 and err <= 5e-10, (it.cycles, ij.cycles, err)


def test_all_neumann_diffusion_pins_the_global_mean():
    """A singular operator: the blocks' relax pins no mean of its own; the
    engine pins the level's mean after each sweep and the outer iterate's
    after each defect group."""
    opts = dict(precision="fp64", vc_tol=1e-10, coarse_solver="direct")
    n = 32
    uj, ij, ut, it, rhs = _solve_both("diffusion", opts, zy=False, bcs=NNN, n=n, seed=21,
                                      mean_free=True)
    x = np.linspace(0.0, 1.0, n)
    uu, iu = PoissonBVP(GridHierarchy.from_mesh((x, x, x)), NNN, Options(**opts), device="cpu",
                        operator=DiffusionOperator(_coef_torch)).solve(np.zeros_like(rhs), rhs)
    assert ij.ierr == it.ierr == iu.ierr == 0 and it.cycles == ij.cycles == iu.cycles
    np.testing.assert_allclose(ut.numpy(), uj, rtol=0, atol=1e-11)
    np.testing.assert_allclose(ut.numpy(), uu.numpy(), rtol=0, atol=1e-11)
    assert abs(float(ut.mean())) <= 1e-15


@pytest.mark.parametrize("zy", [False, True], ids=["z4", "zy4x2"])
@pytest.mark.parametrize("bcs", [DND, (("N", "D"), ("D", "N"), ("N", "N"))], ids=["DND", "mixed"])
def test_one_sweep_on_blocks_bitwise(bcs, zy):
    """36 rows over 4 shards: blocks at z = 0, 9, 18, 27 (odd offsets flip
    the local colours unless the window carries them)."""
    shape = (36, 20, 11)
    h = GridHierarchy.from_mesh(tuple(np.linspace(0.0, 1.0, k) for k in shape))
    mesh = make_mesh_nd((4, 2), ("z", "y"), devices=["cpu"] * 8) if zy else \
        make_mesh(4, devices=["cpu"] * 4)
    rng = np.random.default_rng(1)
    u = torch.as_tensor(rng.standard_normal(shape))
    r = torch.as_tensor(rng.standard_normal(shape))
    dq = h.dq[0]
    for op in (PoissonOperator(), HelmholtzOperator(1.3), DiffusionOperator(_poly_coef)):
        sb = _OperatorBVP(h, bcs, Options(precision="fp64"), operator=op, mesh=mesh,
                          axis_names=("z", "y") if zy else ("z",), min_rows_per_shard=2)
        assert sb._local(0)[0] == 9 and any(sb._offsets(0, p)[0] % 2 for p in sb.local)
        ub, rb = C.shard(u, sb.sub, 0, sb.grid), C.shard(r, sb.sub, 0, sb.grid)
        with op.held():
            swept = C.unshard(sb._sh_smooth(ub, rb, 0, 2), sb.sub, 0, sb.grid)
            res = C.unshard(sb._sh_residual(ub, rb, 0), sb.sub, 0, sb.grid)
        assert torch.equal(swept, op.relax(op.relax(u, r, dq, bcs), r, dq, bcs)), op
        assert torch.equal(res, op.residual(u, r, dq, bcs)), op
    # the window's colours are the global ones: an odd offset flips them
    red, _ = stencils.color_masks((4, 3, 3), DND, "cpu")
    red_odd, black_odd = stencils.color_masks((4, 3, 3), DND, "cpu", (9, 0, 0))
    assert torch.equal(red, black_odd) and not torch.equal(red, red_odd)


def _count_kernel_calls(monkeypatch):
    """Every ``ops.KERNELS`` wrapper, wherever a module names it, replaced
    by a counter that calls it."""
    calls = {}
    wrappers = {}
    for k in ops.KERNELS:  # (zc_smooth_3d and fused_smooth_3d are one wrapper)
        wrappers.setdefault(id(k[1]), k[0])
    for mod in (compact, df, df_sharded, diffusion, fused, v2d, zc, zc_sharded):
        for attr, fn in list(vars(mod).items()):
            if callable(fn) and id(fn) in wrappers:
                name = wrappers[id(fn)]
                calls.setdefault(name, 0)

                def counted(*a, _fn=fn, _name=name, **k):
                    calls[_name] += 1
                    return _fn(*a, **k)

                monkeypatch.setattr(mod, attr, counted)
    return calls


@pytest.mark.parametrize("zy", [False, True], ids=["z4", "zy2x2"])
def test_no_kernel_under_an_operator(monkeypatch, zy):
    calls = _count_kernel_calls(monkeypatch)
    assert set(calls) == {k[0] for k in ops.KERNELS} - {"fused_smooth_3d"}
    n = 16
    x = np.linspace(0.0, 1.0, n)
    h = GridHierarchy.from_mesh((x, x, x))
    rhs = _rand((n, n, n), 3)
    mesh = make_mesh_nd((2, 2), ("z", "y"), devices=["cpu"] * 4) if zy else \
        make_mesh(4, devices=["cpu"] * 4)
    spec = ShardSpec(mesh, min_rows_per_shard=2, extra_axes=((1, "y"),) if zy else ())
    opts = Options(precision="mixed", vc_tol=1e-9)
    plain = PoissonBVP(h, DND, opts, device="cpu", shard_spec=spec)
    assert plain.df_defect
    plain.solve(np.zeros_like(rhs), rhs)
    assert sum(calls.values()) > 0  # the test has teeth
    calls.update({k: 0 for k in calls})
    bvp = PoissonBVP(h, DND, opts, device="cpu", shard_spec=spec,
                     operator=HelmholtzOperator(1.5))
    assert not bvp.df_defect and bvp._sharded._rep.kernel_route is None
    u, info = bvp.solve(np.zeros_like(rhs), rhs)
    assert info.ierr == 0 and not any(calls.values()), calls


def test_operator_entry_points_under_a_spec(tmp_path):
    """solve_batch lane by lane, solve_checkpointed, history and zero_rhs,
    and solve_poisson_bvp(..., shard_spec=...), on one engine."""
    n = 16
    x = np.linspace(0.0, 1.0, n)
    h = GridHierarchy.from_mesh((x, x, x))
    op = DiffusionOperator(_poly_coef)
    spec = ShardSpec(make_mesh(4, devices=["cpu"] * 4), min_rows_per_shard=2)
    opts = Options(precision="mixed", vc_tol=1e-9)
    bvp = PoissonBVP(h, DND, opts, device="cpu", operator=op, shard_spec=spec)
    rhss = [_rand((n, n, n), 40), _rand((n, n, n), 41)]
    zeros = np.zeros((n, n, n))
    ones = [bvp.solve(zeros, r) for r in rhss]
    us, infos = bvp.solve_batch([zeros] * 2, rhss, names=["a", "b"])
    assert [i.name for i in infos] == ["a", "b"]
    for u, (v, i), j in zip(us, ones, infos):
        assert torch.equal(u, v) and i.cycles == j.cycles
    uh, ih = bvp.solve(zeros, rhss[0], history=True)
    assert torch.equal(uh, ones[0][0]) and len(ih.du_history) == ih.cycles
    uz, iz = bvp.solve(zeros, rhss[0], zero_rhs=True)
    assert iz.ierr == 0 and float(uz.abs().max()) == 0.0
    uf, i_f = solve_poisson_bvp(zeros, rhss[0], (x, x, x), DND, options=opts, operator=op,
                                device="cpu", shard_spec=spec)
    assert torch.equal(uf, ones[0][0]) and i_f.cycles == ones[0][1].cycles
    strict = PoissonBVP(h, DND, Options(precision="mixed", vc_tol=1e-9, mixed_inner_max=1),
                        device="cpu", operator=op, shard_spec=spec)
    us_, is_ = strict.solve(zeros, rhss[0])
    uc, ic = bvp.solve_checkpointed(zeros, rhss[0], checkpoint_path=str(tmp_path / "ck.npz"),
                                    checkpoint_every=2)
    assert torch.equal(uc, us_) and ic.cycles == is_.cycles
    assert bvp._sharded._strict_sibling().operator is op
    assert len(op._terms) == 0  # held() dropped the face terms after each solve


def test_windowed_face_terms_are_keyed_by_window():
    """Two blocks of one shape at different offsets have different face
    coefficients (the held cache keys on the window).  ``_level_terms`` is
    (coefficient, (halves, den)) on the CPU route."""
    op = DiffusionOperator(_poly_coef)
    u = torch.zeros((4, 5, 5), dtype=torch.float64)
    w = (1.0, 1.0, 1.0)
    with op.held():
        ca, (_, a) = op._level_terms(u, w, Window((16, 5, 5), (0, 0, 0)))
        cb, (_, b) = op._level_terms(u, w, Window((16, 5, 5), (8, 0, 0)))
        cw, (_, whole) = op._level_terms(torch.zeros((16, 5, 5), dtype=torch.float64), w)
        assert len(op._terms) == 3
    assert not torch.equal(a, b)
    # interior planes of each block are the whole level's planes
    assert torch.equal(a[1:-1], whole[1:3]) and torch.equal(b[1:-1], whole[9:11])
    # the coefficient is the global nodes': every plane of a block
    assert torch.equal(ca, cw[0:4]) and torch.equal(cb, cw[8:12])


def test_operator_without_a_window_raises():
    @__import__("dataclasses").dataclass(frozen=True)
    class Local(MGOperator):
        def relax(self, u, rhs, dq, bcs):
            return stencils.rb_sweep(u, rhs, dq, bcs)

        def residual(self, u, rhs, dq, bcs):
            return stencils.poisson_residual(u, rhs, dq, bcs)

    x = np.linspace(0.0, 1.0, 16)
    h = GridHierarchy.from_mesh((x, x, x))
    spec = ShardSpec(make_mesh(4, devices=["cpu"] * 4), min_rows_per_shard=2)
    with pytest.raises(NotImplementedError, match="supports_window"):
        PoissonBVP(h, DND, Options(precision="fp64"), device="cpu", operator=Local(),
                   shard_spec=spec)
    # without a spec it runs on one device, as before
    u, info = PoissonBVP(h, DND, Options(precision="fp64"), device="cpu",
                         operator=Local()).solve(np.zeros((16,) * 3), _rand((16,) * 3, 2))
    assert info.ierr == 0
