"""The port's injected operators (mg/operator.py), the generic coarse
assembly (mg/coarse.py) and the operator route of the engine and
PoissonBVP, against ndsm_tpu on the CPU, on identical numpy inputs.

Tolerances:
  * relax and residual: float64 within 1e-13 * max|x| of JAX (and of the
    loop oracles of tests/test_operator.py); float32 within 2 ulp of
    max|x| for the one sweep (XLA:CPU may contract a multiply-add to an
    FMA; PyTorch runs every op on its own);
  * ``HelmholtzOperator(0)`` bitwise the port's ``rb_sweep`` /
    ``poisson_residual``; an injected ``PoissonOperator()`` bitwise the
    default fp64 engine (same cycles, same u);
  * the generic coarse assembly within 1e-10 (relative) of the hand
    assembly with ``diag_shift`` and of JAX's generic assembly;
  * solves: fp64 equal cycles and u within 1e-12 of JAX; mixed cycles
    within +-1 and u within 5e-10 (the vc_tol contract);
  * dense oracles and h^2 scaling as tests/test_operator.py states them.

The two GSPMD tests of tests/test_operator.py (the sharded Helmholtz and
Diffusion solves through ``PoissonBVP(shard_spec=...)``) are held in
tests/test_torch_sharded_operator.py: the port routes a ``shard_spec`` with
an operator to its sharded engine, which runs the operator on each block
in its window (mg/operator.py, "Windows").
"""

import dataclasses
import itertools
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import ndsm_tpu
import ndsm_tpu_torch
from ndsm_tpu.mg.coarse import build_coarse_matrix_from_operator as jax_generic
from ndsm_tpu_torch import (
    DiffusionOperator,
    GridHierarchy,
    HelmholtzOperator,
    Options,
    PoissonBVP,
    PoissonOperator,
    solve_poisson_bvp,
)
from ndsm_tpu_torch.mg import coarse
from ndsm_tpu_torch.ops import df, stencils, v2d, zc

from oracle import _reflect

torch.set_num_threads(1)

DTYPES = {"f64": (np.float64, torch.float64), "f32": (np.float32, torch.float32)}


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape)


def _close(got, want, dtype):
    """f64: within 1e-13 * max|want|; f32: within 2 ulp of max|want|."""
    scale = float(np.abs(want).max())
    tol = 1e-13 * scale if dtype == np.float64 else 2 * float(np.spacing(np.float32(scale)))
    err = float(np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)).max())
    assert err <= tol, (err, tol)


def _poly_coef(*q):
    """Positive, varying, and the same arithmetic on jnp arrays and tensors."""
    a = 1.0
    for i, qi in enumerate(q):
        a = a + (0.3 + 0.2 * i) * qi * qi
    return a


def _sin_coef_torch(*q):
    a = 1.0
    for i, qi in enumerate(q):
        a = a + 0.4 * torch.sin((1.3 + 0.7 * i) * qi + 0.2 * i)
    return a


def _sin_coef_nodes(shape):
    coords = np.meshgrid(*[np.linspace(0.0, 1.0, n) for n in shape], indexing="ij")
    a = 1.0
    for i, qi in enumerate(coords):
        a = a + 0.4 * np.sin((1.3 + 0.7 * i) * qi + 0.2 * i)
    return a


def _at_dirichlet(idx, shape, bcs):
    return any((idx[ax] == 0 and bcs[ax][0] == "D")
               or (idx[ax] == shape[ax] - 1 and bcs[ax][1] == "D")
               for ax in range(len(shape)))


def _diffusion_relax_oracle(u, rhs, dq, bcs, a):
    """Loop-level red-black flux-form relax for div(a grad u) = rhs."""
    u = u.copy()
    shape = u.shape
    w = [1.0 / (d * d) for d in dq]
    red = stencils.first_color_parity(tuple(tuple(b) for b in bcs))
    for parity in (red, 1 - red):
        for idx in itertools.product(*[range(n) for n in shape]):
            if sum(idx) % 2 != parity or _at_dirichlet(idx, shape, bcs):
                continue
            num = den = 0.0
            for ax in range(u.ndim):
                lo, hi = list(idx), list(idx)
                lo[ax] = _reflect(idx[ax] - 1, shape[ax])
                hi[ax] = _reflect(idx[ax] + 1, shape[ax])
                alo = 0.5 * (a[idx] + a[tuple(lo)])
                ahi = 0.5 * (a[idx] + a[tuple(hi)])
                num += (alo * u[tuple(lo)] + ahi * u[tuple(hi)]) * w[ax]
                den += (alo + ahi) * w[ax]
            u[idx] = (num - rhs[idx]) / den
    return u


def _shifted_relax_oracle(u, rhs, dq, bcs, c):
    """Loop-level red-black relax for lap(u) - c u = rhs."""
    u = u.copy()
    shape = u.shape
    w = [1.0 / (d * d) for d in dq]
    w0 = 1.0 / (2.0 * sum(w) + c)
    red = stencils.first_color_parity(tuple(tuple(b) for b in bcs))
    for parity in (red, 1 - red):
        for idx in itertools.product(*[range(n) for n in shape]):
            if sum(idx) % 2 != parity or _at_dirichlet(idx, shape, bcs):
                continue
            s = 0.0
            for ax in range(u.ndim):
                lo, hi = list(idx), list(idx)
                lo[ax] = _reflect(idx[ax] - 1, shape[ax])
                hi[ax] = _reflect(idx[ax] + 1, shape[ax])
                s += (u[tuple(lo)] + u[tuple(hi)]) * w[ax]
            u[idx] = (s - rhs[idx]) * w0
    return u


# ----------------------------------------------------------------------
# Operator level: relax and residual
# ----------------------------------------------------------------------

HELMHOLTZ_CASES = [
    ((6, 5, 7), (("D", "N"), ("N", "N"), ("D", "D"))),
    ((6, 5, 7), (("N", "N"), ("N", "D"), ("N", "N"))),
    ((9, 8), (("D", "D"), ("N", "D"))),
]


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("shape,bcs", HELMHOLTZ_CASES)
def test_helmholtz_relax_residual_match_jax(shape, bcs, dt):
    npdt, tdt = DTYPES[dt]
    c = 2.75
    dq = np.array([0.11, 0.09, 0.13][: len(shape)])
    u, rhs = _rand(shape, 0).astype(npdt), _rand(shape, 1).astype(npdt)
    opj, opt = ndsm_tpu.HelmholtzOperator(c), HelmholtzOperator(c)
    ut, rt = torch.from_numpy(u), torch.from_numpy(rhs)
    got = opt.relax(ut, rt, dq, bcs)
    assert got.dtype == tdt and torch.equal(ut, torch.from_numpy(u))  # inputs untouched
    _close(got.numpy(), np.asarray(opj.relax(u, rhs, dq, bcs)), npdt)
    _close(opt.residual(ut, rt, dq, bcs).numpy(), np.asarray(opj.residual(u, rhs, dq, bcs)),
           npdt)
    if dt == "f64":
        _close(got.numpy(), _shifted_relax_oracle(u, rhs, dq, bcs, c), npdt)


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("shape,bcs", [
    ((6, 5, 7), (("D", "N"), ("N", "N"), ("D", "D"))),
    ((9, 8), (("N", "N"), ("N", "D"))),
])
def test_diffusion_relax_residual_match_jax(shape, bcs, dt):
    npdt, _ = DTYPES[dt]
    dq = np.array([0.11, 0.09, 0.13][: len(shape)])
    u, rhs = _rand(shape, 40).astype(npdt), _rand(shape, 41).astype(npdt)
    opj, opt = ndsm_tpu.DiffusionOperator(_poly_coef), DiffusionOperator(_poly_coef)
    ut, rt = torch.from_numpy(u), torch.from_numpy(rhs)
    _close(opt.relax(ut, rt, dq, bcs).numpy(), np.asarray(opj.relax(u, rhs, dq, bcs)), npdt)
    _close(opt.residual(ut, rt, dq, bcs).numpy(), np.asarray(opj.residual(u, rhs, dq, bcs)),
           npdt)
    if dt == "f64":  # the loop oracle, with test_operator.py's sine coefficient
        a = _sin_coef_nodes(shape)
        got = DiffusionOperator(_sin_coef_torch).relax(ut, rt, dq, bcs).numpy()
        _close(got, _diffusion_relax_oracle(u, rhs, dq, bcs, a), npdt)


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_helmholtz_c0_is_poisson_bitwise(dt):
    """c = 0 is the Poisson stencil bit for bit (weights, sweep, residual)."""
    npdt, tdt = DTYPES[dt]
    shape, bcs = (6, 5, 8), (("N", "N"), ("D", "N"), ("N", "N"))
    dq = (0.1, 0.12, 0.07)
    u = torch.from_numpy(_rand(shape, 2).astype(npdt))
    rhs = torch.from_numpy(_rand(shape, 3).astype(npdt))
    op = HelmholtzOperator(0.0)
    assert torch.equal(op.relax(u, rhs, dq, bcs), stencils.rb_sweep(u, rhs, dq, bcs))
    assert torch.equal(op.residual(u, rhs, dq, bcs), stencils.poisson_residual(u, rhs, dq, bcs))
    assert stencils.stencil_weights(dq, tdt, 0.0) == stencils.stencil_weights(dq, tdt)


def test_operator_values_and_validation():
    with pytest.raises(ValueError):
        HelmholtzOperator(-1.0)
    with pytest.raises(ValueError):
        DiffusionOperator(None)
    assert HelmholtzOperator(2.0) == HelmholtzOperator(2.0)
    assert hash(HelmholtzOperator(2.0)) == hash(HelmholtzOperator(2.0))
    assert HelmholtzOperator(2.0) != HelmholtzOperator(3.0)
    f = lambda *q: 1.0 + q[0]  # noqa: E731
    g = lambda *q: 1.0 + q[0]  # noqa: E731
    assert DiffusionOperator(f) == DiffusionOperator(f)
    assert hash(DiffusionOperator(f)) == hash(DiffusionOperator(f))
    assert DiffusionOperator(f) != DiffusionOperator(g)  # identity, as in JAX
    nn = (("N", "N"),) * 2
    assert not HelmholtzOperator(1.0).is_singular(nn) and HelmholtzOperator(0.0).is_singular(nn)
    assert DiffusionOperator(f).is_singular(nn) and PoissonOperator().is_singular(nn)
    assert not DiffusionOperator(f).is_singular((("D", "N"), ("N", "N")))
    assert ndsm_tpu_torch.MGOperator().coarse_matrix((3, 3), (1.0, 1.0), nn) is None


# ----------------------------------------------------------------------
# The operator route of the engine and PoissonBVP
# ----------------------------------------------------------------------

def test_operator_route_has_no_kernel_and_no_df_defect(monkeypatch):
    """Traps 1 and 2: under an operator no level takes a kernel route and
    the 3D mixed defect is not the Poisson defect kernel.  Every kernel
    wrapper the engine and the defect loop call is made to raise, and a
    mixed Helmholtz solve must still run (on the CPU the wrappers would
    otherwise run their plain Poisson versions, silently)."""
    x = np.linspace(0.0, 1.0, 9)
    h3 = GridHierarchy.from_mesh((x, x, x))
    h2 = GridHierarchy.from_mesh((x, x))
    bcs3, bcs2 = (("D", "D"), ("D", "D"), ("N", "N")), (("D", "N"), ("N", "D"))
    for h, bcs, route in ((h3, bcs3, "zc"), (h2, bcs2, "v2d")):
        plain = PoissonBVP(h, bcs, Options(precision="mixed"), device="cpu")
        assert plain._inner.kernel_route == route  # the test has teeth
        op = PoissonBVP(h, bcs, Options(precision="mixed"), device="cpu",
                        operator=HelmholtzOperator(1.5))
        assert op._inner.kernel_route is None and op._outer.kernel_route is None
        assert not op.df_defect
    assert PoissonBVP(h3, bcs3, Options(precision="mixed"), device="cpu").df_defect

    def boom(*a, **k):
        raise AssertionError("a Poisson kernel wrapper ran under an operator")

    for mod, names in ((zc, ("zc_smooth_3d", "zc_smooth_residual_3d", "zc_smooth_cor_3d",
                             "zc_smooth_mean_3d")),
                       (v2d, ("v2d_smooth", "v2d_smooth_residual", "v2d_smooth_cor")),
                       (df, ("df_residual_3d",))):
        for nm in names:
            monkeypatch.setattr(mod, nm, boom)
    rhs = _rand((9, 9, 9), 5)
    bvp = PoissonBVP(h3, bcs3, Options(precision="mixed", smoother="compact"), device="cpu",
                     operator=HelmholtzOperator(1.5))
    u, info = bvp.solve(np.zeros_like(rhs), rhs, vc_tol=1e-9)
    assert info.ierr == 0


def test_poisson_operator_generic_route_bitwise():
    """An injected PoissonOperator() reproduces the default fp64 engine
    bit for bit (same stopping cycle, same iterate)."""
    n = 21
    x = np.linspace(0.0, 1.0, n)
    h = GridHierarchy.from_mesh((x, x, x))
    bcs = (("D", "D"), ("N", "D"), ("D", "N"))
    rhs = _rand((n, n, n), 4)
    opts = Options(precision="fp64")
    ua, ia = PoissonBVP(h, bcs, opts, device="cpu").solve(np.zeros_like(rhs), rhs,
                                                          vc_tol=1e-9)
    ub, ib = PoissonBVP(h, bcs, opts, device="cpu", operator=PoissonOperator()).solve(
        np.zeros_like(rhs), rhs, vc_tol=1e-9)
    assert ia.cycles == ib.cycles
    assert torch.equal(ua, ub)


def _dense_solution(rhs, S, int_mask):
    u = np.zeros(rhs.size)
    u[int_mask] = S @ rhs.ravel()[int_mask]
    return u.reshape(rhs.shape)


def test_helmholtz_dense_oracle_3d():
    """Multigrid Helmholtz solve vs the dense fine-grid inverse."""
    n, c = 17, 3.4
    x = np.linspace(0.0, 1.0, n)
    bcs = (("D", "N"), ("N", "D"), ("D", "D"))
    rhs = np.sin(17 * x[:, None, None] + 2.1 * x[None, :, None] + 8.4 * x[None, None, :])
    u, info = solve_poisson_bvp(np.zeros_like(rhs), rhs, (x, x, x), bcs,
                                options=Options(precision="fp64", vc_tol=1e-11),
                                operator=HelmholtzOperator(c), device="cpu")
    assert info.ierr == 0
    S, m = coarse.build_coarse_solver_matrix((n, n, n), [x[1] - x[0]] * 3, bcs, diag_shift=-c)
    assert np.abs(u.numpy() - _dense_solution(rhs, S, m)).max() < 1e-9


def test_helmholtz_4d_dense_oracle():
    """The operator route is N-D like the engine: 4D Helmholtz vs the dense inverse."""
    n, c = 7, 1.3
    x = np.linspace(0.0, 1.0, n)
    bcs = (("D", "D"), ("N", "N"), ("D", "N"), ("D", "D"))
    rhs = _rand((n,) * 4, 21)
    h = GridHierarchy.from_mesh((x,) * 4, ngrids=2)
    bvp = PoissonBVP(h, bcs, Options(precision="fp64", vc_tol=1e-11), device="cpu",
                     operator=HelmholtzOperator(c))
    u, info = bvp.solve(np.zeros_like(rhs), rhs)
    assert info.ierr == 0
    S, m = coarse.build_coarse_solver_matrix((n,) * 4, [x[1] - x[0]] * 4, bcs, diag_shift=-c)
    assert np.abs(u.numpy() - _dense_solution(rhs, S, m)).max() < 1e-9


def test_diffusion_dense_oracle_3d():
    """Variable-coefficient solve vs the dense inverse assembled
    generically from the operator's own residual."""
    n = 17
    x = np.linspace(0.0, 1.0, n)
    bcs = (("D", "N"), ("N", "D"), ("D", "D"))
    rhs = _rand((n, n, n), 43)
    op = DiffusionOperator(_sin_coef_torch)
    u, info = solve_poisson_bvp(np.zeros_like(rhs), rhs, (x, x, x), bcs,
                                options=Options(precision="fp64", vc_tol=1e-11),
                                operator=op, device="cpu")
    assert info.ierr == 0
    S, m = coarse.build_coarse_matrix_from_operator(op, (n, n, n), [x[1] - x[0]] * 3, bcs)
    assert np.abs(u.numpy() - _dense_solution(rhs, S, m)).max() < 1e-8


def test_diffusion_holds_terms_only_within_a_solve():
    """The face coefficients and ``den`` of each level are kept while a
    solve runs (one entry per level and dtype) and dropped when it
    returns; held and fresh terms give the same numbers."""
    n = 17
    x = np.linspace(0.0, 1.0, n)
    bcs = (("D", "N"), ("N", "D"), ("D", "D"))
    rhs = _rand((n, n, n), 44)
    # a function object of its own: equal operators share the engine cache
    op = DiffusionOperator(lambda *q: _sin_coef_torch(*q))
    h = GridHierarchy.from_mesh((x, x, x))
    bvp = PoissonBVP(h, bcs, Options(precision="mixed"), device="cpu", operator=op)
    seen = []
    level_terms = op._level_terms

    def spy(u, w, window=None):
        out = level_terms(u, w, window)
        seen.append({k[:2] for k in op._terms._d})
        return out

    object.__setattr__(op, "_level_terms", spy)
    try:
        u, info = bvp.solve(np.zeros_like(rhs), rhs)
    finally:
        object.__delattr__(op, "_level_terms")
    assert info.ierr == 0 and len(op._terms) == 0 and not op._depth
    # float64 on the finest level (the outer defect), float32 on every level
    want = {(s, torch.float32) for s in h.shapes} | {(h.shapes[0], torch.float64)}
    assert seen[-1] == want
    ut, rt = torch.as_tensor(_rand((n, n, n), 45)), torch.as_tensor(rhs)
    dq = [x[1] - x[0]] * 3
    with op.held():
        held = (op.relax(ut, rt, dq, bcs), op.residual(ut, rt, dq, bcs))
        assert len(op._terms) == 1
    assert len(op._terms) == 0
    assert torch.equal(held[0], op.relax(ut, rt, dq, bcs))
    assert torch.equal(held[1], op.residual(ut, rt, dq, bcs))


def test_generic_coarse_assembly():
    """build_coarse_matrix_from_operator: PoissonOperator and Helmholtz
    against the hand assembly (with diag_shift), Diffusion against JAX's
    generic assembly; the regular-inverse and the all-Neumann
    pseudo-inverse branches; within 1e-10 relative."""
    dq = [0.125, 0.2, 0.11]
    shape = (5, 6, 5)

    def rel(a, b):
        return np.abs(a - b).max() / np.abs(b).max()

    for bcs in ((("D", "N"), ("N", "N"), ("D", "D")), (("N", "N"),) * 3):
        S_hand, m_hand = coarse.build_coarse_solver_matrix(shape, dq, bcs)
        S_gen, m_gen = coarse.build_coarse_matrix_from_operator(PoissonOperator(), shape, dq,
                                                                bcs)
        assert np.array_equal(m_hand, m_gen) and rel(S_gen, S_hand) < 1e-10
        S_hand, _ = coarse.build_coarse_solver_matrix(shape, dq, bcs, diag_shift=-2.5)
        S_gen, _ = coarse.build_coarse_matrix_from_operator(HelmholtzOperator(2.5), shape, dq,
                                                            bcs)
        assert rel(S_gen, S_hand) < 1e-10
        S_j, m_j = jax_generic(ndsm_tpu.DiffusionOperator(_poly_coef), shape, dq, bcs)
        S_t, m_t = coarse.build_coarse_matrix_from_operator(DiffusionOperator(_poly_coef),
                                                            shape, dq, bcs)
        assert np.array_equal(m_j, m_t) and rel(S_t, S_j) < 1e-10


def test_diffusion_constant_coef_is_poisson():
    """a == const: the diffusion solve is the Poisson one divided by it."""
    n = 17
    x = np.linspace(0.0, 1.0, n)
    bcs = (("D", "D"), ("N", "D"), ("D", "N"))
    rhs = _rand((n, n, n), 42)
    opts = Options(precision="fp64", vc_tol=1e-11)
    u_p, i_p = solve_poisson_bvp(np.zeros_like(rhs), rhs, (x, x, x), bcs, options=opts,
                                 device="cpu")
    u_d, i_d = solve_poisson_bvp(np.zeros_like(rhs), rhs, (x, x, x), bcs, options=opts,
                                 operator=DiffusionOperator(lambda *q: 3.25 + 0.0 * q[0]),
                                 device="cpu")
    assert i_p.ierr == 0 and i_d.ierr == 0
    assert np.abs(3.25 * u_d.numpy() - u_p.numpy()).max() < 1e-9


def _manufactured(n, c):
    x = np.linspace(0.0, 1.0, n)
    s = np.sin(np.pi * x)
    U = s[:, None, None] * s[None, :, None] * s[None, None, :]
    return x, U, -(3.0 * np.pi**2 + c) * U


@pytest.mark.parametrize("precision", ["fp64", "mixed", "fp32"])
def test_helmholtz_manufactured_scaling(precision):
    """u* = sin(pi x)sin(pi y)sin(pi z), L[u*] = -(3 pi^2 + c) u*: the
    error falls ~h^2 from 17^3 to 33^3 in every precision mode (mixed runs
    the float64 defect through the injected operator)."""
    c = 1.9
    tol = {"fp64": 1e-10, "mixed": 1e-10, "fp32": 2e-6}[precision]
    errs, hs = [], []
    for n in (17, 33):
        x, U, rhs = _manufactured(n, c)
        u, info = solve_poisson_bvp(np.zeros_like(U), rhs, (x, x, x), (("D", "D"),) * 3,
                                    options=Options(precision=precision, vc_tol=tol),
                                    operator=HelmholtzOperator(c), device="cpu")
        assert info.ierr == 0
        errs.append(np.abs(u.double().numpy() - U).max())
        hs.append(x[1] - x[0])
    rate = np.log(errs[0] / errs[1]) / np.log(hs[0] / hs[1])
    assert 1.7 < rate < 2.3, (rate, errs)


@pytest.mark.parametrize("precision", ["fp64", "mixed"])
def test_diffusion_manufactured_scaling(precision):
    """a = 1 + x y z (examples/diffusion_operator.py's case): rhs = a
    lap(u*) + grad(a).grad(u*); the error falls ~h^2."""
    errs, hs = [], []
    for n in (17, 33):
        x = np.linspace(0.0, 1.0, n)
        Z, Y, X = x[:, None, None], x[None, :, None], x[None, None, :]
        sx, cx = np.sin(np.pi * X), np.cos(np.pi * X)
        sy, cy = np.sin(np.pi * Y), np.cos(np.pi * Y)
        sz, cz = np.sin(np.pi * Z), np.cos(np.pi * Z)
        U = sz * sy * sx
        rhs = (1.0 + Z * Y * X) * (-3.0 * np.pi**2) * U + np.pi * (
            Y * X * cz * sy * sx + Z * X * sz * cy * sx + Z * Y * sz * sy * cx)
        u, info = solve_poisson_bvp(
            np.zeros((n, n, n)), rhs, (x, x, x), (("D", "D"),) * 3,
            options=Options(precision=precision, vc_tol=1e-10),
            operator=DiffusionOperator(lambda q0, q1, q2: 1.0 + q0 * q1 * q2), device="cpu")
        assert info.ierr == 0
        errs.append(np.abs(u.numpy() - U).max())
        hs.append(x[1] - x[0])
    rate = np.log(errs[0] / errs[1]) / np.log(hs[0] / hs[1])
    assert 1.7 < rate < 2.3, (rate, errs)


def test_helmholtz_all_neumann_nonsingular():
    """All-Neumann with c > 0 has no nullspace: the constant offset is
    recovered and no mean is pinned."""
    c, n = 1.0, 33
    x = np.linspace(0.0, 1.0, n)
    Y, X = np.meshgrid(x, x, indexing="ij")
    U = np.cos(np.pi * X) * np.cos(np.pi * Y) + 0.37
    rhs = -(2.0 * np.pi**2) * (U - 0.37) - c * U
    op = HelmholtzOperator(c)
    bcs = (("N", "N"), ("N", "N"))
    bvp = PoissonBVP(GridHierarchy.from_mesh((x, x)), bcs,
                     Options(precision="fp64", vc_tol=1e-11), device="cpu", operator=op)
    assert not bvp._all_neumann
    u, info = bvp.solve(np.zeros_like(U), rhs)
    assert info.ierr == 0
    assert np.abs(u.numpy() - U).max() < 5e-3


def test_diffusion_all_neumann_singular():
    """All-Neumann diffusion keeps the constant nullspace for any positive
    a: the mean-pinned solve converges to the mean-free solution ~h^2."""
    op = DiffusionOperator(lambda q0, q1: 1.0 + 0.3 * q0 * q1)
    errs, hs = [], []
    for n in (33, 65):
        x = np.linspace(0.0, 1.0, n)
        Y, X = x[:, None], x[None, :]
        cy, sy = np.cos(np.pi * Y), np.sin(np.pi * Y)
        cx, sx = np.cos(np.pi * X), np.sin(np.pi * X)
        U = cy * cx
        rhs = (1.0 + 0.3 * Y * X) * (-2.0 * np.pi**2) * U + 0.3 * np.pi * (
            X * (-sy) * cx + Y * cy * (-sx))
        u, info = solve_poisson_bvp(np.zeros((n, n)), rhs, (x, x), (("N", "N"), ("N", "N")),
                                    options=Options(precision="fp64", vc_tol=1e-11, mean=True),
                                    operator=op, device="cpu")
        assert info.ierr == 0
        got = u.numpy() - u.numpy().mean()
        errs.append(np.abs(got - (U - U.mean())).max())
        hs.append(x[1] - x[0])
    rate = np.log(errs[0] / errs[1]) / np.log(hs[0] / hs[1])
    assert 1.7 < rate < 2.3, (rate, errs)


@dataclasses.dataclass(frozen=True)
class _NoCoarseHelmholtz(HelmholtzOperator):
    """No dense coarse assembly: the engine relaxes the coarsest grid."""

    def coarse_matrix(self, shape, dq, bcs):
        return None


def test_operator_coarse_relax_fallback():
    n, c = 17, 3.4
    x = np.linspace(0.0, 1.0, n)
    bcs = (("D", "N"), ("N", "D"), ("D", "D"))
    rhs = _rand((n, n, n), 7)
    h = GridHierarchy.from_mesh((x, x, x))
    opts = Options(precision="fp64", vc_tol=1e-10, coarse_solver="direct")
    bvp = PoissonBVP(h, bcs, opts, device="cpu", operator=_NoCoarseHelmholtz(c))
    assert not bvp._inner.coarse_direct
    u, info = bvp.solve(np.zeros_like(rhs), rhs)
    bvp2 = PoissonBVP(h, bcs, opts, device="cpu", operator=HelmholtzOperator(c))
    assert bvp2._inner.coarse_direct
    u2, info2 = bvp2.solve(np.zeros_like(rhs), rhs)
    assert info.ierr == 0 and info2.ierr == 0
    assert np.abs(u.numpy() - u2.numpy()).max() < 1e-8


def test_engine_cache_keys_distinct_operators():
    """Same hierarchy, BCs and options with different operators do not
    share an engine or a BVP."""
    from ndsm_tpu_torch.mg.poisson import get_poisson_bvp

    n = 17
    x = np.linspace(0.0, 1.0, n)
    bcs = (("D", "D"),) * 3
    rhs = _rand((n, n, n), 8)
    opts = Options(precision="fp64", vc_tol=1e-10)
    h = GridHierarchy.from_mesh((x, x, x))
    b_p = get_poisson_bvp(h, bcs, opts, device="cpu")
    b_h = get_poisson_bvp(h, bcs, opts, device="cpu", operator=HelmholtzOperator(5.0))
    assert b_p is not b_h and b_p._inner is not b_h._inner
    assert get_poisson_bvp(h, bcs, opts, device="cpu", operator=HelmholtzOperator(5.0)) is b_h
    u_p1, _ = solve_poisson_bvp(np.zeros_like(rhs), rhs, (x, x, x), bcs, options=opts,
                                device="cpu")
    u_h, _ = solve_poisson_bvp(np.zeros_like(rhs), rhs, (x, x, x), bcs, options=opts,
                               operator=HelmholtzOperator(5.0), device="cpu")
    u_p2, _ = solve_poisson_bvp(np.zeros_like(rhs), rhs, (x, x, x), bcs, options=opts,
                                device="cpu")
    assert (u_p1 - u_h).abs().max() > 1e-6
    assert torch.equal(u_p1, u_p2)


# ----------------------------------------------------------------------
# Solves against JAX
# ----------------------------------------------------------------------

def _stratified_coef(z, y, x):
    """The benchmark's ``diffusion3d`` coefficient, a(z) = exp(-ln(20) z) on
    the normalised height, on jnp arrays and tensors."""
    exp = torch.exp if isinstance(z, torch.Tensor) else jnp.exp
    return exp(-math.log(20.0) * z)


def _ops(kind):
    if kind == "helmholtz":
        return ndsm_tpu.HelmholtzOperator(2.2), HelmholtzOperator(2.2)
    coef = _stratified_coef if kind == "stratified" else _poly_coef
    return ndsm_tpu.DiffusionOperator(coef), DiffusionOperator(coef)


@pytest.mark.parametrize("precision", ["fp64", "mixed"])
@pytest.mark.parametrize("kind", ["helmholtz", "diffusion", "stratified"])
def test_operator_solve_matches_jax(kind, precision):
    """"stratified" is the benchmark's singular deployment: all faces
    Neumann (per-sweep mean pinning, the pinv coarse solve), a manufactured
    compatible rhs, and u compared with the means taken out."""
    n = 17
    x = np.linspace(0.0, 1.0, n)
    opj, opt = _ops(kind)
    if kind == "stratified":
        bcs = (("N", "N"),) * 3
        c = [np.cos(np.pi * k * x) for k in (1, 2, 1)]
        u_true = torch.from_numpy(np.einsum("i,j,k->ijk", *c))
        dq = (x[1] - x[0],) * 3
        rhs = (-opt.residual(u_true, torch.zeros_like(u_true), dq, bcs)).numpy()
        u0 = np.zeros_like(rhs)
    else:
        bcs = (("D", "D"), ("D", "D"), ("N", "N"))
        rhs = _rand((n, n, n), 31)
        u0 = np.zeros_like(rhs)
        u0[0] = 0.2  # Dirichlet data carried in u0 and frozen
    uj, ij = ndsm_tpu.solve_poisson_bvp(u0, rhs, (x, x, x), bcs, operator=opj,
                                        options=ndsm_tpu.Options(precision=precision,
                                                                 vc_tol=1e-10))
    ut, it = solve_poisson_bvp(u0, rhs, (x, x, x), bcs, operator=opt,
                               options=Options(precision=precision, vc_tol=1e-10),
                               device="cpu")
    assert ij.ierr == it.ierr == 0
    ut, uj = ut.numpy(), np.asarray(uj)
    if kind == "stratified":
        ut, uj = ut - ut.mean(), uj - uj.mean()
    err = np.abs(ut - uj).max()
    if precision == "fp64":
        assert ij.cycles == it.cycles and err < 1e-12, (ij.cycles, it.cycles, err)
    else:
        assert abs(ij.cycles - it.cycles) <= 1 and err < 5e-10, (ij.cycles, it.cycles, err)
    if kind != "stratified":
        assert np.array_equal(ut[0], u0[0])


def test_operator_solve_batch_lane_by_lane():
    """solve_batch under an operator runs each problem on its own (the
    operator sees no lane axis): each lane equals its standalone solve."""
    n = 17
    x = np.linspace(0.0, 1.0, n)
    bcs = (("N", "N"), ("N", "N"))
    bvp = PoissonBVP(GridHierarchy.from_mesh((x, x)), bcs, Options(precision="mixed"),
                     device="cpu", operator=HelmholtzOperator(0.7))
    assert bvp._inner.coarse_direct  # the 2D lane-masked route would apply without one
    rhss = [_rand((n, n), 50), _rand((n, n), 51)]
    us, infos = bvp.solve_batch([np.zeros((n, n))] * 2, rhss)
    for u, info, rhs in zip(us, infos, rhss):
        u1, i1 = bvp.solve(np.zeros((n, n)), rhs)
        assert info.batch_size == 1 and info.cycles == i1.cycles and info.ierr == 0
        assert torch.equal(u, u1)


def test_helmholtz_history_and_checkpointed_resume(tmp_path):
    """history=True and solve_checkpointed run through the operator route
    (the JAX tests' contract: finite per-cycle du, the strict checkpointed
    solve within 1e-9 of the default one, a resume runs no cycle)."""
    n, c = 17, 2.0
    x = np.linspace(0.0, 1.0, n)
    bcs = (("D", "D"),) * 3
    rhs = _rand((n, n, n), 30)
    bvp = PoissonBVP(GridHierarchy.from_mesh((x, x, x)), bcs,
                     Options(precision="mixed", vc_tol=1e-10), device="cpu",
                     operator=HelmholtzOperator(c))
    u_ref, i_ref = bvp.solve(np.zeros_like(rhs), rhs)
    u_h, i_h = bvp.solve(np.zeros_like(rhs), rhs, history=True)
    assert torch.equal(u_h, u_ref) and len(i_h.du_history) == i_h.cycles
    assert np.isfinite(i_h.du_history).all() and i_h.du_history[-1] == i_h.du_last < 1e-10
    ck = str(tmp_path / "hck.npz")
    u_ck, i_ck = bvp.solve_checkpointed(np.zeros_like(rhs), rhs, checkpoint_path=ck,
                                        checkpoint_every=2)
    assert i_ck.ierr == 0
    assert np.abs(u_ck.numpy() - u_ref.numpy()).max() < 1e-9
    u2, i2 = bvp.solve_checkpointed(np.zeros_like(rhs), rhs, checkpoint_path=ck,
                                    checkpoint_every=2)
    assert i2.cycles == i_ck.cycles and torch.equal(u2, u_ck)
