"""ops/diffusion.py: ``DiffusionOperator``'s sweep and residual kernels
(``csrc/diffusion.cu``) and their plain versions.  No JAX: the kernels
replace no TPU kernel, and the card tests run in this file.

On the CPU (seconds):
  * the wrappers' plain versions equal the operator's arithmetic as it ran
    before the kernels (a frozen copy below), bitwise, at 9^3 and 17^3 in
    float32 and float64, on whole levels and on a window's block;
  * a whole solve through the operator equals the frozen operator's,
    bitwise (u and cycles);
  * a 3D operator calls the wrappers, a 2D or 4D one does not;
  * ``ndsm.op.terms`` counts one build a level a solve (and the finest
    level's float64 terms);
  * the wrappers raise on what the kernels do not take.

On the card (``cuda``, skipped without one): each kernel equals its plain
version bitwise in float32 and float64, at 2^3, 3^3, 4^3, 5x7x9, 17^3, 65^3,
129^3 and 257x130x67 (odd and even extents, partial tiles), all-Neumann,
all-Dirichlet and mixed faces, a stratified, a random positive and a
constant coefficient, both colour flips; and a whole 65^3 solve of the
benchmark's stratified all-Neumann problem (mixed and fp64) on the kernel
route equals the plain route on the card: u bitwise, the same cycles, the
kernels launched and no plain version run.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from ndsm_tpu_torch import (DiffusionOperator, GridHierarchy, Options, PoissonBVP,
                            solve_poisson_bvp)
from ndsm_tpu_torch import ops
from ndsm_tpu_torch.mg.operator import MGOperator, Window, _unit_nodes
from ndsm_tpu_torch.ops import diffusion, stencils
from ndsm_tpu_torch.utils import profiling

torch.set_num_threads(1)

NNN = (("N", "N"),) * 3
DDD = (("D", "D"),) * 3
DN_ND = (("D", "N"), ("N", "D"), ("D", "N"))  # first colour parity 1
ND_DN = (("N", "D"), ("D", "N"), ("N", "D"))  # first colour parity 0
BCS = {"NNN": NNN, "DDD": DDD, "DN_ND": DN_ND, "ND_DN": ND_DN}
DTYPES = {"f32": torch.float32, "f64": torch.float64}
RATE = math.log(20.0)


def stratified(z, y, x):
    """The benchmark's coefficient, a(z) = exp(-ln(20) z)."""
    return torch.exp(-RATE * z)


def poly(z, y, x):
    return 1.0 + 0.5 * z * y + 0.3 * x


# ----------------------------------------------------------------------
# The operator's arithmetic before the kernels, frozen
# ----------------------------------------------------------------------

def _frozen_halves(shape, coef, dtype, device, window=None):
    if window is None:
        nodes = [_unit_nodes(n, dtype) for n in shape]
    else:
        nodes = [_unit_nodes(g, dtype)[o:o + n]
                 for n, g, o in zip(shape, window.shape, window.offsets)]
    coords = torch.meshgrid(*[torch.as_tensor(v, device=device) for v in nodes], indexing="ij")
    a = torch.as_tensor(coef(*coords), dtype=dtype, device=device).broadcast_to(shape)
    halves = []
    for ax in range(len(shape)):
        lo, hi = stencils._neighbors(a, ax)
        halves.append((0.5 * (a + lo), 0.5 * (a + hi)))
    return halves


def _frozen_terms(u, coef, w, window):
    halves = _frozen_halves(tuple(u.shape), coef, u.dtype, u.device, window)
    den = None
    for ax, (alo, ahi) in enumerate(halves):
        t = (alo + ahi) * w[ax]
        den = t if den is None else den + t
    return halves, den


@dataclasses.dataclass(frozen=True)
class FrozenDiffusion(MGOperator):
    """``DiffusionOperator`` as it was before its kernels (no held terms)."""

    coef: object = None
    supports_window = True

    def relax(self, u, rhs, dq, bcs, window=None):
        bcs = stencils.validate_bcs(bcs, u.ndim)
        w, _ = stencils.stencil_weights(dq, u.dtype)
        halves, den = _frozen_terms(u, self.coef, w, window)
        offsets = () if window is None else window.offsets
        for mask in stencils.color_masks(tuple(u.shape), bcs, u.device, offsets):
            num = None
            for ax in range(u.ndim):
                lo, hi = stencils._neighbors(u, ax)
                alo, ahi = halves[ax]
                t = (alo * lo + ahi * hi) * w[ax]
                num = t if num is None else num + t
            u = torch.where(mask, (num - rhs) / den, u)
        if window is None and self.is_singular(bcs):
            u = stencils.subtract_mean(u)
        return u

    def residual(self, u, rhs, dq, bcs, window=None):
        bcs = stencils.validate_bcs(bcs, u.ndim)
        w, _ = stencils.stencil_weights(dq, u.dtype)
        halves, _ = _frozen_terms(u, self.coef, w, window)
        out = None
        for ax in range(u.ndim):
            lo, hi = stencils._neighbors(u, ax)
            alo, ahi = halves[ax]
            term = (ahi * (hi - u) - alo * (u - lo)) * w[ax]
            out = term if out is None else out + term
        r = rhs - out
        return r.masked_fill(~stencils.interior_mask(tuple(u.shape), bcs, u.device), 0.0)

    def coarse_matrix(self, shape, dq, bcs):
        from ndsm_tpu_torch.mg.coarse import build_coarse_matrix_from_operator

        return build_coarse_matrix_from_operator(self, shape, dq, bcs)

    def is_singular(self, bcs):
        return stencils.is_all_neumann(bcs)


def _rand(shape, seed, dtype=torch.float64, device="cpu"):
    x = np.random.default_rng(seed).standard_normal(shape)
    return torch.as_tensor(x).to(dtype=dtype, device=device)


def _dq(shape, window=None):
    ext = shape if window is None else window.shape
    return [1.0 / (n - 1) for n in ext]


# ----------------------------------------------------------------------
# CPU
# ----------------------------------------------------------------------

@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("n", [9, 17])
@pytest.mark.parametrize("bcs", list(BCS))
def test_plain_versions_equal_the_frozen_operator(dt, n, bcs):
    dtype, bcs = DTYPES[dt], BCS[bcs]
    shape = (n, n - 1, n + 2)
    u, rhs = _rand(shape, 1, dtype), _rand(shape, 2, dtype)
    dq = _dq(shape)
    w, _ = stencils.stencil_weights(dq, dtype)
    frozen = FrozenDiffusion(poly)
    for flip in (0, 1):  # the colours of a block at an even or odd offset
        win = Window((n + 1,) + shape[1:], (flip, 0, 0))
        a = DiffusionOperator(poly)._level_terms(u, w, win)[0]
        got = diffusion.diffusion_sweep(u, rhs, a, w, bcs, flip)
        assert got.dtype == dtype and torch.equal(got, frozen.relax(u, rhs, dq, bcs, window=win))
    a = DiffusionOperator(poly)._level_terms(u, w)[0]
    assert torch.equal(diffusion.diffusion_residual(u, rhs, a, w, bcs),
                       frozen.residual(u, rhs, dq, bcs))
    # the operator itself, with its terms held and without
    op = DiffusionOperator(poly)
    want = frozen.relax(u, rhs, dq, bcs)
    assert torch.equal(op.relax(u, rhs, dq, bcs), want)
    with op.held():
        assert torch.equal(op.relax(u, rhs, dq, bcs), want)
        assert torch.equal(op.residual(u, rhs, dq, bcs), frozen.residual(u, rhs, dq, bcs))
    # a block of a level at an odd offset, with its own faces
    win = Window((2 * n + 1, n - 1, n + 2), (n // 2 + 1, 0, 0))
    dq = _dq(shape, win)
    blk = (("D", "D"),) + bcs[1:]
    assert torch.equal(op.relax(u, rhs, dq, blk, window=win),
                       frozen.relax(u, rhs, dq, blk, window=win))
    assert torch.equal(op.residual(u, rhs, dq, blk, window=win),
                       frozen.residual(u, rhs, dq, blk, window=win))


@pytest.mark.parametrize("precision", ["mixed", "fp64"])
def test_solve_equals_the_frozen_operator(precision):
    n = 17
    x = np.linspace(0.0, 1.0, n)
    for bcs in (NNN, DN_ND):
        u_true = _rand((n, n, n), 7).numpy()
        rhs = -FrozenDiffusion(stratified).residual(
            torch.as_tensor(u_true), torch.zeros((n, n, n), dtype=torch.float64),
            [x[1] - x[0]] * 3, bcs).numpy()
        opts = Options(precision=precision, vc_tol=1e-10)
        got = solve_poisson_bvp(np.zeros_like(rhs), rhs, (x, x, x), bcs, options=opts,
                                operator=DiffusionOperator(stratified), device="cpu")
        want = solve_poisson_bvp(np.zeros_like(rhs), rhs, (x, x, x), bcs, options=opts,
                                 operator=FrozenDiffusion(stratified), device="cpu")
        assert got[1].ierr == want[1].ierr == 0
        assert got[1].cycles == want[1].cycles and torch.equal(got[0], want[0])


def test_3d_routes_through_the_wrappers_2d_and_4d_do_not(monkeypatch):
    calls = {"diffusion_sweep": 0, "diffusion_residual": 0}
    for name in calls:
        real = getattr(diffusion, name)

        def counted(*a, _real=real, _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)

        monkeypatch.setattr(diffusion, name, counted)
    op = DiffusionOperator(lambda *q: 1.0 + 0.25 * q[0])
    for ndim, n in ((2, 9), (4, 5)):
        u, rhs = _rand((n,) * ndim, 3), _rand((n,) * ndim, 4)
        bcs, dq = (("N", "D"),) * ndim, [1.0 / (n - 1)] * ndim
        frozen = FrozenDiffusion(op.coef)
        assert torch.equal(op.relax(u, rhs, dq, bcs), frozen.relax(u, rhs, dq, bcs))
        assert torch.equal(op.residual(u, rhs, dq, bcs), frozen.residual(u, rhs, dq, bcs))
    assert calls == {"diffusion_sweep": 0, "diffusion_residual": 0}
    u, rhs = _rand((9, 9, 9), 3), _rand((9, 9, 9), 4)
    op.relax(u, rhs, [0.125] * 3, NNN)
    op.residual(u, rhs, [0.125] * 3, NNN)
    assert calls == {"diffusion_sweep": 1, "diffusion_residual": 1}


def test_term_builds_one_a_level_a_solve():
    n = 17
    x = np.linspace(0.0, 1.0, n)
    h = GridHierarchy.from_mesh((x, x, x))
    rhs = _rand((n, n, n), 5).numpy()
    op = DiffusionOperator(lambda *q: stratified(*q))
    bvp = PoissonBVP(h, DN_ND, Options(precision="mixed"), device="cpu", operator=op)
    bvp.solve(np.zeros_like(rhs), rhs)  # builds the engine and its coarse matrix
    profiling.reset(profiling.OP_TERMS)
    u, info = bvp.solve(np.zeros_like(rhs), rhs)
    # float32 on every level, float64 on the finest (the outer defect)
    assert info.ierr == 0 and profiling.counter(profiling.OP_TERMS) == len(h.shapes) + 1
    assert len(op._terms) == 0


def test_wrappers_raise_on_what_the_kernels_do_not_take():
    u = _rand((5, 6, 7), 1)
    w = (1.0, 2.0, 3.0)
    with pytest.raises(TypeError):
        diffusion.diffusion_sweep(u.to(torch.float16), u.to(torch.float16),
                                  u.to(torch.float16), w, NNN)
    with pytest.raises(TypeError):
        diffusion.diffusion_residual(u, u.float(), u, w, NNN)
    with pytest.raises(ValueError, match="shape"):
        diffusion.diffusion_sweep(u, u[:4].contiguous(), u, w, NNN)
    with pytest.raises(ValueError, match="contiguous"):
        diffusion.diffusion_residual(u, u, u.transpose(0, 2).contiguous().transpose(0, 2), w,
                                     NNN)
    with pytest.raises(ValueError, match="shape"):
        diffusion.diffusion_sweep(u[0], u[0], u[0], w[:2], NNN[:2])
    with pytest.raises(ValueError, match="w must"):
        diffusion.diffusion_residual(u, u, u, w[:2], NNN)
    with pytest.raises(ValueError, match="flip"):
        diffusion.diffusion_sweep(u, u, u, w, NNN, flip=2)
    with pytest.raises(ValueError, match="bcs"):
        diffusion.diffusion_sweep(u, u, u, w, (("N", "X"),) * 3)


def test_kernels_are_in_the_table():
    rows = {k[0]: k for k in ops.KERNELS}
    for name in ("diffusion_sweep", "diffusion_residual"):
        _, fn, plain, replaces, source = rows[name]
        assert fn is getattr(diffusion, name) and plain is getattr(diffusion, name + "_plain")
        assert replaces == "none (XLA in JAX)" and source.endswith("csrc/diffusion.cu")
        assert name in ops.launch_counts() and plain.__name__ in ops.plain_cuda_counts()


# ----------------------------------------------------------------------
# The card
# ----------------------------------------------------------------------

SHAPES = [(2, 2, 2), (3, 3, 3), (4, 4, 4), (5, 7, 9), (17, 17, 17), (65, 65, 65),
          (129, 129, 129), (257, 130, 67)]


def _coefs(shape, dtype, device):
    """The stratified, a random positive and a constant coefficient."""
    nz = shape[0]
    z = torch.as_tensor(_unit_nodes(nz, dtype), device=device).view(nz, 1, 1)
    strat = torch.exp(-RATE * z).broadcast_to(shape).contiguous()
    rnd = 0.5 + torch.as_tensor(np.random.default_rng(11).random(shape)).to(dtype=dtype,
                                                                             device=device)
    const = torch.full(shape, 3.25, dtype=dtype, device=device)
    return {"stratified": strat, "random": rnd, "constant": const}


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("bcs", list(BCS))
def test_cuda_kernels_bitwise_plain(dt, bcs):
    _need_cuda()
    dtype, bcs = DTYPES[dt], BCS[bcs]
    for shape in SHAPES:
        u, rhs = _rand(shape, 1, dtype, "cuda"), _rand(shape, 2, dtype, "cuda")
        w, _ = stencils.stencil_weights(_dq(shape), dtype)
        for kind, a in _coefs(shape, dtype, "cuda").items():
            what = f"{dt} {shape} {bcs} {kind}"
            for flip in (0, 1):
                got = diffusion.diffusion_sweep(u, rhs, a, w, bcs, flip)
                want = diffusion.diffusion_sweep_plain(u, rhs, a, w, bcs, flip)
                assert torch.equal(got, want), f"sweep {what} flip {flip}"
            got = diffusion.diffusion_residual(u, rhs, a, w, bcs)
            assert torch.equal(got, diffusion.diffusion_residual_plain(u, rhs, a, w, bcs)), \
                f"residual {what}"
        torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["mixed", "fp64"])
def test_cuda_solve_equals_the_plain_route(precision, monkeypatch):
    """The benchmark's problem at 65^3: all faces Neumann, a(z) =
    exp(-ln(20) z), its options, rhs = L(u_true) of a random u_true."""
    _need_cuda()
    n = 65
    x = np.linspace(0.0, 1.0, n)
    u_true = _rand((n, n, n), 9)
    rhs = -FrozenDiffusion(stratified).residual(u_true, torch.zeros_like(u_true),
                                                [x[1] - x[0]] * 3, NNN).numpy()
    opts = Options(ms=5, vc_tol=1e-10, ex_tol=1e-13, precision=precision, mixed_inner_max=6)

    def solve(coef):  # a function object of its own: an engine of its own
        return solve_poisson_bvp(np.zeros_like(rhs), rhs, (x, x, x), NNN, options=opts,
                                 operator=DiffusionOperator(coef), device="cuda")

    ops.reset_launch_counts()
    u_k, i_k = solve(lambda *q: stratified(*q))
    torch.cuda.synchronize()
    launches, plain = ops.launch_counts(), ops.plain_cuda_counts()
    assert launches["diffusion_sweep"] > 0 and launches["diffusion_residual"] > 0
    assert plain["diffusion_sweep_plain"] == plain["diffusion_residual_plain"] == 0

    monkeypatch.setattr(diffusion, "diffusion_sweep", diffusion.diffusion_sweep_plain)
    monkeypatch.setattr(diffusion, "diffusion_residual", diffusion.diffusion_residual_plain)
    ops.reset_launch_counts()
    u_p, i_p = solve(lambda *q: stratified(*q))
    torch.cuda.synchronize()
    assert ops.plain_cuda_counts()["diffusion_sweep_plain"] > 0
    assert ops.launch_counts()["diffusion_sweep"] == 0
    assert i_k.ierr == i_p.ierr == 0 and i_k.cycles == i_p.cycles
    assert torch.equal(u_k, u_p)
