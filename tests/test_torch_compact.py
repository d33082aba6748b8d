"""ops/stencils_compact.py (the colour-split sweep in plain PyTorch) and
ops/compact.py (the colour-split smoother kernels' module) against
ndsm_tpu's ``stencils_compact`` and its Pallas ``compact_smooth_3d`` run in
interpret mode on the CPU.

On the CPU the wrappers run their plain PyTorch versions; those are what
the CUDA kernels are held to bitwise on the card (the ``cuda``-marked test
below, and chip_smoke.py).

Tolerances:
  * split and merge against JAX's: bitwise, and an exact round trip;
  * ``rb_sweep_compact`` against JAX's on the same numpy inputs, float32
    and float64: <= 2 ulp of max|u| per sweep where the problem is not
    all-Neumann (XLA:CPU contracts multiply-adds, the port does not),
    <= 3 ulp all-Neumann (the mean's sum order on top);
  * the port's ``rb_sweep_compact``, merged, against the port's masked
    ``rb_sweep``: bitwise wherever the problem is not all-Neumann (the same
    expressions in the same order), 1-4 sweeps;
  * ``compact_smooth_3d`` against JAX's interpreted Pallas kernel:
    <= 1 ulp of max|u| per sweep;
  * lane form against one-lane calls, frozen lanes, the dense interface
    against ops/zc.py's plain versions: bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndsm_tpu.ops import pallas_compact
from ndsm_tpu.ops import stencils_compact as jsc
from ndsm_tpu_torch import ops
from ndsm_tpu_torch.ops import compact, stencils, zc
from ndsm_tpu_torch.ops import stencils_compact as sc

torch.set_num_threads(1)

ALL_N3 = (("N", "N"),) * 3
# The cases of tests/test_compact.py (2D, 3D, 4D, odd nx, a flipped first colour).
CASES = [
    ((8, 8, 8), ALL_N3),
    ((7, 6, 9), ALL_N3),
    ((6, 7, 8), (("D", "D"), ("D", "D"), ("N", "N"))),
    ((6, 7, 9), (("N", "N"), ("D", "D"), ("D", "D"))),
    ((9, 7), (("N", "N"), ("N", "N"))),
    ((10, 12), (("D", "N"), ("N", "D"))),
    ((5, 4, 3, 7), (("N", "N"),) * 4),
]
NOT_ALL_N = [
    ((6, 7, 8), (("D", "D"), ("D", "D"), ("N", "N"))),
    ((6, 7, 9), (("N", "N"), ("D", "D"), ("D", "D"))),
    ((10, 12), (("D", "N"), ("N", "D"))),
    ((12, 14, 11), (("D", "D"), ("N", "N"), ("D", "N"))),
    ((22, 22, 22), (("D", "D"), ("N", "N"), ("D", "D"))),
    ((5, 6, 4), (("N", "D"), ("D", "N"), ("N", "N"))),
]
COMPONENT_BCS = tuple(
    tuple(("N", "N") if (2 - ax) == c else ("D", "D") for ax in range(3)) for c in range(3)
)
DTYPES = {"f32": (np.float32, torch.float32), "f64": (np.float64, torch.float64)}
DQ = np.array([0.9, 1.1, 1.3])


def _data(shape, seed, npdt=np.float32, n=2):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(npdt) for _ in range(n))


def _dq(shape, seed):
    return 0.5 + np.random.default_rng(seed).random(len(shape))


def _t(a):
    return torch.as_tensor(a)


def _all_neumann(bcs):
    return all(tuple(b) == ("N", "N") for b in bcs)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("shape,bcs", CASES)
def test_split_merge_equal_jax(shape, bcs, dt):
    npdt, _ = DTYPES[dt]
    (u,) = _data(shape, 0, npdt, 1)
    R, B = sc.split_colors(_t(u))
    Rj, Bj = jsc.split_colors(jnp.asarray(u))
    assert R.shape[-1] == (shape[-1] + 1) // 2
    assert np.array_equal(R.numpy(), np.asarray(Rj)) and np.array_equal(B.numpy(), np.asarray(Bj))
    back = sc.merge_colors(R, B, shape[-1])
    assert back.is_contiguous() and np.array_equal(back.numpy(), u)
    assert np.array_equal(back.numpy(), np.asarray(jsc.merge_colors(Rj, Bj, shape[-1])))
    assert sc.compact_supported(shape, bcs) == jsc.compact_supported(shape, bcs)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("shape,bcs", CASES)
def test_rb_sweep_compact_matches_jax(shape, bcs, dt):
    npdt, _ = DTYPES[dt]
    u, r = _data(shape, 1, npdt)
    dq = _dq(shape, 2)
    R, B = sc.split_colors(_t(u))
    rR, rB = sc.split_colors(_t(r))
    Rj, Bj = jsc.split_colors(jnp.asarray(u))
    rRj, rBj = jsc.split_colors(jnp.asarray(r))
    ulps = 3 if _all_neumann(bcs) else 2
    for sweep in (1, 2, 3):
        R, B = sc.rb_sweep_compact(R, B, rR, rB, dq, bcs, shape[-1])
        Rj, Bj = jsc.rb_sweep_compact(Rj, Bj, rRj, rBj, jnp.asarray(dq), bcs, shape[-1])
        assert R.dtype == _t(u).dtype
        for got, want in ((R, Rj), (B, Bj)):
            want = np.asarray(want)
            tol = sweep * ulps * float(np.spacing(npdt(np.abs(want).max())))
            assert np.abs(got.numpy() - want).max() <= tol


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("shape,bcs", NOT_ALL_N)
def test_compact_sweeps_equal_masked_sweeps_bitwise(shape, bcs, dt):
    npdt, _ = DTYPES[dt]
    u, r = _data(shape, 3, npdt)
    dq = _dq(shape, 4)
    R, B = sc.split_colors(_t(u))
    rR, rB = sc.split_colors(_t(r))
    want = _t(u)
    for _ in range(4):
        R, B = sc.rb_sweep_compact(R, B, rR, rB, dq, bcs, shape[-1])
        want = stencils.rb_sweep(want, _t(r), dq, bcs)
        assert torch.equal(sc.merge_colors(R, B, shape[-1]), want)
        if shape[-1] % 2:  # the ghosts mirror the row's last real entry
            rp = sc.row_parity(shape[:-1], "cpu")
            for half, par in ((R, rp), (B, 1 - rp)):
                ghost = (par == 1).expand(shape[:-1] + (1,))[..., 0]
                assert torch.equal(half[..., -1][ghost], half[..., -2][ghost])


def test_all_neumann_compact_sweep_close_to_masked():
    """All-Neumann: the mean is summed over the halves, so the merged sweep
    is within 2 ulp of the masked one, not bitwise."""
    shape = (7, 6, 9)
    u, r = _data(shape, 5, np.float64)
    dq = _dq(shape, 6)
    R, B = sc.split_colors(_t(u))
    rR, rB = sc.split_colors(_t(r))
    R, B = sc.rb_sweep_compact(R, B, rR, rB, dq, ALL_N3, 9)
    want = stencils.rb_sweep(_t(u), _t(r), dq, ALL_N3)
    got = sc.merge_colors(R, B, 9)
    assert float((got - want).abs().max()) <= 2 * float(np.spacing(float(want.abs().max())))
    assert abs(float(got.mean())) < 1e-15


PALLAS_CASES = [
    ((16, 16, 32), (("D", "D"), ("D", "D"), ("D", "D")), 1),
    ((12, 16, 32), (("D", "N"), ("N", "D"), ("D", "D")), 3),
    ((16, 24, 32), (("D", "D"), ("N", "N"), ("N", "D")), 5),
    ((16, 16, 32), (("D", "D"), ("D", "D"), ("D", "N")), 2),  # flips the first colour
]


@pytest.mark.parametrize("shape,bcs,ns", PALLAS_CASES)
def test_compact_smooth_matches_pallas_interpret(shape, bcs, ns):
    u, r = _data(shape, 7)
    call = pallas_compact.compact_smooth_3d(bcs, DQ, shape, ns, interpret=True)
    assert call is not None
    Rj, Bj = jsc.split_colors(jnp.asarray(u))
    rRj, rBj = jsc.split_colors(jnp.asarray(r))
    Rk, Bk = jax.jit(call)(Rj, Bj, rRj, rBj)
    R, B = compact.split_colors_3d(_t(u))
    rR, rB = compact.split_colors_3d(_t(r))
    got = compact.compact_smooth_3d(R, B, rR, rB, DQ, bcs, ns, shape[-1])
    for g, w in zip(got, (Rk, Bk)):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= ns * float(np.spacing(np.abs(w).max()))


@pytest.mark.parametrize("shape,ns", [((12, 10, 14), 1), ((7, 9, 11), 3), ((6, 5, 4), 2)])
def test_lane_form_equals_one_lane_calls(shape, ns):
    nx = shape[-1]
    u, r, c = (_t(a) for a in _data((3,) + shape, 8, n=3))
    R, B = compact.split_colors_3d(u)
    rR, rB = compact.split_colors_3d(r)
    Ro, Bo = compact.compact_smooth_3d_batched(R, B, rR, rB, DQ, COMPONENT_BCS, ns, nx)
    dense = compact.smooth_dense(u, r, DQ, COMPONENT_BCS, ns)
    dense_cor = compact.smooth_dense(u, r, DQ, COMPONENT_BCS, ns, c)
    dense_u, dense_r = compact.smooth_residual_dense(u, r, DQ, COMPONENT_BCS, ns)
    for b, bcs in enumerate(COMPONENT_BCS):
        Rb, Bb = sc.split_colors(u[b])
        assert torch.equal(R[b], Rb) and torch.equal(B[b], Bb)
        one = compact.compact_smooth_3d(R[b], B[b], rR[b], rB[b], DQ, bcs, ns, nx)
        assert torch.equal(Ro[b], one[0]) and torch.equal(Bo[b], one[1])
        # merged, the dense interface is the dense smoother of ops/zc.py
        assert torch.equal(dense[b], zc.zc_smooth_3d_plain(u[b], r[b], DQ, bcs, ns))
        assert torch.equal(dense[b], compact.smooth_dense(u[b], r[b], DQ, bcs, ns))
        assert torch.equal(dense_cor[b], zc.zc_smooth_cor_3d_plain(u[b], c[b], r[b], DQ, bcs, ns))
        wu, wr = zc.zc_smooth_residual_3d_plain(u[b], r[b], DQ, bcs, ns)
        assert torch.equal(dense_u[b], wu) and torch.equal(dense_r[b], wr)
        for g, w in zip(compact.smooth_residual_dense(u[b], r[b], DQ, bcs, ns), (wu, wr)):
            assert torch.equal(g, w)
    assert torch.equal(compact.merge_colors_3d(R, B, nx), u)


@pytest.mark.parametrize("active", [(True, True, False), (False, True, False),
                                    (False, False, False)])
def test_frozen_lanes(active):
    """A frozen lane comes back unchanged (the dense interface ignores its
    cor) with a zero residual; the active lanes equal the all-active call."""
    shape, ns = (10, 9, 7), 2
    u, r, c = (_t(a) for a in _data((3,) + shape, 9, n=3))
    R, B = compact.split_colors_3d(u)
    rR, rB = compact.split_colors_3d(r)
    full = compact.compact_smooth_3d_batched(R, B, rR, rB, DQ, COMPONENT_BCS, ns, 7)
    part = compact.compact_smooth_3d_batched(R, B, rR, rB, DQ, COMPONENT_BCS, ns, 7, active)
    d_full = compact.smooth_dense(u, r, DQ, COMPONENT_BCS, ns, c)
    d_part = compact.smooth_dense(u, r, DQ, COMPONENT_BCS, ns, c, active)
    r_full = compact.smooth_residual_dense(u, r, DQ, COMPONENT_BCS, ns)
    r_part = compact.smooth_residual_dense(u, r, DQ, COMPONENT_BCS, ns, active)
    Rc, Bc = compact.split_colors_3d(u, c, active)
    for b, on in enumerate(active):
        want = full if on else (R, B)
        assert torch.equal(part[0][b], want[0][b]) and torch.equal(part[1][b], want[1][b])
        assert torch.equal(d_part[b], d_full[b] if on else u[b])
        assert torch.equal(r_part[0][b], r_full[0][b] if on else u[b])
        assert torch.equal(r_part[1][b], r_full[1][b] if on else torch.zeros_like(u[b]))
        Rw, Bw = sc.split_colors(u[b] + c[b] if on else u[b])
        assert torch.equal(Rc[b], Rw) and torch.equal(Bc[b], Bw)


def test_wrappers_are_plain_on_cpu_and_functional():
    shape, ns, nx = (6, 7, 9), 2, 9
    u, r = (_t(a) for a in _data(shape, 10))
    R, B = compact.split_colors_3d(u)
    rR, rB = compact.split_colors_3d(r)
    keep = [t.clone() for t in (u, r, R, B, rR, rB)]
    fns = (compact.compact_smooth_3d, compact.compact_smooth_3d_batched,
           compact.split_colors_3d, compact.merge_colors_3d)
    before = [ops.launch_counts()[f.__name__] for f in fns]
    bcs = COMPONENT_BCS[1]
    for g, w in zip(compact.compact_smooth_3d(R, B, rR, rB, DQ, bcs, ns, nx),
                    compact.compact_smooth_3d_plain(R, B, rR, rB, DQ, bcs, ns, nx)):
        assert torch.equal(g, w)
    for g, w in zip(compact.compact_smooth_3d_batched(R[None], B[None], rR[None], rB[None], DQ,
                                                      (bcs,), ns, nx),
                    compact.compact_smooth_3d_batched_plain(R[None], B[None], rR[None],
                                                            rB[None], DQ, (bcs,), ns, nx)):
        assert torch.equal(g, w)
    for g, w in zip(compact.split_colors_3d(u, r), compact.split_colors_3d_plain(u, r)):
        assert torch.equal(g, w)
    assert torch.equal(compact.merge_colors_3d(R, B, nx), compact.merge_colors_3d_plain(R, B, nx))
    assert all(torch.equal(a, b) for a, b in zip(keep, (u, r, R, B, rR, rB)))
    assert before == [ops.launch_counts()[f.__name__] for f in fns]


def test_wrapper_input_checks():
    u = torch.zeros((3, 4, 5, 6))
    R, B = compact.split_colors_3d(u)
    bcs = COMPONENT_BCS
    with pytest.raises(TypeError):
        compact.compact_smooth_3d_batched(R.double(), B.double(), R.double(), B.double(), DQ,
                                          bcs, 1, 6)
    with pytest.raises(ValueError):  # one BC set per lane
        compact.compact_smooth_3d_batched(R, B, R, B, DQ, bcs[:2], 1, 6)
    with pytest.raises(ValueError):  # the lane form needs a lane axis, the one-lane form none
        compact.compact_smooth_3d_batched(R[0], B[0], R[0], B[0], DQ, bcs[:1], 1, 6)
    with pytest.raises(ValueError):
        compact.compact_smooth_3d(R, B, R, B, DQ, bcs[0], 1, 6)
    with pytest.raises(ValueError):  # halves that do not split nx
        compact.compact_smooth_3d(R[0], B[0], R[0], B[0], DQ, bcs[0], 1, 8)
    with pytest.raises(ValueError):  # all-Neumann problems need the mean smoother
        compact.compact_smooth_3d(R[0], B[0], R[0], B[0], DQ, ALL_N3, 1, 6)
    with pytest.raises(ValueError):
        compact.compact_smooth_3d(R[0], B[0], R[0], B[0], DQ, bcs[0], 0, 6)
    with pytest.raises(ValueError):
        compact.compact_smooth_3d_batched(R, B, R, B, DQ, bcs, 1, 6, active=(True, False))
    with pytest.raises(ValueError):  # nx >= 4
        compact.split_colors_3d(torch.zeros((4, 5, 3)))
    with pytest.raises(ValueError):
        compact.split_colors_3d(u, u[:, :, :, :5].contiguous())
    with pytest.raises(ValueError):
        compact.merge_colors_3d(R, B, 8)
    with pytest.raises(ValueError):  # at most MAX_LANES lanes
        compact.split_colors_3d(torch.zeros((9, 4, 5, 6)))
    with pytest.raises(ValueError):  # no silent route for an unsupported device
        compact.merge_colors_3d(R.to("meta"), B.to("meta"), 6)


def test_compact_wrappers_listed_with_the_kernels():
    from ndsm_tpu_torch.utils import profiling

    rows = {k[0]: k for k in ops.KERNELS}
    for name in ("compact_smooth_3d", "compact_smooth_3d_batched"):
        assert rows[name][3] == "ndsm_tpu/ops/pallas_compact.py:306"
        assert rows[name][4] == "ndsm_tpu_torch/csrc/compact_smooth.cu"
    assert rows["split_colors_3d"][1] is compact.split_colors_3d
    assert rows["merge_colors_3d"][2] is compact.merge_colors_3d_plain
    ops.reset_launch_counts()
    profiling.count(zc.LAUNCHES + "compact_smooth_3d", 3)
    assert ops.launch_counts()["compact_smooth_3d"] == 3
    ops.reset_launch_counts()
    assert ops.launch_counts()["compact_smooth_3d"] == 0
    assert set(ops.plain_cuda_counts()) >= {"compact_smooth_3d_plain", "split_colors_3d_plain"}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(23, 18, 21), (16, 12, 10)])
def test_cuda_compact_kernels_bitwise(shape):
    """On the card: the compact kernels, the split and the merge equal
    their plain versions bitwise (odd nx: ghosts included), all-active and
    with a frozen lane, and merged they equal the dense kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    nx = shape[-1]
    u, r, c = (_t(a).cuda() for a in _data((3,) + shape, 11, n=3))
    for act in (None, (True, True, False)):
        for g, w in zip(compact.split_colors_3d(u, c, act),
                        compact.split_colors_3d_plain(u, c, act)):
            assert torch.equal(g, w)
    R, B = compact.split_colors_3d(u)
    rR, rB = compact.split_colors_3d(r)
    assert torch.equal(compact.merge_colors_3d(R, B, nx), u)
    for ns in (1, 2, 5):
        for act in (None, (True, True, False)):
            for g, w in zip(
                    compact.compact_smooth_3d_batched(R, B, rR, rB, DQ, COMPONENT_BCS, ns, nx,
                                                      act),
                    compact.compact_smooth_3d_batched_plain(R, B, rR, rB, DQ, COMPONENT_BCS,
                                                            ns, nx, act)):
                assert torch.equal(g, w)
        for b, bcs in enumerate(COMPONENT_BCS):
            assert torch.equal(compact.smooth_dense(u[b], r[b], DQ, bcs, ns),
                               zc.zc_smooth_3d(u[b], r[b], DQ, bcs, ns))
