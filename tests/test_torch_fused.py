"""ops/fused.py (the lane-batched smoother kernels' module) against
ndsm_tpu's Pallas fused smoother, run in interpret mode on the CPU.

On the CPU the wrappers run their plain PyTorch versions; those are what
the CUDA kernels are held to bitwise on the card (the ``cuda``-marked tests
below, and chip_smoke.py).

Tolerances:
  * the plain lane smoother against JAX's interpreted
    ``fused_smooth_3d_batched`` (mask codes stacked per lane) and the
    one-lane form against ``fused_smooth_3d``: <= 1 ulp of max|u| per
    sweep (XLA:CPU may contract multiply-adds; the plain versions do not);
  * the lane residual and correction forms against per-lane ops/zc.py
    plain versions: bitwise (same expressions, per-lane slices);
  * frozen lanes: bitwise unchanged, and the active lanes bitwise equal to
    the all-active call.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndsm_tpu.ops import pallas_fused, stencils as js
from ndsm_tpu_torch.ops import fused, zc

torch.set_num_threads(1)

DQ = np.array([0.9, 1.1, 1.0])

COMPONENT_BCS = tuple(
    tuple(("N", "N") if (2 - ax) == c else ("D", "D") for ax in range(3)) for c in range(3)
)
MIXED_BCS = ((("D", "N"), ("N", "D"), ("D", "D")), (("N", "D"), ("D", "N"), ("N", "N")))

# Shapes of tests/test_pallas.py (the interpret-mode kernel still needs
# pick_tiles: ny >= 40 for ns = 5).
PALLAS_CASES = [
    ((32, 32, 32), COMPONENT_BCS, 1),
    ((24, 32, 20), COMPONENT_BCS, 2),
    ((24, 24, 24), MIXED_BCS, 3),
    ((40, 40, 17), COMPONENT_BCS, 5),
]


def _data(shape, seed, n=3):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32) for _ in range(n))


def _tol(want, ns):
    return ns * float(np.spacing(np.abs(want).max()))


def _t(a):
    return torch.as_tensor(a)


@pytest.mark.parametrize("shape,bcs_list,ns", PALLAS_CASES)
def test_lane_smoother_matches_pallas_interpret(shape, bcs_list, ns):
    B = len(bcs_list)
    u, r = _data((B,) + shape, 0, 2)
    C = np.stack([pallas_fused.mask_code(shape, b) for b in bcs_list])
    call = pallas_fused.fused_smooth_3d_batched(bcs_list, DQ, shape, ns, interpret=True)
    want = np.asarray(jax.jit(call)(jnp.asarray(u), jnp.asarray(r), jnp.asarray(C)))
    got = fused.fused_smooth_3d_batched(_t(u), _t(r), DQ, bcs_list, ns).numpy()
    assert np.abs(got - want).max() <= _tol(want, ns)


@pytest.mark.parametrize("shape,bcs_list,ns", PALLAS_CASES)
def test_one_lane_matches_pallas_interpret(shape, bcs_list, ns):
    bcs = bcs_list[-1]
    u, r = _data(shape, 1, 2)
    f = pallas_fused.fused_smooth_3d(bcs, DQ, shape, ns, interpret=True)
    want = np.asarray(f(jnp.asarray(u), jnp.asarray(r)))
    got = fused.fused_smooth_3d(_t(u), _t(r), DQ, bcs, ns).numpy()
    assert np.abs(got - want).max() <= _tol(want, ns)
    # the shapes no TPU kernel takes (odd nz): against JAX's rb_sweep
    odd = (shape[0] + 1,) + shape[1:]
    u, r = _data(odd, 2, 2)
    want = jnp.asarray(u)
    for _ in range(ns):
        want = js.rb_sweep(want, jnp.asarray(r), jnp.asarray(DQ), bcs)
    want = np.asarray(want)
    got = fused.fused_smooth_3d(_t(u), _t(r), DQ, bcs, ns).numpy()
    assert np.abs(got - want).max() <= _tol(want, ns)


@pytest.mark.parametrize("shape,ns", [((12, 10, 14), 1), ((7, 9, 11), 3), ((6, 5, 2), 2)])
def test_lane_forms_equal_per_lane_zc(shape, ns):
    """Lane b of every form is the ops/zc.py call on lane b, bit for bit."""
    bcs_list = COMPONENT_BCS + MIXED_BCS
    B = len(bcs_list)
    u, r, c = (_t(a) for a in _data((B,) + shape, 3))
    su = fused.fused_smooth_3d_batched(u, r, DQ, bcs_list, ns)
    ru, rr = fused.fused_smooth_residual_3d_batched(u, r, DQ, bcs_list, ns)
    cu = fused.fused_smooth_cor_3d_batched(u, c, r, DQ, bcs_list, ns)
    for b, bcs in enumerate(bcs_list):
        assert torch.equal(su[b], zc.zc_smooth_3d_plain(u[b], r[b], DQ, bcs, ns))
        wu, wr = zc.zc_smooth_residual_3d_plain(u[b], r[b], DQ, bcs, ns)
        assert torch.equal(ru[b], wu) and torch.equal(rr[b], wr)
        assert torch.equal(cu[b], zc.zc_smooth_cor_3d_plain(u[b], c[b], r[b], DQ, bcs, ns))
        assert torch.equal(fused.fused_smooth_3d(u[b], r[b], DQ, bcs, ns), su[b])


@pytest.mark.parametrize("active", [(True, True, False), (False, True, False),
                                    (False, False, False)])
def test_frozen_lanes(active):
    """A frozen lane comes back unchanged (the correction form ignores its
    cor) with a zero residual; the active lanes equal the all-active call."""
    shape, ns = (10, 9, 8), 2
    u, r, c = (_t(a) for a in _data((3,) + shape, 4))
    full = (fused.fused_smooth_3d_batched(u, r, DQ, COMPONENT_BCS, ns),
            fused.fused_smooth_residual_3d_batched(u, r, DQ, COMPONENT_BCS, ns),
            fused.fused_smooth_cor_3d_batched(u, c, r, DQ, COMPONENT_BCS, ns))
    part = (fused.fused_smooth_3d_batched(u, r, DQ, COMPONENT_BCS, ns, active),
            fused.fused_smooth_residual_3d_batched(u, r, DQ, COMPONENT_BCS, ns, active),
            fused.fused_smooth_cor_3d_batched(u, c, r, DQ, COMPONENT_BCS, ns, active))
    for b, on in enumerate(active):
        if on:
            assert torch.equal(part[0][b], full[0][b])
            assert torch.equal(part[1][0][b], full[1][0][b])
            assert torch.equal(part[1][1][b], full[1][1][b])
            assert torch.equal(part[2][b], full[2][b])
        else:
            for got in (part[0][b], part[1][0][b], part[2][b]):
                assert torch.equal(got, u[b])
            assert not part[1][1][b].any()


def test_wrappers_are_plain_on_cpu_and_functional():
    shape, ns = (6, 7, 8), 2
    u, r, c = (_t(a) for a in _data((3,) + shape, 5))
    u0 = u.clone()
    before = {f.__name__: f.launches for f in (
        fused.fused_smooth_3d_batched, fused.fused_smooth_residual_3d_batched,
        fused.fused_smooth_cor_3d_batched, fused.fused_smooth_3d)}
    assert torch.equal(fused.fused_smooth_3d_batched(u, r, DQ, COMPONENT_BCS, ns),
                       fused.fused_smooth_3d_batched_plain(u, r, DQ, COMPONENT_BCS, ns))
    for a, b in zip(fused.fused_smooth_residual_3d_batched(u, r, DQ, COMPONENT_BCS, ns),
                    fused.fused_smooth_residual_3d_batched_plain(u, r, DQ, COMPONENT_BCS, ns)):
        assert torch.equal(a, b)
    assert torch.equal(fused.fused_smooth_cor_3d_batched(u, c, r, DQ, COMPONENT_BCS, ns),
                       fused.fused_smooth_cor_3d_batched_plain(u, c, r, DQ, COMPONENT_BCS, ns))
    assert torch.equal(fused.fused_smooth_3d(u[0], r[0], DQ, COMPONENT_BCS[0], ns),
                       fused.fused_smooth_3d_plain(u[0], r[0], DQ, COMPONENT_BCS[0], ns))
    assert torch.equal(u, u0)
    assert before == {f.__name__: f.launches for f in (
        fused.fused_smooth_3d_batched, fused.fused_smooth_residual_3d_batched,
        fused.fused_smooth_cor_3d_batched, fused.fused_smooth_3d)}


def test_wrapper_input_checks():
    u = torch.zeros((3, 4, 5, 6))
    bcs = COMPONENT_BCS
    with pytest.raises(TypeError):
        fused.fused_smooth_3d_batched(u.double(), u.double(), DQ, bcs, 1)
    with pytest.raises(ValueError):  # one BC set per lane
        fused.fused_smooth_3d_batched(u, u, DQ, bcs[:2], 1)
    with pytest.raises(ValueError):  # a lane axis is required
        fused.fused_smooth_3d_batched(u[0], u[0], DQ, bcs[:1], 1)
    with pytest.raises(ValueError):  # at most MAX_LANES lanes
        big = torch.zeros((9, 4, 5, 6))
        fused.fused_smooth_3d_batched(big, big, DQ, bcs[:1] * 9, 1)
    with pytest.raises(ValueError):  # all-Neumann lanes need the mean smoother
        fused.fused_smooth_3d_batched(u, u, DQ, bcs[:2] + ((("N", "N"),) * 3,), 1)
    with pytest.raises(ValueError):
        fused.fused_smooth_3d_batched(u, u, DQ, bcs, 0)
    with pytest.raises(ValueError):
        fused.fused_smooth_3d_batched(u, u, DQ, bcs, 1, active=(True, False))
    with pytest.raises(ValueError):
        fused.fused_smooth_cor_3d_batched(u, u[:, :, :, :5].contiguous(), u, DQ, bcs, 1)
    with pytest.raises(ValueError):  # no silent route for an unsupported device
        fused.fused_smooth_3d(u[0].to("meta"), u[0].to("meta"), DQ, bcs[0], 1)


def test_one_lane_form_is_the_zc_wrapper():
    """fused_smooth_3d is ops/zc.py's zc_smooth_3d (both are the one-lane
    call of the lane kernels), so the two names share one launch counter."""
    from ndsm_tpu_torch import ops

    assert fused.fused_smooth_3d is zc.zc_smooth_3d
    assert fused.fused_smooth_3d_plain is zc.zc_smooth_3d_plain
    zc.zc_smooth_3d.launches = 5
    counts = ops.launch_counts()
    ops.reset_launch_counts()
    assert counts["fused_smooth_3d"] == counts["zc_smooth_3d"] == 5
    assert ops.launch_counts()["fused_smooth_3d"] == 0
    names = [k[0] for k in ops.KERNELS]
    assert len(names) == len(set(names))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(23, 18, 21), (16, 12, 10)])
def test_cuda_lane_kernels_bitwise(shape):
    """On the card: the lane kernels equal their plain versions and the
    per-lane zc kernels bitwise, all-active and with a frozen lane."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    u, r, c = (_t(a).cuda() for a in _data((3,) + shape, 7))
    for ns in (1, 2, 5):
        for act in (None, (True, True, False)):
            assert torch.equal(
                fused.fused_smooth_3d_batched(u, r, DQ, COMPONENT_BCS, ns, act),
                fused.fused_smooth_3d_batched_plain(u, r, DQ, COMPONENT_BCS, ns, act))
            for a, b in zip(
                    fused.fused_smooth_residual_3d_batched(u, r, DQ, COMPONENT_BCS, ns, act),
                    fused.fused_smooth_residual_3d_batched_plain(u, r, DQ, COMPONENT_BCS, ns,
                                                                 act)):
                assert torch.equal(a, b)
            assert torch.equal(
                fused.fused_smooth_cor_3d_batched(u, c, r, DQ, COMPONENT_BCS, ns, act),
                fused.fused_smooth_cor_3d_batched_plain(u, c, r, DQ, COMPONENT_BCS, ns, act))
        su = fused.fused_smooth_3d_batched(u, r, DQ, COMPONENT_BCS, ns)
        for b, bcs in enumerate(COMPONENT_BCS):
            assert torch.equal(su[b], zc.zc_smooth_3d(u[b], r[b], DQ, bcs, ns))
