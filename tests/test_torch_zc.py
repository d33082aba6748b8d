"""ops/zc.py (the smoother kernels' module) against ndsm_tpu's Pallas
z-compact kernels, run in interpret mode on the CPU.

On the CPU the wrappers run their plain PyTorch versions; those are what
the CUDA kernels are held to bitwise on the card (the ``cuda``-marked
test below, and chip_smoke.py).

Tolerance: <= 1 ulp of max|u| per sweep against the interpreted Pallas
kernels and JAX's rb_sweep (XLA:CPU may contract multiply-adds; the plain
versions do not).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndsm_tpu.ops import pallas_zc, stencils as js
from ndsm_tpu_torch import ops
from ndsm_tpu_torch.ops import zc

torch.set_num_threads(1)

DQ = np.array([0.9, 1.1, 1.3])

# Shapes/BCs of tests/test_pallas_zc.py (the interpret-mode kernels need
# even nz and the TPU kernels exclude all-Neumann).
PALLAS_CASES = [
    ((16, 24, 32), (("N", "N"), ("D", "D"), ("N", "D")), 2),
    ((12, 16, 32), (("D", "N"), ("N", "D"), ("D", "D")), 3),
    ((16, 16, 32), (("D", "D"), ("D", "D"), ("D", "N")), 2),  # flips first color
    ((14, 16, 48), (("N", "D"), ("D", "N"), ("N", "N")), 5),
]

# Shapes no TPU kernel takes (odd extents, extent 2): the port's kernel
# does, so they are held against JAX's rb_sweep / poisson_residual.
ODD_CASES = [
    ((7, 9, 11), (("D", "D"), ("N", "N"), ("N", "D")), 3),
    ((5, 6, 3), (("N", "D"), ("D", "N"), ("D", "D")), 2),
    ((2, 5, 7), (("N", "N"), ("D", "D"), ("N", "N")), 1),
]


def _data(shape, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32) for _ in range(3))


def _tol(want, ns):
    return ns * float(np.spacing(np.abs(want).max()))


def _t(a):
    return torch.as_tensor(a)


@pytest.mark.parametrize("shape,bcs,ns", PALLAS_CASES)
def test_smooth_matches_pallas_interpret(shape, bcs, ns):
    u, r, _ = _data(shape, 0)
    want = np.asarray(jax.jit(pallas_zc.zc_smooth_3d(bcs, DQ, shape, ns, interpret=True))(
        jnp.asarray(u), jnp.asarray(r)))
    got = zc.zc_smooth_3d(_t(u), _t(r), DQ, bcs, ns).numpy()
    assert np.abs(got - want).max() <= _tol(want, ns)


@pytest.mark.parametrize("shape,bcs,ns", PALLAS_CASES)
def test_smooth_residual_matches_pallas_interpret(shape, bcs, ns):
    u, r, _ = _data(shape, 1)
    wu, wr = jax.jit(pallas_zc.zc_smooth_residual_3d(bcs, DQ, shape, ns, interpret=True))(
        jnp.asarray(u), jnp.asarray(r))
    gu, gr = zc.zc_smooth_residual_3d(_t(u), _t(r), DQ, bcs, ns)
    wu, wr = np.asarray(wu), np.asarray(wr)
    assert np.abs(gu.numpy() - wu).max() <= _tol(wu, ns)
    # the residual amplifies a 1-ulp iterate difference by up to 4*sum(w)
    assert np.abs(gr.numpy() - wr).max() <= _tol(wr, ns) + 4 * sum(1 / DQ**2) * _tol(wu, ns)


@pytest.mark.parametrize("shape,bcs,ns", PALLAS_CASES)
def test_smooth_cor_matches_pallas_interpret(shape, bcs, ns):
    u, r, c = _data(shape, 2)
    want = np.asarray(jax.jit(pallas_zc.zc_smooth_cor_3d(bcs, DQ, shape, ns, interpret=True))(
        jnp.asarray(u), jnp.asarray(c), jnp.asarray(r)))
    got = zc.zc_smooth_cor_3d(_t(u), _t(c), _t(r), DQ, bcs, ns).numpy()
    assert np.abs(got - want).max() <= _tol(want, ns)


@pytest.mark.parametrize("shape,bcs,ns", ODD_CASES + PALLAS_CASES[:1])
def test_any_shape_matches_jax_rb_sweep(shape, bcs, ns):
    u, r, c = _data(shape, 3)
    want = jnp.asarray(u)
    for _ in range(ns):
        want = js.rb_sweep(want, jnp.asarray(r), jnp.asarray(DQ), bcs)
    want_r = np.asarray(js.poisson_residual(want, jnp.asarray(r), jnp.asarray(DQ), bcs))
    want = np.asarray(want)
    got = zc.zc_smooth_3d(_t(u), _t(r), DQ, bcs, ns).numpy()
    assert np.abs(got - want).max() <= _tol(want, ns)
    gu, gr = zc.zc_smooth_residual_3d(_t(u), _t(r), DQ, bcs, ns)
    assert np.abs(gr.numpy() - want_r).max() <= _tol(want_r, ns) + 4 * sum(1 / DQ**2) * _tol(want, ns)
    want_c = jnp.asarray(u + c)
    for _ in range(ns):
        want_c = js.rb_sweep(want_c, jnp.asarray(r), jnp.asarray(DQ), bcs)
    got_c = zc.zc_smooth_cor_3d(_t(u), _t(c), _t(r), DQ, bcs, ns).numpy()
    assert np.abs(got_c - np.asarray(want_c)).max() <= _tol(np.asarray(want_c), ns)


def test_wrappers_are_plain_on_cpu_and_functional():
    """On a CPU tensor each wrapper IS its plain version (bitwise), counts
    no launch, and leaves its inputs untouched."""
    shape, bcs, ns = (6, 7, 8), (("D", "D"), ("N", "N"), ("D", "N")), 2
    u, r, c = (_t(a) for a in _data(shape, 4))
    u0 = u.clone()
    before = tuple(ops.launch_counts()[k] for k in ("zc_smooth_3d", "zc_smooth_residual_3d",
                                                    "zc_smooth_cor_3d"))
    assert torch.equal(zc.zc_smooth_3d(u, r, DQ, bcs, ns), zc.zc_smooth_3d_plain(u, r, DQ, bcs, ns))
    for a, b in zip(zc.zc_smooth_residual_3d(u, r, DQ, bcs, ns),
                    zc.zc_smooth_residual_3d_plain(u, r, DQ, bcs, ns)):
        assert torch.equal(a, b)
    assert torch.equal(zc.zc_smooth_cor_3d(u, c, r, DQ, bcs, ns),
                       zc.zc_smooth_cor_3d_plain(u, c, r, DQ, bcs, ns))
    assert torch.equal(u, u0)
    assert before == tuple(ops.launch_counts()[k] for k in (
        "zc_smooth_3d", "zc_smooth_residual_3d", "zc_smooth_cor_3d"))


def test_wrapper_input_checks():
    bcs = (("D", "D"), ("N", "N"), ("D", "N"))
    u = torch.zeros((4, 5, 6))
    with pytest.raises(TypeError):
        zc.zc_smooth_3d(u.double(), u.double(), DQ, bcs, 1)
    with pytest.raises(ValueError):
        zc.zc_smooth_3d(u, torch.zeros((4, 5, 7)), DQ, bcs, 1)
    with pytest.raises(ValueError):
        zc.zc_smooth_3d(u.transpose(0, 2), u.transpose(0, 2), DQ, bcs, 1)
    with pytest.raises(ValueError):
        zc.zc_smooth_3d(u, u, DQ, (("N", "N"),) * 3, 1)
    with pytest.raises(ValueError):
        zc.zc_smooth_3d(u, u, DQ, bcs, 0)
    with pytest.raises(ValueError):  # no silent route for an unsupported device
        zc.zc_smooth_3d(u.to("meta"), u.to("meta"), DQ, bcs, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("bcs", [
    (("D", "D"), ("D", "D"), ("N", "N")),
    (("D", "D"), ("N", "N"), ("D", "D")),
    (("N", "N"), ("D", "D"), ("D", "D")),
])
def test_cuda_kernels_bitwise_plain(bcs):
    """On the card: every smoother kernel equals its plain version bitwise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    shape = (23, 18, 21)
    u, r, c = (_t(a).cuda() for a in _data(shape, 5))
    for ns in (1, 2, 5):
        assert torch.equal(zc.zc_smooth_3d(u, r, DQ, bcs, ns), zc.zc_smooth_3d_plain(u, r, DQ, bcs, ns))
        for a, b in zip(zc.zc_smooth_residual_3d(u, r, DQ, bcs, ns),
                        zc.zc_smooth_residual_3d_plain(u, r, DQ, bcs, ns)):
            assert torch.equal(a, b)
        assert torch.equal(zc.zc_smooth_cor_3d(u, c, r, DQ, bcs, ns),
                           zc.zc_smooth_cor_3d_plain(u, c, r, DQ, bcs, ns))
