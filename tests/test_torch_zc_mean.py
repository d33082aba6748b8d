"""ops/zc.py:zc_smooth_mean_3d (the all-Neumann 3D smoother) and the 3D
all-Neumann route through the port's engine, against ndsm_tpu's Pallas
``zc_smooth_mean_3d`` passes run in interpret mode on the CPU, composed as
tests/test_zc_mean.py and the JAX engine's ``_t_smooth_zc_mean`` compose
them (sweep on u - m, per-window sums, m = f32(sum / f32(N)), final u - m).

On the CPU the wrapper runs its plain PyTorch version; that is what the
CUDA kernels are held to bitwise on the card (the ``cuda``-marked test
below, and chip_smoke.py).

Tolerances:
  * against the composed JAX passes: <= 4 ulp of max|u| per sweep (XLA:CPU
    may contract multiply-adds, and the global sum is taken in another
    order; measured: at most 2.0 ulp per sweep on these cases, at ns = 1);
  * engine level: cycles within +-1 and u within 1e-9 of max(|u|, 1) (both
    stop at the vc_tol = 1e-10 contract).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ndsm_tpu
import ndsm_tpu_torch
from ndsm_tpu.mg import poisson as jpoisson
from ndsm_tpu.ops import pallas_zc
from ndsm_tpu_torch.ops import stencils, zc

torch.set_num_threads(1)

ALL_N = (("N", "N"),) * 3
DQ = np.array([0.9, 1.1, 0.8])


def _data(shape, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32) for _ in range(2))


def _jax_composed(u, r, shape, nsweeps):
    """The JAX engine's composition of the single-sweep mean passes."""
    f = jax.jit(pallas_zc.zc_smooth_mean_3d(ALL_N, DQ, shape, interpret=True))
    N = float(np.prod(shape))
    sub = jnp.zeros((8, 128), jnp.float32)
    v, m = jnp.asarray(u), jnp.float32(0.0)
    for _ in range(nsweeps):
        v, sums = f(v, jnp.asarray(r), sub)
        m = (jnp.sum(sums) / jnp.float32(N)).astype(jnp.float32)
        sub = jnp.zeros((8, 128), jnp.float32) + m
    return np.asarray(v - m)


@pytest.mark.parametrize("nsweeps", [1, 3, 5])
@pytest.mark.parametrize("shape", [(16, 24, 128), (32, 16, 256)])
def test_matches_composed_pallas_passes(shape, nsweeps):
    u, r = _data(shape, 0)
    want = _jax_composed(u, r, shape, nsweeps)
    got = zc.zc_smooth_mean_3d(torch.as_tensor(u), torch.as_tensor(r), DQ, ALL_N,
                               nsweeps).numpy()
    ulps = float(np.abs(got - want).max()) / float(np.spacing(np.abs(want).max()))
    assert ulps <= 4 * nsweeps
    assert abs(float(got.astype(np.float64).mean())) < 1e-6 * float(np.abs(want).max())


def test_plain_is_sweep_then_mean_and_functional():
    """Each sweep is red_black followed by u - f32(sum / f32(N)), the sum in
    the kernels' order; odd shapes are taken; inputs stay untouched and no
    launch is counted on the CPU."""
    from ndsm_tpu_torch.ops.reduce import strided_block_sum

    shape = (7, 9, 11)
    u, r = (torch.as_tensor(a) for a in _data(shape, 1))
    u0 = u.clone()
    before = zc.zc_smooth_mean_3d.launches
    want = u
    for _ in range(3):
        want = stencils.red_black(want, r, DQ, ALL_N)
        total = strided_block_sum(strided_block_sum(want.reshape(-1), zc.mean_blocks(want.numel())))
        want = want - total[0] / torch.tensor(float(np.float32(want.numel())))
    assert torch.equal(zc.zc_smooth_mean_3d(u, r, DQ, ALL_N, 3), want)
    assert torch.equal(zc.zc_smooth_mean_3d_plain(u, r, DQ, ALL_N, 3), want)
    assert torch.equal(u, u0)
    assert zc.zc_smooth_mean_3d.launches == before


def test_wrapper_input_checks():
    u = torch.zeros((4, 5, 6))
    with pytest.raises(ValueError):  # all-Neumann only
        zc.zc_smooth_mean_3d(u, u, DQ, (("D", "D"), ("N", "N"), ("N", "N")), 1)
    with pytest.raises(ValueError):  # and the other smoothers exclude it
        zc.zc_smooth_3d(u, u, DQ, ALL_N, 1)
    with pytest.raises(TypeError):
        zc.zc_smooth_mean_3d(u.double(), u.double(), DQ, ALL_N, 1)
    with pytest.raises(ValueError):
        zc.zc_smooth_mean_3d(u, u, DQ, ALL_N, 0)
    with pytest.raises(ValueError):
        zc.zc_smooth_mean_3d(u.to("meta"), u.to("meta"), DQ, ALL_N, 1)


def test_all_neumann_solve_matches_jax_kernel(monkeypatch):
    """The mixed solve of tests/test_zc_mean.py, JAX with its kernel passes
    (interpret mode), the port through zc_smooth_mean_3d's plain version."""
    monkeypatch.setenv("NDSM_TPU_PALLAS", "interpret")
    monkeypatch.setenv("NDSM_TPU_PALLAS_MIN_POINTS", "0")
    meshes = (np.linspace(0, 1, 24), np.linspace(0, 1.1, 16), np.linspace(0, 0.9, 32))
    shape = (24, 16, 32)
    rng = np.random.default_rng(0)
    rhs = rng.standard_normal(shape)
    rhs -= rhs.mean()
    jpoisson._ENGINE_CACHE.clear()
    try:
        uj, ij = ndsm_tpu.PoissonBVP(ndsm_tpu.GridHierarchy.from_mesh(meshes), ALL_N,
                                     ndsm_tpu.Options(precision="mixed")).solve(
            np.zeros(shape), rhs)
    finally:
        jpoisson._ENGINE_CACHE.clear()
    bt = ndsm_tpu_torch.PoissonBVP(ndsm_tpu_torch.GridHierarchy.from_mesh(meshes), ALL_N,
                                   ndsm_tpu_torch.Options(precision="mixed"), device="cpu")
    assert bt._inner.kernel_route == "zc_mean" and not bt.df_defect
    ut, it = bt.solve(np.zeros(shape), rhs)
    assert ij.ierr == it.ierr == 0
    assert abs(ij.cycles - it.cycles) <= 1
    uj = np.asarray(uj)
    assert np.abs(ut.numpy() - uj).max() < 1e-9 * max(np.abs(uj).max(), 1.0)


@pytest.mark.cuda
def test_cuda_kernel_bitwise_plain():
    """On the card: the mean smoother equals its plain version bitwise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for shape in ((23, 18, 21), (64, 48, 80)):
        u, r = (torch.as_tensor(a).cuda() for a in _data(shape, 5))
        for ns in (1, 2, 5):
            assert torch.equal(zc.zc_smooth_mean_3d(u, r, DQ, ALL_N, ns),
                               zc.zc_smooth_mean_3d_plain(u, r, DQ, ALL_N, ns))
