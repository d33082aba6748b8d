"""ops/df.py (the outer-defect kernel's module) against ndsm_tpu.

On the CPU the wrapper runs its plain float64 version, which the CUDA
kernel reproduces bitwise on the card (the ``cuda``-marked test below,
and chip_smoke.py).

Tolerances:
  * against JAX's float64 ``poisson_residual`` cast to float32: <= 1 ulp
    of float32 (the f64 residuals agree to ~1e-16 relative, so the casts
    differ by at most one rounding step);
  * against the double-float Pallas kernel in interpret mode
    (``df_residual_3d``, fed ``df_decompose(u)``): <= 1e-12 of the
    stencil-term scale — the pair format's own accuracy (~2^-48) — plus
    one float32 rounding of r where r is not small.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndsm_tpu.ops import pallas_df as jdf, stencils as js
from ndsm_tpu_torch.ops import df

torch.set_num_threads(1)

BCS = [
    (("N", "N"), ("N", "N"), ("D", "D")),
    (("D", "N"), ("N", "D"), ("N", "N")),
    (("D", "D"), ("N", "N"), ("N", "D")),
]


def _case(n, seed=0):
    """Near-converged iterate (the regime the defect pass exists for):
    rhs := L(u), then u perturbed, so r is ~1e-9 of the term scale."""
    rng = np.random.default_rng(seed)
    x = np.linspace(0.0, 1.0, n)
    dq = np.array([x[1] - x[0]] * 3)
    z, y, xx = np.meshgrid(x, x, x, indexing="ij")
    u = np.sin(2.1 * z + 0.3) * np.cos(1.7 * y) * np.sin(2.9 * xx + 1.1)
    return u + 1e-8 * rng.standard_normal((n, n, n)), dq


def _rhs(u, dq, bcs):
    n = u.shape
    return -np.asarray(js.poisson_residual(jnp.asarray(u), jnp.zeros(n), jnp.asarray(dq), bcs))


@pytest.mark.parametrize("bcs", BCS)
def test_matches_jax_f64_residual(bcs):
    # (a) r of the size of the stencil terms: the casts agree to 1 ulp
    rng = np.random.default_rng(1)
    dq = np.array([0.9, 1.1, 1.3])
    u, rhs = rng.standard_normal((2, 9, 10, 11))
    r32, mx, u_out = df.df_residual_3d(torch.as_tensor(u), torch.as_tensor(rhs), None, dq, bcs)
    want = np.asarray(js.poisson_residual(jnp.asarray(u), jnp.asarray(rhs), jnp.asarray(dq), bcs))
    want32 = want.astype(np.float32)
    assert r32.dtype == torch.float32
    assert np.all(np.abs(r32.numpy() - want32) <= np.spacing(np.abs(want32)))
    assert float(mx) == float(torch.abs(r32).max())
    assert torch.equal(u_out, torch.as_tensor(u))
    # (b) the cancellation regime: r ~ 1e-9 of the terms; both f64
    # residuals carry ~1e-16 of the term scale, then one f32 rounding
    u, dq = _case(14, seed=1)
    rhs = _rhs(u, dq, bcs)
    u = u * (1 + 1e-9) + 1e-9
    r32, _, _ = df.df_residual_3d(torch.as_tensor(u), torch.as_tensor(rhs), None, dq, bcs)
    want = np.asarray(js.poisson_residual(jnp.asarray(u), jnp.asarray(rhs), jnp.asarray(dq), bcs))
    term = 2 * 3 * np.abs(u).max() / dq[0] ** 2
    assert np.all(np.abs(r32.numpy() - want) <= np.spacing(np.abs(want).astype(np.float32)) + 1e-15 * term)


@pytest.mark.parametrize("bcs", BCS)
def test_matches_pallas_df_interpret(bcs):
    n = 16
    u, dq = _case(n, seed=2)
    rhs = _rhs(u, dq, bcs)
    u = u * (1 + 1e-9) + 1e-9
    uh, ul = jdf.df_decompose(jnp.asarray(u))
    rh, rl = jdf.df_decompose(jnp.asarray(rhs))
    r_j, m_j = jdf.df_residual_3d(bcs, dq, (n, n, n), interpret=True)(uh, ul, rh, rl)
    r_t, m_t, _ = df.df_residual_3d(torch.as_tensor(u), torch.as_tensor(rhs), None, dq, bcs)
    scale = float(np.abs(rhs).max())
    assert np.abs(r_t.numpy().astype(np.float64) - np.asarray(r_j, np.float64)).max() < 1e-12 * scale
    assert abs(float(m_t) - float(jnp.max(m_j))) < 1e-12 * scale
    # zero-rhs form against the Pallas zero-rhs kernel
    rz_j, _ = jdf.df_residual_3d(bcs, dq, (n, n, n), zero_rhs=True, interpret=True)(uh, ul)
    rz_t, _, _ = df.df_residual_3d(torch.as_tensor(u), None, None, dq, bcs)
    term = 2 * 3 * np.abs(u).max() / dq[0] ** 2
    rz_j = np.asarray(rz_j)
    assert np.all(np.abs(rz_t.numpy() - rz_j) <= np.spacing(np.abs(rz_j)) + 1e-12 * term)


def test_update_variant_matches_pallas_update():
    """The update form applies u <- u + e before the stencil: its residual
    and updated iterate match the Pallas update kernel (pair precision)."""
    n = 16
    bcs = BCS[2]
    u, dq = _case(n, seed=3)
    rng = np.random.default_rng(8)
    e = (1e-7 * rng.standard_normal((n, n, n))).astype(np.float32)
    uh, ul = jdf.df_decompose(jnp.asarray(u))
    r_j, m_j, uh2, ul2 = jdf.df_residual_3d(bcs, dq, (n, n, n), zero_rhs=True, interpret=True,
                                            update=True)(uh, ul, jnp.asarray(e))
    r_t, m_t, u_t = df.df_residual_3d(torch.as_tensor(u), None, torch.as_tensor(e), dq, bcs)
    u_j = np.asarray(jdf.df_reconstruct(uh2, ul2))
    assert np.abs(u_t.numpy() - u_j).max() <= 4e-15 * np.abs(u_j).max()
    assert np.array_equal(u_t.numpy(), u + e.astype(np.float64))
    term = 2 * 3 * np.abs(u).max() / dq[0] ** 2
    r_j = np.asarray(r_j)
    assert np.all(np.abs(r_t.numpy() - r_j) <= np.spacing(np.abs(r_j)) + 1e-12 * term)
    # update form == plain add, then the plain defect (bitwise)
    r2, m2, _ = df.df_residual_3d(u_t, None, None, dq, bcs)
    assert torch.equal(r_t, r2) and float(m_t) == float(m2)


def test_zero_rhs_equals_zero_tensor_and_inputs_untouched():
    u, dq = _case(9, seed=4)
    bcs = BCS[1]
    ut = torch.as_tensor(u)
    e = torch.full(ut.shape, 1e-3, dtype=torch.float32)
    u0 = ut.clone()
    a = df.df_residual_3d(ut, None, e, dq, bcs)
    b = df.df_residual_3d(ut, torch.zeros_like(ut), e, dq, bcs)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert torch.equal(ut, u0)
    with pytest.raises(TypeError):
        df.df_residual_3d(ut.float(), None, None, dq, bcs)
    with pytest.raises(ValueError):
        df.df_residual_3d(ut, None, e[:-1].contiguous(), dq, bcs)


@pytest.mark.cuda
@pytest.mark.parametrize("bcs", BCS)
def test_cuda_defect_bitwise_plain(bcs):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    u, dq = _case(19, seed=5)
    rng = np.random.default_rng(9)
    ut = torch.as_tensor(u).cuda()
    rhs = torch.as_tensor(rng.standard_normal(u.shape)).cuda()
    e = torch.as_tensor(1e-5 * rng.standard_normal(u.shape), dtype=torch.float32).cuda()
    for r_, e_ in ((None, None), (rhs, None), (None, e), (rhs, e)):
        for a, b in zip(df.df_residual_3d(ut, r_, e_, dq, bcs),
                        df.df_residual_3d_plain(ut, r_, e_, dq, bcs)):
            assert torch.equal(a, b)
