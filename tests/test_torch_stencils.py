"""Port's plain-torch ops (ops/stencils, ops/reduce, ops/transfer,
ops/deriv) against ndsm_tpu on identical numpy inputs.

Tolerances:
  * float64 sweeps/residuals: <= 1e-15 of the field scale (XLA:CPU may
    fuse a multiply-add where torch rounds twice);
  * float32 sweeps: <= 1 ulp of max|u| per sweep, for the same reason
    (XLA:CPU may contract to FMA; ROADMAP.md Queue C);
  * transfers: 1e-14 relative (f64 matmul summation order);
  * curl/derivatives: 1e-14 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndsm_tpu.ops import deriv as jderiv, reduce as jreduce, stencils as js, transfer as jtr
from ndsm_tpu_torch.ops import deriv as tderiv, reduce as treduce, stencils as ts, transfer as ttr

torch.set_num_threads(1)

CASES = [
    ((9, 10, 11), (("D", "D"), ("N", "N"), ("N", "D"))),
    ((8, 12, 10), (("N", "D"), ("D", "N"), ("D", "D"))),   # x-lower D: first color flips
    ((7, 6, 5), (("N", "N"), ("D", "D"), ("N", "N"))),
    ((12, 14), (("N", "N"), ("N", "N"))),                    # 2D all-Neumann: mean each sweep
    ((11, 9), (("D", "N"), ("N", "D"))),
    ((6, 5, 4, 7), (("D", "N"), ("N", "N"), ("N", "D"), ("D", "D"))),
]


def _data(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal(shape).astype(dtype)
    r = rng.standard_normal(shape).astype(dtype)
    dq = np.array([0.9, 1.1, 1.3, 0.7][: len(shape)])
    return u, r, dq


def _ulp(a):
    return float(np.spacing(np.abs(a).max()))


def test_weights_and_parity():
    for dq in ([0.9, 1.1, 1.3], [1 / 219] * 3, [0.05, 0.04]):
        for tdt, jdt in ((torch.float32, jnp.float32), (torch.float64, jnp.float64)):
            w, w0 = ts.stencil_weights(dq, tdt)
            jw, jw0 = js.stencil_weights(np.asarray(dq), jdt)
            assert w == tuple(float(v) for v in np.asarray(jw)) and w0 == float(jw0)
    for _, bcs in CASES:
        assert ts.first_color_parity(bcs) == js.first_color_parity(bcs)
        assert ts.is_all_neumann(bcs) == js.is_all_neumann(bcs)


@pytest.mark.parametrize("shape,bcs", CASES)
def test_rb_sweep_f64(shape, bcs):
    u, r, dq = _data(shape, np.float64)
    got, want = torch.as_tensor(u), jnp.asarray(u)
    for _ in range(3):
        got = ts.rb_sweep(got, torch.as_tensor(r), dq, bcs)
        want = js.rb_sweep(want, jnp.asarray(r), jnp.asarray(dq), bcs)
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() <= 1e-15 * np.abs(want).max() * 3


@pytest.mark.parametrize("shape,bcs", CASES)
def test_rb_sweep_f32(shape, bcs):
    u, r, dq = _data(shape, np.float32, seed=1)
    ns = 4
    got, want = torch.as_tensor(u), jnp.asarray(u)
    for _ in range(ns):
        got = ts.rb_sweep(got, torch.as_tensor(r), dq, bcs)
        want = js.rb_sweep(want, jnp.asarray(r), jnp.asarray(dq), bcs)
    want = np.asarray(want)
    assert got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= ns * _ulp(want)


@pytest.mark.parametrize("shape,bcs", CASES)
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_poisson_residual(shape, bcs, dtype):
    u, r, dq = _data(shape, dtype, seed=2)
    got = ts.poisson_residual(torch.as_tensor(u), torch.as_tensor(r), dq, bcs).numpy()
    want = np.asarray(js.poisson_residual(jnp.asarray(u), jnp.asarray(r), jnp.asarray(dq), bcs))
    tol = 1e-15 * np.abs(want).max() * 4 if dtype == np.float64 else _ulp(want)
    assert np.abs(got - want).max() <= tol
    # Dirichlet faces carry exactly zero residual
    assert np.array_equal(got == 0, want == 0)


@pytest.mark.parametrize("shape,bcs", [CASES[0], CASES[3]])
def test_lane_axis_matches_per_lane(shape, bcs):
    """A leading lane axis sweeps every lane like a standalone call (the
    all-Neumann mean is taken per lane)."""
    rng = np.random.default_rng(3)
    u = torch.as_tensor(rng.standard_normal((3,) + shape))
    r = torch.as_tensor(rng.standard_normal((3,) + shape))
    dq = np.array([0.9, 1.1, 1.3][: len(shape)])
    batched = ts.rb_sweep(u, r, dq, bcs)
    res = ts.poisson_residual(u, r, dq, bcs)
    for k in range(3):
        single = ts.rb_sweep(u[k], r[k], dq, bcs)
        assert torch.allclose(batched[k], single, rtol=0, atol=1e-15)
        assert torch.equal(res[k], ts.poisson_residual(u[k], r[k], dq, bcs))


def test_du_metrics_and_trapz():
    rng = np.random.default_rng(4)
    a, b = rng.standard_normal((2, 6, 7, 8))
    dm, da = treduce.du_metrics(torch.as_tensor(a), torch.as_tensor(b))
    jm, ja = jreduce.du_metrics(jnp.asarray(a), jnp.asarray(b))
    assert float(dm) == float(jm)
    assert abs(float(da) - float(ja)) <= 1e-15 * float(ja)
    lm, la = treduce.du_metrics(torch.as_tensor(a[None]).expand(2, -1, -1, -1),
                                torch.as_tensor(b[None]).expand(2, -1, -1, -1), ndim=3)
    assert lm.shape == (2,) and float(lm[1]) == float(jm)
    f = rng.standard_normal((13, 17))
    got = float(treduce.trapz_2d(torch.as_tensor(f), 0.05, 0.07))
    want = float(jreduce.trapz_2d(jnp.asarray(f), 0.05, 0.07))
    assert abs(got - want) <= 1e-14 * abs(want)


@pytest.mark.parametrize("lanes", [(), (2,)])
def test_apply_axis_matrices(lanes):
    rng = np.random.default_rng(5)
    qf = [np.linspace(0, 1, n) for n in (9, 10, 11)]
    qc = [np.linspace(0, 1, n // 2) for n in (9, 10, 11)]
    mats = [jtr.interp_matrix_1d(f, c) for f, c in zip(qf, qc)]
    x = rng.standard_normal(lanes + tuple(m.shape[1] for m in mats))
    got = ttr.apply_axis_matrices(torch.as_tensor(x), [torch.as_tensor(m) for m in mats]).numpy()
    for k in np.ndindex(*lanes):
        want = np.asarray(jtr.apply_axis_matrices(jnp.asarray(x[k]), mats))
        assert np.abs(got[k] - want).max() <= 1e-14 * np.abs(want).max()
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def test_curl_and_derivatives():
    rng = np.random.default_rng(6)
    A = rng.standard_normal((3, 13, 17, 21))
    dq = (0.013, 0.017, 0.021)
    got = tderiv.curl(torch.as_tensor(A), dq).numpy()
    want = np.asarray(jderiv.curl(jnp.asarray(A), jnp.asarray(dq)))
    assert np.abs(got - want).max() <= 1e-14 * np.abs(want).max()
    for axis in (-1, -2, -3):
        d = tderiv.deriv_axis(torch.as_tensor(A[0]), 0.05, axis).numpy()
        dj = np.asarray(jderiv.deriv_axis(jnp.asarray(A[0]), 0.05, axis))
        assert np.abs(d - dj).max() <= 1e-14 * np.abs(dj).max()
