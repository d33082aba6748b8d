"""parallel/shard.py and parallel/collectives.py of the port, and the
sharded engine's transfer blocks and message counts, against ndsm_tpu.

  * ``_axis_blocks`` is the JAX engine's numpy code: bitwise equal;
  * the halo rule (neighbour planes inside the chain, node-mirror planes at
    its ends) against a numpy statement of it, at 2, 4 and 8 shards;
  * one V-cycle's messages and bytes between shards at 2, 4 and 8 shards
    against a model computed from the level plan (which levels are
    sharded, each level's smoothing route and pass width, the transfer
    halos), in float32 (the per-shard kernel route, widths 2 and 1 and the
    plain route) and float64 (the plain route).
"""

import numpy as np
import pytest
import torch

from ndsm_tpu.ops.transfer import interp_matrix_1d as j_interp, restrict_matrix_1d as j_restrict
from ndsm_tpu.parallel import sm_engine as jsm
from ndsm_tpu_torch import GridHierarchy, Options
from ndsm_tpu_torch.parallel import collectives as C
from ndsm_tpu_torch.parallel import sm_engine
from ndsm_tpu_torch.parallel.shard import DistConfig, Mesh, make_mesh, make_mesh_nd

torch.set_num_threads(1)


@pytest.mark.parametrize("ndev", [2, 4, 8])
@pytest.mark.parametrize("n", [16, 24, 48, 220])
def test_axis_blocks_bitwise(n, ndev):
    fine = np.linspace(0.0, 1.0, n)
    coarse = np.linspace(0.0, 1.0, max(n // 2, 1))
    for M in (j_restrict(coarse, fine), j_interp(fine, coarse)):
        if M.shape[0] % ndev or M.shape[1] % ndev:
            continue
        got, H = sm_engine._axis_blocks(M, ndev)
        want, H_j = jsm._axis_blocks(M, ndev)
        assert H == H_j and np.array_equal(got, want)


def _halo_rule(v: np.ndarray, ndev: int, depth: int):
    """numpy statement of the halo of shard i: global planes
    i*b - depth .. (i+1)*b + depth - 1, a plane g outside [0, n) read as
    its node mirror (-g, or 2(n-1) - g)."""
    n = v.shape[0]
    b = n // ndev
    out = []
    for i in range(ndev):
        g = np.arange(i * b - depth, (i + 1) * b + depth)
        g = np.where(g < 0, -g, np.where(g > n - 1, 2 * (n - 1) - g, g))
        out.append(v[g])
    return out


@pytest.mark.parametrize("ndev", [2, 4, 8])
def test_extend_block_halo_rule(ndev):
    rng = np.random.default_rng(ndev)
    devs = make_mesh(ndev, devices=["cpu"] * ndev).devices
    for local in (3, 5, 8):
        v = rng.standard_normal((ndev * local, 3, 4))
        blocks = C.shard(torch.as_tensor(v), devs, 0)
        for depth in range(1, local):
            ext = C.extend_block(blocks, devs, 0, depth)
            for got, want in zip(ext, _halo_rule(v, ndev, depth)):
                assert np.array_equal(got.numpy(), want)
            for got, b in zip(C.unextend_block(ext, 0, depth), blocks):
                assert torch.equal(got, b)
            lo, hi = C.edge_planes(blocks, devs, 0, depth)
            assert all(a.shape[0] == depth for a in lo + hi)
        with pytest.raises(ValueError):
            C.edge_planes(blocks, devs, 0, local)  # the mirror needs depth + 1 planes
    # the transfers' halo: neighbour planes, zeros beyond the chain ends
    v = rng.standard_normal((ndev * 4, 2, 3))
    ext = C.exchange_halo(C.shard(torch.as_tensor(v), devs, 0), devs, 0, 2)
    pad = np.concatenate([np.zeros((2, 2, 3)), v, np.zeros((2, 2, 3))])
    for i, got in enumerate(ext):
        assert np.array_equal(got.numpy(), pad[i * 4 : i * 4 + 8])


def test_reductions_and_counts():
    devs = make_mesh(4, devices=["cpu"] * 4).devices
    vals = [torch.tensor([float(i), -float(i)]) for i in range(4)]
    C.reset_counts()
    assert torch.equal(C.psum(vals, devs), torch.tensor([6.0, -6.0]))
    assert torch.equal(C.pmax(vals, devs), torch.tensor([3.0, 0.0]))
    assert C.counts() == {"messages": 6, "bytes": 6 * 8}
    full = torch.arange(24.0).reshape(8, 3)
    C.reset_counts()
    blocks = C.scatter(full, devs, 0)
    assert torch.equal(C.all_gather(blocks, devs, 0), full)
    assert C.counts() == {"messages": 6, "bytes": 6 * 6 * 4}
    C.reset_counts()
    assert torch.equal(C.unshard(C.shard(full, devs, 0), devs, 0), full)
    assert C.counts() == {"messages": 0, "bytes": 0}


def test_mesh_and_dist_config():
    m = make_mesh(4, devices=["cpu"] * 4)
    assert m.devices == (torch.device("cpu"),) * 4 and m.shape == (4,) and m.axis_names == ("z",)
    m2 = make_mesh_nd((2, 2), ("z", "y"), devices=["cpu"] * 4)
    assert m2.shape == (2, 2) and len(m2.devices) == 4
    d1, d2 = DistConfig(m), DistConfig(make_mesh(4, devices=["cpu"] * 4))
    assert d1 == d2 and hash(d1) == hash(d2) and len({d1, d2}) == 1
    assert DistConfig(m, min_rows_per_shard=2) != d1
    with pytest.raises(ValueError):
        Mesh((torch.device("cpu"),) * 3, ("z",), (4,))
    with pytest.raises(ValueError):
        make_mesh(4, devices=["cpu"] * 3)


def _exchange(ndev, depth, plane):
    return 2 * (ndev - 1), 2 * (ndev - 1) * depth * plane


def _vcycle_model(h, ndev, min_rows, ms, itemsize):
    """Messages and bytes of one V-cycle, from the level plan: sharded
    levels (z extent divides the mesh with >= min_rows planes a shard), the
    smoothing route of each (float32: kernel passes of width 2 on blocks of
    >= 6 planes, 1 on >= 4, else the plain route; float64: the plain
    route), the transfer halos of the JAX engine's blocks, and the seam's
    gather and scatter."""
    seam = 0
    for shape in h.shapes[: h.ngrids - 1]:
        if shape[0] % ndev or shape[0] < ndev * min_rows:
            break
        seam += 1
    msgs = nbytes = 0

    def add(m_b):
        nonlocal msgs, nbytes
        msgs += m_b[0]
        nbytes += m_b[1]

    def plane(l):
        return h.shapes[l][1] * h.shapes[l][2] * itemsize

    def smooth(l, n, residual):
        """The exchanges of n sweeps (+ the residual) at sharded level l."""
        local = h.shapes[l][0] // ndev
        width = 0 if itemsize == 8 else 2 if local >= 6 else 1 if local >= 4 else 0
        if not width:
            for _ in range(2 * n + (1 if residual else 0)):
                add(_exchange(ndev, 1, plane(l)))
            return
        ns_star = min(n, width)
        if residual:
            last = n % ns_star or ns_star
            passes = [ns_star] * ((n - last) // ns_star)
            depths = [2 * p for p in passes] + [2 * last + 1]
        else:
            passes = [ns_star] * (n // ns_star) + ([n % ns_star] if n % ns_star else [])
            depths = [2 * p for p in passes]
        for d in depths:  # u extended every pass
            add(_exchange(ndev, d, plane(l)))
        for d in set(depths):  # rhs once a depth
            add(_exchange(ndev, d, plane(l)))

    L = h.ngrids
    for l in range(min(seam, L - 1)):
        smooth(l, ms, residual=True)
        fine, coarse = h.meshes[l], h.meshes[l + 1]
        if l + 1 < seam:
            _, H = jsm._axis_blocks(j_restrict(coarse[0], fine[0]), ndev)
            if H:
                add(_exchange(ndev, H, plane(l)))
            _, H = jsm._axis_blocks(j_interp(fine[0], coarse[0]), ndev)
            if H:
                add(_exchange(ndev, H, plane(l + 1)))
            smooth(l + 1, ms, residual=False)  # the ascent's coarse smoothing
        else:  # the seam: gather the residual, scatter the correction
            block = h.shapes[l][0] // ndev * plane(l)
            add((2 * (ndev - 1), 2 * (ndev - 1) * block))
        smooth(l, ms, residual=False)  # the ascent's correction smoothing
    return seam, msgs, nbytes


@pytest.mark.parametrize("precision", ["fp32", "fp64"])
@pytest.mark.parametrize("ndev", [2, 4, 8])
def test_vcycle_message_model(ndev, precision):
    n = 48
    x = np.linspace(0.0, 1.0, n)
    h = GridHierarchy.from_mesh((x, x, x))
    bcs = (("D", "D"), ("N", "N"), ("D", "N"))
    opts = Options(precision=precision)
    sb = sm_engine.ShardedPoissonBVP(h, bcs, opts, mesh=make_mesh(ndev, devices=["cpu"] * ndev),
                                     min_rows_per_shard=2)
    itemsize = 4 if precision == "fp32" else 8
    seam, msgs, nbytes = _vcycle_model(h, ndev, 2, opts.ms, itemsize)
    assert sb.seam == seam >= 2
    rng = np.random.default_rng(ndev)
    dt = sb.inner_dtype
    u = C.shard(torch.zeros((n, n, n), dtype=dt), sb.devices, 0)
    rhs = C.shard(torch.as_tensor(rng.standard_normal((n, n, n)), dtype=dt), sb.devices, 0)
    C.reset_counts()
    sb._vcycle(u, rhs, 1e-13, 100)
    assert C.counts() == {"messages": msgs, "bytes": nbytes}
