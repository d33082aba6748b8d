"""The traffic generator: the same seed gives the same inputs and order; a
cell loads from its data files alone."""

import numpy as np
import pytest

from benchmark.lib import spec
from benchmark.lib.traffic import Traffic

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]


def _small(cell, sizes):
    c = spec.load_cell(cell)
    return {**c.mix, "sizes": sizes, "pool_per_size": 3}, c.config


@pytest.mark.parametrize("cell", CELLS)
def test_same_seed_same_inputs(cell):
    mix, config = _small(cell, [17, 22])
    big = 2**31 + 12345  # seeds above 32 signed bits
    a, b, c = Traffic(mix, config, big), Traffic(mix, config, big), Traffic(mix, config, big + 1)
    assert a.order == b.order
    for n in (17, 22):
        for x, y, z in zip(a.pools[n], b.pools[n], c.pools[n]):
            key = "b" if "b" in x.args else "rhs"
            assert np.array_equal(x.args[key], y.args[key])
            assert not np.array_equal(x.args[key], z.args[key])
        members = [m.args["b" if "b" in m.args else "rhs"] for m in a.pools[n]]
        assert not np.array_equal(members[0], members[1])  # no two entries alike
    calls = a.calls()
    first = [next(calls) for _ in range(6)]
    assert [i.size for i in first] == list(a.order) * 3
    assert [i.member for i in first[::2]] == [0, 1, 2]


def test_every_seed_gets_the_same_sizes():
    mix, config = _small("vp_test1.scaling", spec.load_cell("vp_test1.scaling").mix["sizes"])
    mix["pool_per_size"] = 1
    orders = {Traffic(mix, config, s).order for s in range(3)}
    assert len(orders) > 1 and all(sorted(o) == sorted(mix["sizes"]) for o in orders)


def test_poisson_fields_fit_their_faces():
    mix, config = _small("poisson3d.ax257", [17])
    inp = Traffic(mix, config, 5).pools[17][0].args
    rhs = inp["rhs"]
    assert np.abs(rhs[0]).max() < 1e-12 and np.abs(rhs[:, -1]).max() < 1e-12  # D faces
    mix, config = _small("poisson3d.neumann257", [17])
    rhs = Traffic(mix, config, 5).pools[17][0].args["rhs"]
    w = np.ones(17)
    w[0] = w[-1] = 0.5
    assert abs(np.einsum("i,j,k,ijk->", w, w, w, rhs)) < 1e-9 * np.abs(rhs).max()  # solvable
