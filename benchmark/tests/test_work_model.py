"""The work model against the frozen per-call bounds, and (on the card)
the call counts it implies against the program's launch counters."""

import math

import pytest

from benchmark.lib import frozen, spec, work
from benchmark.lib.traffic import Traffic

N220 = 220**3


def test_frozen_bounds_at_220():
    # chip_smoke.py's bound column at 220^3, 5 sweeps (ms): 12, 16 and 24 B a point
    assert frozen.bound("zc_smooth_3d", N220, 5) == (pytest.approx(0.0381, abs=5e-5), "bytes")
    assert frozen.bound("zc_smooth_residual_3d", N220, 5)[0] == pytest.approx(0.0509, abs=5e-5)
    assert frozen.bound("df_residual_3d", N220, 5)[0] == pytest.approx(0.0763, abs=5e-5)
    assert frozen.bound("zc_smooth_mean_3d", 256**3, 5)[0] == pytest.approx(0.0601, abs=5e-5)


def test_steps_match_the_frozen_table():
    """Each step of one lane-cycle costs what the frozen table says its
    kernel form costs, level by level."""
    s = work.Solve((220, 220, 220), cycles=1, has_rhs=False, all_neumann=False)
    pts = work.level_points(s.shape)
    assert pts == [220**3, 110**3, 55**3, 27**3, 13**3, 6**3]
    got = work.steps(s, 5, 6)
    forms = ["zc_smooth_residual_3d", "zc_smooth_cor_3d"] * (len(pts) - 1) + [
        "zc_smooth_3d"] * (len(pts) - 1)
    levels = [n for n in pts[:-1] for _ in (0, 1)] + pts[1:]
    for (b, ops, peak, rep), form, n in zip(got, forms, levels):
        fb, fops, fpeak = frozen.WORK[form](5)
        assert (b, ops, peak, rep) == (fb * n, fops * n, fpeak, 1)
    # one zero-rhs defect, its first form (no pending correction): 12 B a point
    assert got[-1] == (12 * 220**3, 14 * 220**3, frozen.PEAK_F64, 1)


def test_defect_groups_and_least_time():
    s = work.Solve((257, 257, 257), cycles=16, has_rhs=True, all_neumann=False)
    d = [st for st in work.steps(s, 5, 6) if st[2] == frozen.PEAK_F64]
    assert [st[3] for st in d] == [1, 2]  # ceil(16 / 6) = 3 defects
    assert d[0][0] == 20 * 257**3 and d[1][0] == 32 * 257**3
    t = work.least_seconds([s], 5, 6)
    one = sum(r * max(b / frozen.PEAK_BYTES, o / p) for b, o, p, r in work.steps(s, 5, 6))
    assert t == pytest.approx(one)
    mean = work.Solve((256, 256, 256), 1, True, True)
    plain = work.steps(mean, 5, 6)[2 * 6]  # the first plain step: level 1 of 7
    assert plain[:2] == (12 * 128**3, frozen.WORK["zc_smooth_mean_3d"](5)[1] * 128**3)


def _launch_expectations(rec, config):
    """{counter: (lowest, highest)} the records' solves imply for one call."""
    exp = {}
    solves = rec["solves"]
    three = [s for s in solves if len(s.shape) == 3]
    two = [s for s in solves if len(s.shape) == 2]
    im = config["options"]["mixed_inner_max"]
    if config["entry"] == "vector_potential":
        L3 = len(work.level_points(three[0].shape))
        c3 = max(s.cycles for s in three) * (L3 - 1)
        for k in ("fused_smooth_3d_batched", "fused_smooth_residual_3d_batched",
                  "fused_smooth_cor_3d_batched"):
            exp[k] = (c3, c3)
        L2 = len(work.level_points(two[0].shape))
        c2 = max(s.cycles for s in two) * (L2 - 1)
        for k in ("v2d_smooth", "v2d_smooth_residual", "v2d_smooth_cor"):
            exp[k] = (c2, c2)
        need = sum(math.ceil(s.cycles / im) for s in three)
        exp["df_residual_3d"] = (need, need + len(three))
    else:
        (s,) = solves
        L = len(work.level_points(s.shape))
        c = s.cycles * (L - 1)
        if s.all_neumann:
            exp["zc_smooth_mean_3d"] = (3 * c, 3 * c)
        else:
            for k in ("zc_smooth_3d", "zc_smooth_residual_3d", "zc_smooth_cor_3d"):
                exp[k] = (c, c)
            exp["df_residual_3d"] = (math.ceil(s.cycles / im),) * 2
    return exp


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in spec.load_benchmark()["workloads"]])
def test_call_counts_against_the_launch_counters(card, cell):
    """At the cell's largest size: the smoothing calls per form that the
    levels and the cycles imply are the program's launch counters."""
    from ndsm_tpu_torch import ops

    c = spec.load_cell(cell)
    mix = {**c.mix, "sizes": [max(c.mix["sizes"])], "pool_per_size": 1}
    traffic = Traffic(mix, c.config, 1)
    entry = spec.entry(c.config, card)
    args = traffic.pools[mix["sizes"][0]][0].args
    entry.call(args)  # warm
    ops.reset_launch_counts()
    _, rec = entry.call(args)
    counts = ops.launch_counts()
    for k, (lo, hi) in _launch_expectations(rec, c.config).items():
        assert lo <= counts[k] <= hi, (k, counts[k], lo, hi)
