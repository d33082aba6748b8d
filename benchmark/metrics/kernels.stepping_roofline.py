"""kernels.stepping_roofline: the least time the card could take for the
traced calls' stepping work (``benchmark.lib.work``: every smoothing call
and float64 defect, at the shapes and cycle counts the calls ran, against
the published H100 peaks) over the device time of all kernel launches in
the solve phases: the configuration's ``solve_ranges`` (the program's named
ranges), or the whole call where it names none.  Copies are not counted."""

from benchmark.lib import work


def read(run):
    tr = run["trace"]
    if not tr or not tr.get("calls") or not tr["kernels"]:
        return None
    by_range = tr["kernel_s_by_range"]
    ranges = run["config"].get("solve_ranges") or list(by_range)
    kernel_s = sum(by_range.get(r, 0.0) for r in ranges)
    if kernel_s <= 0:
        return None
    opts = run["config"]["options"]
    solves = [s for c in run["traced_calls"] for s in c["solves"]]
    least = work.least_seconds(solves, opts["ms"], opts["mixed_inner_max"])
    return 100.0 * least / kernel_s
