"""device.launches: kernel launches on the card a traced call (the
profiler's device kernel events over the traced calls)."""


def read(run):
    tr = run["trace"]
    if not tr or not tr.get("calls") or not tr["kernels"]:
        return None
    return tr["kernels"] / tr["calls"]
