"""device.idle: the share of the traced calls' wall in which the card ran no
kernel, copy or set (torch.profiler's device activity)."""


def read(run):
    tr = run["trace"]
    if not tr or not tr.get("calls") or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
