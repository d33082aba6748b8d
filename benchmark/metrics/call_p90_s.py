"""call_p90_s: the 90th percentile of the walls of all the window's calls."""

import statistics


def read(run):
    walls = run["walls"]
    if len(walls) < 2:
        return walls[0]
    return statistics.quantiles(walls, n=10, method="inclusive")[8]
