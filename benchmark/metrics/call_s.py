"""call_s: the measured window over the number of calls completed in it."""


def read(run):
    return run["window_s"] / len(run["walls"])
