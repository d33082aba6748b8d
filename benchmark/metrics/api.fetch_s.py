"""api.fetch_s: the mean over the window's calls of the program's "fetch" phase
(``VectorPotentialInfo.phases["fetch"]``, a host clock read after a device
synchronise); nothing where the entry has no such phase."""


def read(run):
    vals = [c["phases"]["fetch"] for c in run["calls"] if "fetch" in c.get("phases", {})]
    return sum(vals) / len(vals) if vals else None
