"""pipeline.chi_s: the mean over the window's calls of the program's "chi" phase
(``VectorPotentialInfo.phases["chi"]``, a host clock read after a device
synchronise); nothing where the entry has no such phase."""


def read(run):
    vals = [c["phases"]["chi"] for c in run["calls"] if "chi" in c.get("phases", {})]
    return sum(vals) / len(vals) if vals else None
