"""pipeline.solve3d_s: the mean over the window's calls of the program's "solve3d" phase
(``VectorPotentialInfo.phases["solve3d"]``, a host clock read after a device
synchronise); nothing where the entry has no such phase."""


def read(run):
    vals = [c["phases"]["solve3d"] for c in run["calls"] if "solve3d" in c.get("phases", {})]
    return sum(vals) / len(vals) if vals else None
