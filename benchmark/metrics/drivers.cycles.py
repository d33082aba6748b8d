"""drivers.cycles: V-cycles a call, summed over the call's solves
(``SolveInfo.cycles``), the mean over the window's calls."""


def read(run):
    vals = [sum(s.cycles for s in c["solves"]) for c in run["calls"] if c["solves"]]
    return sum(vals) / len(vals) if vals else None
