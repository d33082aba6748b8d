"""hostcurl.fetch_s: the seconds a call waits, from the first slab of A on
its way to the host until every slab has landed and been rebuilt there:
the mean over the window's calls of the inclusive seconds of the program's
``ndsm.hostcurl.fetch`` span (read from the program's registry,
``ndsm_tpu_torch.utils.profiling.calls()``); nothing where the program has
no registry or no such span."""

from benchmark.lib import program


def read(run):
    return program.mean(run, "ndsm.hostcurl.fetch", 1)
