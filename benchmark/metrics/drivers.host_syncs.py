"""drivers.host_syncs: host reads of a device value a call (each a
``float``, ``bool``, ``int`` or ``tolist`` of a device tensor, or an
explicit synchronise): the mean over the window's calls of the count of
the program's ``ndsm.sync`` span (read from the program's registry,
``ndsm_tpu_torch.utils.profiling.calls()``); nothing where the program
has no registry."""

from benchmark.lib import program


def read(run):
    return program.mean(run, "ndsm.sync", 0)
