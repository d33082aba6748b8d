"""drivers.sync_wait_s: the seconds a call the host is blocked on the card
in its reads of device values and its synchronises: the mean over the
window's calls of the program's ``ndsm.sync`` span (read from the
program's registry, ``ndsm_tpu_torch.utils.profiling.calls()``); nothing
where the program has no registry."""

from benchmark.lib import program


def read(run):
    return program.mean(run, "ndsm.sync", 1)
