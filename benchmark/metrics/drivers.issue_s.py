"""drivers.issue_s: the seconds a call the host spends issuing V-cycles:
the mean over the window's calls of the self seconds of the program's
``ndsm.vcycle`` span, net of the reads nested in it (read from the
program's registry, ``ndsm_tpu_torch.utils.profiling.calls()``); nothing
where the program has no registry."""

from benchmark.lib import program


def read(run):
    return program.mean(run, "ndsm.vcycle", 2)
