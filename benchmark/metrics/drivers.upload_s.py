"""drivers.upload_s: the mean over the window's calls of the program's
``ndsm.upload`` span, the copy of host inputs to the card inside
``PoissonBVP.solve`` (read from the program's registry,
``ndsm_tpu_torch.utils.profiling.calls()``); nothing where no call
uploads, or where the program has no registry."""

from benchmark.lib import program


def read(run):
    return program.mean(run, "ndsm.upload", 1)
