"""hostcurl.encode_s: the seconds a call spends encoding A as split16 on the
card (float32 plus an int16 correction, with the host's read of the scale):
the mean over the window's calls of the inclusive seconds of the program's
``ndsm.hostcurl.encode`` span (read from the program's registry,
``ndsm_tpu_torch.utils.profiling.calls()``); nothing where the program has
no registry or no such span."""

from benchmark.lib import program


def read(run):
    return program.mean(run, "ndsm.hostcurl.encode", 1)
