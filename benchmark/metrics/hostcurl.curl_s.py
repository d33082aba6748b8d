"""hostcurl.curl_s: the seconds a call waits for the host's curls of B that
are left after the last slab of A has landed: the mean over the window's
calls of the inclusive seconds of the program's ``ndsm.hostcurl.curl`` span
(read from the program's registry, ``ndsm_tpu_torch.utils.profiling.calls()``);
nothing where the program has no registry or no such span."""

from benchmark.lib import program


def read(run):
    return program.mean(run, "ndsm.hostcurl.curl", 1)
