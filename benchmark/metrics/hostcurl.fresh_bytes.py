"""hostcurl.fresh_bytes: bytes of host arrays a call allocates fresh for A
and B on the host-curl route (pages the host faults in as it writes them):
the mean over the window's calls of the program's
``ndsm.hostcurl.fresh_bytes`` counter (read from the program's registry,
``ndsm_tpu_torch.utils.profiling.calls()``); 0 where nothing was allocated
fresh, nothing where the program has no registry or does not declare the
counter (``profiling.HOSTCURL_FRESH_BYTES``)."""

from benchmark.lib import program

NAME = "ndsm.hostcurl.fresh_bytes"


def read(run):
    try:
        from ndsm_tpu_torch.utils import profiling
    except ImportError:
        return None
    if getattr(profiling, "HOSTCURL_FRESH_BYTES", None) != NAME:
        return None
    return program.mean(run, NAME, 0, absent_is_zero=True)
