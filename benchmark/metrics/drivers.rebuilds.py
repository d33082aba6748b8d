"""drivers.rebuilds: per-shape state built again a call: the mean over the
window's calls of the program's ``ndsm.rebuild`` counter, a cache miss
on a key the cache had evicted (read from the program's registry,
``ndsm_tpu_torch.utils.profiling.calls()``); 0 where nothing was rebuilt,
nothing where the program has no registry."""

from benchmark.lib import program


def read(run):
    return program.mean(run, "ndsm.rebuild", 0, absent_is_zero=True)
