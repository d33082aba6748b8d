"""drivers.graph_replays: V-cycles a call replayed from a captured CUDA graph
rather than issued op by op: the mean over the window's calls of the
program's ``ndsm.graph.replays`` counter (read from the program's registry,
``ndsm_tpu_torch.utils.profiling.calls()``); 0 where no cycle replayed,
nothing where the program has no registry.  Over ``drivers.cycles`` it is
the share of cycles that replayed."""

from benchmark.lib import program


def read(run):
    return program.mean(run, "ndsm.graph.replays", 0, absent_is_zero=True)
