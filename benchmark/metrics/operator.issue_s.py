"""operator.issue_s: the seconds a call spends in an injected operator's
relax and residual: the mean over the window's calls of the inclusive
seconds of the program's ``ndsm.op.relax`` and ``ndsm.op.residual`` spans
(the engine issuing the operator's plain tensor code, read from the
program's registry, ``ndsm_tpu_torch.utils.profiling.calls()``); nothing
where the program has no registry or no such span."""

from benchmark.lib import program


def read(run):
    vals = [program.mean(run, name, 1) for name in ("ndsm.op.relax", "ndsm.op.residual")]
    return None if None in vals else sum(vals)
