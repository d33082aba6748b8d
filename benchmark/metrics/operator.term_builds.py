"""operator.term_builds: a level's face terms built a call: the mean over
the window's calls of the program's ``ndsm.op.terms`` counter
(``DiffusionOperator`` on a miss of its per-solve cache, read from the
program's registry, ``ndsm_tpu_torch.utils.profiling.calls()``); 0 where
nothing was built, nothing where the program has no registry or does not
declare the counter (``profiling.OP_TERMS``)."""

from benchmark.lib import program

NAME = "ndsm.op.terms"


def read(run):
    try:
        from ndsm_tpu_torch.utils import profiling
    except ImportError:
        return None
    if getattr(profiling, "OP_TERMS", None) != NAME:
        return None
    return program.mean(run, NAME, 0, absent_is_zero=True)
