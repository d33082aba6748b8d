"""What the entry adapters (``entries/<entry>.py``, one a public entry point
of ``ndsm_tpu_torch``, named by a configuration's ``entry``) share.

An adapter is a class ``Entry(config, device, overrides)`` with
``call(args) -> (out, record)``, which calls the entry as a user does with
the generated host inputs and returns what the call produced with a small
record of the program's own spans and counters (``ierr``, ``solves`` with
their ``SolveInfo`` cycles, ``phases`` where the entry has them), and
``judge(args, out) -> {number: value}``, which compares ``out`` with the
plain reference.  The program is imported inside the adapter, never by the
reference.
"""

from __future__ import annotations

import torch


def options(config: dict, overrides: dict):
    """The entry's ``Options``: the configuration's, then ``overrides`` (the
    lower-precision control, tests)."""
    from ndsm_tpu_torch import Options

    return Options(**{**config["options"], **overrides})


def refuse_other_problem(config: dict, problem: dict) -> None:
    """Refuse a configuration whose options pose another discrete problem
    than the reference solves (``problem``: the options that change the
    exact answer, at the values the reference computes).  Options that only
    change how the answer is reached (tolerances, sweeps, precision, the
    metric, routes) are not looked at."""
    bad = {k: v for k, v in config["options"].items() if k in problem and problem[k] != v}
    if bad:
        raise ValueError(f"options {bad} pose another problem than the reference solves "
                         f"({problem})")


def rel_gap(a: torch.Tensor, ref: torch.Tensor) -> float:
    """max|a - ref| / max|ref|."""
    return float((a - ref).abs().max() / ref.abs().max())
