"""Entry ``vector_potential``: ``vector_potential(x, y, z, b, options=...,
device=...)``; a call ends when A and B are numpy arrays on the host.
Judged by ``reference/vector_potential.py``: max|A - A_ref| / max|A_ref|
(``A_gap``) and the same for B (``B_gap``)."""

import torch

from benchmark.lib.entries import options, refuse_other_problem, rel_gap
from benchmark.lib.work import Solve
from benchmark.reference import vector_potential as ref_vp


class Entry:
    def __init__(self, config: dict, device: str, overrides: dict):
        from ndsm_tpu_torch import vector_potential

        refuse_other_problem(config, ref_vp.PROBLEM)
        self.fn = vector_potential
        self.options = options(config, overrides)
        self.device = device

    def call(self, args: dict):
        ierr, A, B, info = self.fn(args["x"], args["y"], args["z"], args["b"],
                                   options=self.options, full_output=True, device=self.device)
        n = tuple(len(args[k]) for k in ("x", "y", "z"))
        solves = [Solve((n[d2], n[d1]), s.cycles, True, True)
                  for (d1, d2), s in zip(ref_vp.FACE_DIMS, info.chi)]
        solves += [Solve((n[2], n[1], n[0]), s.cycles, False, False) for s in info.components]
        rec = {"ierr": int(ierr), "phases": dict(info.phases or {}), "solves": solves}
        return (A, B), rec

    def judge(self, args: dict, out: tuple) -> dict:
        A_ref, B_ref = ref_vp.vector_potential(args["x"], args["y"], args["z"], args["b"],
                                               device=self.device)
        A = torch.as_tensor(out[0], device=self.device)
        gaps = {"A_gap": rel_gap(A, A_ref)}
        del A, A_ref
        B = torch.as_tensor(out[1], device=self.device)
        gaps["B_gap"] = rel_gap(B, B_ref)
        return gaps
