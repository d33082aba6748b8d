"""Entry ``solve_poisson_bvp``: ``solve_poisson_bvp(u0, rhs, meshes, bcs,
options=..., device=...)`` with host float64 inputs (the upload is part of
the call); a call ends when u is finished on the device.  Judged by
``reference/poisson.py``: max|u - u_ref| / max|u_ref| (``u_gap``), with the
mean taken out where every face is Neumann."""

import torch

from benchmark.lib.entries import options, rel_gap
from benchmark.lib.work import Solve
from benchmark.reference import poisson as ref_poisson


class Entry:
    def __init__(self, config: dict, device: str, overrides: dict):
        from ndsm_tpu_torch import solve_poisson_bvp

        self.fn = solve_poisson_bvp
        self.options = options(config, overrides)
        self.device = device

    def call(self, args: dict):
        u, info = self.fn(args["u0"], args["rhs"], args["meshes"], args["bcs"],
                          options=self.options, device=self.device)
        if self.device == "cuda":
            torch.cuda.synchronize()
        all_n = all(tuple(b) == ("N", "N") for b in args["bcs"])
        rec = {"ierr": int(info.ierr),
               "solves": [Solve(tuple(args["rhs"].shape), info.cycles, True, all_n)]}
        return u, rec

    def judge(self, args: dict, out: torch.Tensor) -> dict:
        ref = ref_poisson.solve_poisson_bvp(args["u0"], args["rhs"], args["meshes"],
                                            args["bcs"], device=self.device)
        u = out.to(torch.float64)
        if all(tuple(b) == ("N", "N") for b in args["bcs"]):
            u = u - u.mean()
        return {"u_gap": rel_gap(u, ref)}
