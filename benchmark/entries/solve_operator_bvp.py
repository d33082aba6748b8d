"""Entry ``solve_operator_bvp``: ``solve_poisson_bvp(u0, rhs, meshes, bcs,
options=..., operator=DiffusionOperator(coef), device=...)``, the
injected-operator path; the call and its record are
``entries/solve_poisson_bvp.py``'s, with ``operator=`` passed.  The operator
comes from the configuration's ``operator`` (``{"kind": "diffusion",
"coef": "stratified", "contrast": c}``: ``a(z) = exp(-ln(c) z)`` on the
normalised height), built once a process: its coefficient function keys
the program's engine caches.  A call whose input was made for another
operator or other faces than the configuration's ``bcs`` raises.  Judged by
``reference/diffusion.py``: u against the manufactured discrete solution
(``u_gap``), the means taken out where every face is Neumann."""

import functools
import math

import torch

from benchmark.lib import spec
from benchmark.reference import diffusion as ref_diffusion

Base = spec.load("entries", "solve_poisson_bvp").Entry


def _operator(op_spec: dict):
    """The program's operator of a configuration's ``operator`` spec."""
    from ndsm_tpu_torch import DiffusionOperator

    if op_spec.get("kind") != "diffusion" or op_spec.get("coef") != "stratified":
        raise ValueError(f"no operator for {op_spec}")
    rate = math.log(float(op_spec["contrast"]))

    def stratified(z, y, x):
        return torch.exp(-rate * z)

    return DiffusionOperator(stratified)


class Entry(Base):
    def __init__(self, config: dict, device: str, overrides: dict):
        super().__init__(config, device, overrides)
        self.spec = dict(config["operator"])
        self.bcs = tuple(tuple(b) for b in config["bcs"])
        self.operator = _operator(self.spec)
        self.fn = functools.partial(self.fn, operator=self.operator)

    def call(self, args: dict):
        if args["operator"] != self.spec or tuple(map(tuple, args["bcs"])) != self.bcs:
            raise ValueError(f"the input was made for {args['operator']}, {args['bcs']}; the "
                             f"configuration states {self.spec}, {self.bcs}")
        return super().call(args)

    def judge(self, args: dict, out: torch.Tensor) -> dict:
        u_true = torch.as_tensor(args["u_true"], dtype=torch.float64, device=self.device)
        return {"u_gap": ref_diffusion.u_gap(out, u_true, args["bcs"])}
