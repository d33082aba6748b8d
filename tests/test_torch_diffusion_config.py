"""The stratified-diffusion deployment (the benchmark's ``diffusion3d``
configuration): ``solve_poisson_bvp(operator=DiffusionOperator(a))`` with
``a(z) = exp(-ln(c) z)`` on the normalised height, held on the CPU to the
plain float64 reference ``benchmark/reference/diffusion.py``, and the
operator's spans and counter in the registry (``utils/profiling.py``).

Tolerances:
  * the reference's ``L[u]`` against the operator's ``-residual(u, 0)``:
    within 1e-13 of max|L u| (the same flux form and face means, summed
    in the same order; only the rounding of ``1 / h^2`` may differ);
  * solves against the manufactured discrete solution (``rhs = L_ref
    u_true``): ``u_gap`` under the configuration's own limit, which the
    float32 control exceeds (its V-cycles stall at the float32 floor, so
    its cycles are capped at 40 to keep the test short: its gap is at that
    floor long before 1,024 cycles).
"""

import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.reference import diffusion as ref
from ndsm_tpu_torch import (DiffusionOperator, GridHierarchy, Options, PoissonBVP,
                            solve_poisson_bvp)
from ndsm_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
CONFIG = json.loads((ROOT / "benchmark" / "configs" / "diffusion3d.json").read_text())
LIMIT = CONFIG["limits"]["u_gap"]
NNN = (("N", "N"),) * 3
FACES = {"neumann": NNN, "mixed": (("D", "N"), ("N", "N"), ("N", "D")),
         "dirichlet": (("D", "D"),) * 3}


def _case(n, seed, bcs=NNN):
    """(spec, program operator, u_true, rhs = L_ref u_true, mesh) of a seeded
    contrast and a seeded sum of three cosine modes."""
    rng = np.random.default_rng(seed)
    contrast = float(rng.uniform(5.0, 50.0))
    spec = {"kind": "diffusion", "coef": "stratified", "contrast": contrast}
    rate = math.log(contrast)
    op = DiffusionOperator(lambda z, y, x: torch.exp(-rate * z))
    q = np.linspace(0.0, 1.0, n)
    u_true = np.zeros((n, n, n))
    for _ in range(3):
        k = rng.integers(0, 4, size=3)
        k[rng.integers(0, 3)] = max(1, k.max())
        amp = rng.uniform(-1.0, 1.0)
        u_true += amp * np.einsum("i,j,k->ijk", *(np.cos(math.pi * kk * q) for kk in k))
    a = ref.coefficient(spec, (n, n, n))
    rhs = ref.apply(torch.from_numpy(u_true), a, [q[1] - q[0]] * 3, bcs).numpy()
    return spec, op, u_true, rhs, q


@pytest.mark.parametrize("faces", sorted(FACES))
@pytest.mark.parametrize("n", [9, 17])
def test_reference_operator_is_the_programs(n, faces):
    bcs = FACES[faces]
    spec, op, _, _, q = _case(n, 100 * n + len(faces), bcs)
    u = torch.from_numpy(np.random.default_rng(n).standard_normal((n, n, n)))
    h = [q[1] - q[0]] * 3
    want = ref.apply(u, ref.coefficient(spec, (n, n, n)), h, bcs)
    got = -op.residual(u, torch.zeros_like(u), tuple(h), bcs)
    assert float((got - want).abs().max()) <= 1e-13 * float(want.abs().max())
    assert float(want.abs().max()) > 0


@pytest.mark.parametrize("precision", ["fp64", "mixed"])
@pytest.mark.parametrize("n", [17, 33])
def test_solve_meets_the_configurations_limit(n, precision):
    _, op, u_true, rhs, q = _case(n, 7 * n + len(precision))
    opts = Options(**{**CONFIG["options"], "precision": precision})
    u, info = solve_poisson_bvp(np.zeros_like(rhs), rhs, (q, q, q), NNN, options=opts,
                                operator=op, device="cpu")
    assert info.ierr == 0 and info.cycles > 0
    assert ref.u_gap(u, torch.from_numpy(u_true), NNN) <= LIMIT


def test_fp32_control_fails_the_limit():
    _, op, u_true, rhs, q = _case(33, 5)
    opts = Options(**{**CONFIG["options"], "precision": "fp32", "ncycles_max": 40})
    u, _ = solve_poisson_bvp(np.zeros_like(rhs), rhs, (q, q, q), NNN, options=opts,
                             operator=op, device="cpu")
    assert ref.u_gap(u, torch.from_numpy(u_true), NNN) > LIMIT


def test_operator_spans_and_counter_follow_the_vcycle():
    n = 17
    _, op, _, rhs, q = _case(n, 3)
    opts = Options(**CONFIG["options"])
    h = GridHierarchy.from_mesh((q, q, q))
    L, ms = h.ngrids, opts.ms

    def solve():
        solve_poisson_bvp(np.zeros_like(rhs), rhs, (q, q, q), NNN, options=opts, operator=op,
                          device="cpu")
        return profiling.calls()[-1]["stats"]

    first = solve()
    assert first[profiling.OP_COARSE_BUILD][0] == 1  # the engine's coarse matrix, once
    stats = solve()
    assert profiling.OP_COARSE_BUILD not in stats
    cycles = stats[profiling.VCYCLE][0]
    # per V-cycle: ms sweeps down, ms on the coarser level and ms after the
    # correction going up, on each of the L - 1 level pairs; one residual a
    # pair, and the float64 defect once a group of mixed_inner_max cycles
    assert stats[profiling.OP_RELAX][0] == cycles * 3 * ms * (L - 1)
    groups = math.ceil(cycles / opts.mixed_inner_max)
    assert stats[profiling.OP_RESIDUAL][0] == cycles * (L - 1) + groups
    # the face terms of every float32 level and of the float64 finest one,
    # each built once within the solve and none kept after it
    assert stats[profiling.OP_TERMS][0] == L + 1
    assert len(op._terms) == 0 and not op._depth
    # the operator's calls nest in the V-cycle span
    assert stats[profiling.VCYCLE][2] < stats[profiling.VCYCLE][1]

    bvp = PoissonBVP(h, NNN, opts, device="cpu", operator=op)
    before = dict(profiling.stats())
    bvp.vcycle(torch.zeros((n,) * 3), torch.as_tensor(rhs, dtype=torch.float32))
    after = profiling.stats()
    moved = {k: after[k][0] - before.get(k, (0,))[0] for k in
             (profiling.OP_RELAX, profiling.OP_RESIDUAL)}
    assert moved == {profiling.OP_RELAX: 3 * ms * (L - 1), profiling.OP_RESIDUAL: L - 1}


def test_default_engine_opens_no_operator_span():
    n = 17
    _, _, _, rhs, q = _case(n, 4)
    solve_poisson_bvp(np.zeros_like(rhs), rhs, (q, q, q), NNN,
                      options=Options(**CONFIG["options"]), device="cpu")
    stats = profiling.calls()[-1]["stats"]
    assert profiling.VCYCLE in stats
    assert not {k for k in stats if k.startswith("ndsm.op.")}
