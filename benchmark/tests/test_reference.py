"""The plain references: the analytic case at 22^3 gives the reference
code's golden errors, the spectral solves leave no residual, and the
reference imports nothing of the program."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.lib import frozen
from benchmark.reference import spectral
from benchmark.reference.vector_potential import vector_potential

REF = Path(__file__).resolve().parents[1] / "reference"


@pytest.mark.parametrize("n", [22, 44])
def test_analytic_case_gives_the_golden_errors(n):
    x, y, z = frozen.build_test_mesh(n)
    Z, Y, X = np.meshgrid(z, y, x, indexing="ij")
    A1, b1 = frozen.potential_field_case(X, Y, Z)
    A, B = vector_potential(x, y, z, b1, device="cpu")
    ea = np.linalg.norm(A1 - A.numpy(), axis=0).max()
    eb = np.linalg.norm(b1 - B.numpy(), axis=0).max()
    ga, gb, _ = frozen.GOLDEN[n]
    assert ea == pytest.approx(ga, rel=1e-5) and eb == pytest.approx(gb, rel=1e-5)


@pytest.mark.parametrize("bcs", [(("D", "D"), ("D", "D"), ("N", "N")), (("N", "N"),) * 3,
                                 (("N", "N"),) * 2, (("D", "D"), ("N", "N"))])
def test_spectral_solve_leaves_no_residual(bcs):
    g = torch.Generator().manual_seed(0)
    shape, h = (13, 11, 9)[:len(bcs)], [0.1, 0.2, 0.15][:len(bcs)]
    rhs = torch.randn(shape, generator=g, dtype=torch.float64)
    u0 = torch.randn(shape, generator=g, dtype=torch.float64)
    if all(b == ("N", "N") for b in bcs):  # solvable: trapezoid-weighted sum 0
        w = torch.ones(shape, dtype=torch.float64)
        for a in range(len(shape)):
            for i in (0, -1):
                idx = [slice(None)] * len(shape)
                idx[a] = i
                w[tuple(idx)] *= 0.5
        rhs = rhs - (w * rhs).sum() / w.sum()
    u = spectral.solve(rhs, u0, h, bcs)
    inner = tuple(slice(1, -1) if b[0] == "D" else slice(None) for b in bcs)
    r = (rhs - spectral.laplacian(u, h))[inner]
    assert float(r.abs().max()) < 1e-11 * float(rhs.abs().max()) / min(h) ** 2
    for a, b in enumerate(bcs):  # Dirichlet faces are u0's
        if b[0] == "D":
            assert torch.equal(u.select(a, 0), u0.select(a, 0))


def test_reference_imports_nothing_of_the_program():
    for path in REF.glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom) and not node.level
                     else [])
            for name in names:
                assert name.split(".")[0] not in ("ndsm_tpu_torch", "ndsm_tpu", "jax",
                                                  "jaxlib", "flax"), (path.name, name)
