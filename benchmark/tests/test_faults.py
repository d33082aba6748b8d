"""``correct`` comes out false when the timed path is broken underneath or
runs in the lower precision: the harness is driven on the CPU at small
sizes (its look for a card skipped), with the program patched in the
test's process.

Faults a cell of this benchmark can have: an answer altered where it is
produced, a step that returns its state unchanged, and (where calls
batch lanes: the pipeline's three component solves) half of the batch
left out.  No cell spans chips, so no exchange between chips can be left
out."""

import pytest
import torch

from benchmark.lib import harness

SMALL = {
    "vp_test1.n220": {"sizes": [22], "pool_per_size": 2, "warm_calls": 1, "check_per_size": 2},
    "poisson3d.ax257": {"sizes": [17], "pool_per_size": 2, "warm_calls": 1,
                        "check_per_size": 2},
    "poisson3d.neumann257": {"sizes": [17], "pool_per_size": 2, "warm_calls": 1,
                             "check_per_size": 2},
}
# On the card "auto" batches the three component solves; the CPU run asks for it.
CARD_ROUTE = {"vp_test1.n220": {"batch_components": "on"}}


def _run(cell, seed=3, overrides=None, mix=None):
    return harness.run(cell, seed, 0.3, False, device="cpu",
                       overrides={**CARD_ROUTE.get(cell, {}), **(overrides or {})},
                       mix_overrides={**SMALL[cell], **(mix or {})})


def _gap_over_limit(r) -> bool:
    return any(v["value"] > v["limit"] for k, v in r["checks"].items() if k.endswith("_gap"))


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_sound_run_is_correct(cell):
    r = _run(cell)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 1


def _perturb(t: torch.Tensor) -> torch.Tensor:
    t = t.clone()
    flat = t.view(-1)
    flat[flat.numel() // 3] += 1e-4 * float(t.abs().max())
    return t


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_answer_altered_where_produced(cell, monkeypatch):
    if cell.startswith("vp_"):
        import ndsm_tpu_torch.api as api

        real = api.compute_vector_potential

        def altered(*a, **k):
            ierr, A, B, info = real(*a, **k)
            return ierr, _perturb(A), B, info

        monkeypatch.setattr(api, "compute_vector_potential", altered)
    else:
        from ndsm_tpu_torch.mg.poisson import PoissonBVP

        real = PoissonBVP.solve

        def altered(self, *a, **k):
            u, info = real(self, *a, **k)
            return _perturb(u), info

        monkeypatch.setattr(PoissonBVP, "solve", altered)
    r = _run(cell)
    assert not r["correct"] and _gap_over_limit(r), r["checks"]


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_step_returns_its_state_unchanged(cell, monkeypatch):
    from ndsm_tpu_torch.mg.batched import MultiBCSolver
    from ndsm_tpu_torch.mg.engine import MGEngine

    monkeypatch.setattr(MGEngine, "t_vcycle", lambda self, u, *a, **k: (u, False))
    monkeypatch.setattr(MultiBCSolver, "_vcycle",
                        lambda self, u, rhs, ex, nx, act: (u, [False] * self.B))
    r = _run(cell)
    assert not r["correct"] and _gap_over_limit(r), r["checks"]


def test_half_of_the_batch_left_out(monkeypatch):
    from ndsm_tpu_torch.mg.batched import MultiBCSolver

    real = MultiBCSolver._vcycle

    def half(self, u, rhs, ex_tol, nmax_exact, act):
        keep = [a and b < self.B // 2 for b, a in enumerate(act)]
        return real(self, u, rhs, ex_tol, nmax_exact, keep)

    monkeypatch.setattr(MultiBCSolver, "_vcycle", half)
    r = _run("vp_test1.n220")
    assert not r["correct"] and _gap_over_limit(r), r["checks"]


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_lower_precision_control_fails(cell):
    """The control: the program's own float32 path (the precision below the
    configuration's mixed float64 defect correction) fails a gap's limit,
    whatever its error flag says."""
    r = _run(cell, overrides={"precision": "fp32"}, mix={"warm_calls": 0, "check_per_size": 1})
    assert not r["correct"] and _gap_over_limit(r), r["checks"]
