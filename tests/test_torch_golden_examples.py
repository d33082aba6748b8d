"""The port's golden-table scripts (``ndsm_tpu_torch.examples``) on the CPU.

Tolerances:
  * the 22^3 rows of both golden tables through ``integration_scaling``:
    every printed digit (``%.5e``) of the four error columns, checked by
    scripts/compare_golden.py run as a subprocess (fp64, the CPU's
    precision);
  * ``golden.py``'s tables: equal to BASELINE.md's copies, parsed;
  * ``unit_test_2d_solve`` against JAX's examples/unit_test_2d_solve.py
    ``solve_case``, fp64: 1e-12 relative in Emax and Eavg, the same cycles.
"""

import importlib.util
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from ndsm_tpu_torch.examples import golden, integration_scaling, unit_test_2d_solve

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent


def _compare(ours, ref):
    proc = subprocess.run([sys.executable, str(REPO / "scripts" / "compare_golden.py"),
                           str(ours), str(ref)], capture_output=True, text=True, timeout=60)
    return proc.returncode, proc.stdout


@pytest.mark.parametrize("metric", ["max", "mean"])
def test_22_row_digit_exact_through_compare_golden(metric, tmp_path, capsys):
    out, ref = tmp_path / "ours.txt", tmp_path / "ref.txt"
    argv = ["--scales", "1", "--device", "cpu", "--out", str(out)]
    rows, infos = integration_scaling.main(argv + (["--mean"] if metric == "mean" else []))
    assert len(rows) == 1 and infos[0].ierr == 0
    assert f"{rows[0][0]:.5e}" in capsys.readouterr().out
    assert golden.main([metric, str(ref)]) == 0
    rc, text = _compare(out, ref)
    assert rc == 0 and "1 rows matched, 0 cell differences" in text, text
    assert text.count(" OK") == 4


def test_mean_metric_22_row_columns():
    """The 22^3 mean-metric golden row, all four columns (JAX
    tests/test_potential.py's mean case), and the mean metric's options."""
    opts = integration_scaling.options_for(mean=True, precision="fp64", strict=True)
    assert opts.mean and opts.mixed_inner_max == 1 and not opts.host_curl
    row, info = integration_scaling.run_row(1, opts, device="cpu")
    assert info.ierr == 0
    assert [f"{v:.5e}" for v in row[1:5]] == [f"{v:.5e}" for v in golden.results_test2[0][1:5]]
    fast = integration_scaling.options_for(fast=True)
    assert fast.host_curl and fast.fetch_encoding == "split16"


def _baseline_table(title):
    text = (REPO / "BASELINE.md").read_text()
    block = text[text.index(title):].split("\n\n")[2]
    rows = []
    for line in block.splitlines():
        cells = [c.strip() for c in line.strip("|").split("|")]
        if re.match(r"^\d\.\d+e[-+]\d+$", cells[0]):
            rows.append(tuple(float(c) for c in cells))
    return tuple(rows)


def test_golden_tables_equal_baseline_md(tmp_path):
    t1 = _baseline_table("## Full golden table — integration_test1.py")
    t2 = _baseline_table("## Full golden table — integration_test2.py")
    assert len(t1) == len(t2) == 9
    assert golden.results_test1 == t1 and golden.results_test2 == t2
    assert golden.TABLES == {"max": golden.results_test1, "mean": golden.results_test2}
    # the written table compares equal to itself, 9 rows
    golden.write_table(str(tmp_path / "a.txt"), golden.results_test1)
    rc, text = _compare(tmp_path / "a.txt", tmp_path / "a.txt")
    assert rc == 0 and "9 rows matched, 0 cell differences" in text


def _jax_example():
    spec = importlib.util.spec_from_file_location("jax_unit_test_2d_solve",
                                                  REPO / "examples" / "unit_test_2d_solve.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_2d_study_against_jax_solve_case(tmp_path):
    jax_ex = _jax_example()
    assert tuple(jax_ex.SCALEFAC) == unit_test_2d_solve.SCALEFAC
    a1, b1 = unit_test_2d_solve.coefficients()
    for nshape in unit_test_2d_solve.shapes()[:2]:
        res, info = unit_test_2d_solve.solve_case(nshape, a1, b1, device="cpu")
        res_j, info_j = jax_ex.solve_case(np.array(nshape), a1, b1)
        assert info.ierr == info_j.ierr == 0 and info.cycles == info_j.cycles
        assert res[0] == res_j[0]
        for a, b in zip(res[1:], res_j[1:]):
            assert abs(a - b) <= 1e-12 * abs(b)
    data, infos, gamma = unit_test_2d_solve.main(
        ["--quick", "--device", "cpu", "--data", str(tmp_path / "res.txt")])
    assert data.shape == (4, 3) and all(i.ierr == 0 for i in infos)
    assert np.array_equal(np.loadtxt(tmp_path / "res.txt"), data)
    assert 1.9 < gamma < 2.1


def test_examples_default_to_the_card():
    """Both scripts run on the card unless asked for the CPU: without one
    they raise, they never run on the CPU in its place."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        integration_scaling.main(["--scales", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        unit_test_2d_solve.solve_case((27, 36), *unit_test_2d_solve.coefficients())
