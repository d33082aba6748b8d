"""BENCHMARK.json keeps to the contract's shapes and characters, every name
in it resolves to a file, and a new cell, mix and metric load from new
files and entries alone."""

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark.lib import harness, spec

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_benchmark_json_shapes():
    b = spec.load_benchmark()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(b["paths"]) <= 16 and all(re.match(r"^[A-Za-z0-9_./-]{1,200}$", p)
                                                 for p in b["paths"])
    assert len(b["command"]) <= 32 and all(LINE.match(w) for w in b["command"])
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in b[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith(b["paths"][0] + "/") and (ROOT / c["file"]).is_file()
        assert LINE.match(c["source"]) and LINE.match(c["why"]) and len(c["reduced"]) <= 16
        assert any(w["config"] == c["name"] for w in b["workloads"])
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"]) and LINE.match(w["why"])
        assert (ROOT / "benchmark" / "traffic" / f"{w['traffic']}.json").is_file()
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").is_file()
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and LINE.match(m["layer"])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for w in b["workloads"]:
        cell = spec.load_cell(w["name"])
        got = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in got and len(got) >= 2 and cell.per_layer


def test_last_line_schema():
    """A traced run's result (on the CPU here): the keys a harness reads,
    each metric with its value and unit, the checks last."""
    r = harness.run("poisson3d.ax257", 11, 0.2, True, device="cpu",
                    mix_overrides={"sizes": [17], "pool_per_size": 2, "warm_calls": 1,
                                   "trace_calls": 1})
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(r)[-1] == "checks"
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(r["device"])
    assert "drivers.cycles" in r["metrics"]
    for v in r["metrics"].values():
        assert set(v) == {"value", "unit"} and isinstance(v["value"], float)
    for v in r["checks"].values():
        assert set(v) == {"value", "limit"}
    json.dumps(r)


# A field kind and a mesh that no file of the benchmark has: Dirichlet
# sines on a half-width cube.
NEW_FIELD = """import numpy as np


def make(n, mesh, rng, field, count):
    x, y, z = mesh
    out = []
    for j in range(count):
        k = 1 + j + int(rng.integers(0, 3))
        s = [np.sin(np.pi * k * q / q[-1]) for q in (z, y, x)]
        rhs = s[0][:, None, None] * s[1][None, :, None] * s[2][None, None, :]
        out.append({"u0": np.zeros_like(rhs), "rhs": rhs, "meshes": (z, y, x),
                    "bcs": tuple(tuple(b) for b in field["bcs"])})
    return out
"""
NEW_MESH = """import numpy as np


def mesh(n):
    return (np.linspace(0.0, 0.5, n),) * 3
"""


def test_new_cell_mix_and_metric_from_files_alone(tmp_path):
    """A copy of the benchmark with a new configuration (other options, its
    own mesh), a new mix (its own field kind), a new metric reader and their
    BENCHMARK.json entries: the harness runs the new cells unchanged."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    new = tmp_path / "benchmark"
    b = spec.load_benchmark()
    mix = json.loads((ROOT / "benchmark" / "traffic" / "ax257.json").read_text())
    mix.update(sizes=[17, 9], pool_per_size=2, warm_calls=1, trace_calls=2)
    (new / "traffic" / "tiny.json").write_text(json.dumps(mix))
    mix.update(field={"kind": "dirichlet_sines", "bcs": [["D", "D"]] * 3}, sizes=[17])
    (new / "traffic" / "sines.json").write_text(json.dumps(mix))
    (new / "fields" / "dirichlet_sines.py").write_text(NEW_FIELD)
    (new / "meshes" / "half_cube.py").write_text(NEW_MESH)
    config = json.loads((ROOT / "benchmark" / "configs" / "poisson3d.json").read_text())
    config.update(name="poisson3d_other", mesh="half_cube")
    config["options"].update(mean=True, precision="fp64", ms=3, vc_tol=1e-11)
    (new / "configs" / "poisson3d_other.json").write_text(json.dumps(config))
    (new / "metrics" / "drivers.calls.py").write_text(
        "def read(run):\n    return float(len(run['calls']))\n")
    b["configs"].append({"name": "poisson3d_other", "source": "a test",
                         "file": "benchmark/configs/poisson3d_other.json", "reduced": [],
                         "why": "other options and mesh"})
    b["workloads"] += [
        {"name": "poisson3d.tiny", "config": "poisson3d", "traffic": "tiny", "chips": 1,
         "why": "two small sizes"},
        {"name": "poisson3d_other.sines", "config": "poisson3d_other", "traffic": "sines",
         "chips": 1, "why": "a new configuration, mesh and field kind"}]
    b["per_layer"].append({"name": "drivers.calls", "unit": "calls", "better": "higher",
                           "source": "program_counter", "layer": "BVP drivers (mg/poisson.py, "
                           "mg/batched.py)", "moves": "call_s",
                           "workloads": ["poisson3d.tiny", "poisson3d_other.sines"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    code = ("import json, sys; sys.path[:0] = [sys.argv[1], sys.argv[2]]\n"
            "from benchmark.lib import harness\n"
            "for cell in ('poisson3d.tiny', 'poisson3d_other.sines'):\n"
            "    print(json.dumps(harness.run(cell, 5, 0.2, True, device='cpu')))\n")
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path), str(ROOT)],
                         capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    for line in out.stdout.strip().splitlines()[-2:]:
        r = json.loads(line)
        assert r["correct"], r["checks"]
        assert r["metrics"]["drivers.calls"]["value"] >= 1
        assert "drivers.cycles" in r["metrics"]
        assert 0 < r["checks"]["u_gap"]["value"] <= r["checks"]["u_gap"]["limit"]


def test_a_configuration_posing_another_problem_is_refused():
    """The reference solves one discrete problem; an option that changes it
    (not one that only changes how it is solved) is refused."""
    config = json.loads((ROOT / "benchmark" / "configs" / "vp_test1.json").read_text())
    config["options"].update(mean=True, host_curl=True, precision="fp64")
    spec.entry(config, "cpu")
    config["options"]["flux_correction_order"] = 1
    with pytest.raises(ValueError, match="another problem"):
        spec.entry(config, "cpu")


def test_reservoir_counts_the_bytes_it_holds(monkeypatch):
    """The memory peak leaves out the check's sample: the reservoir's
    ``held`` is the bytes of the answers it keeps, as they come and go."""
    import torch

    monkeypatch.setattr(harness, "device_bytes",
                        lambda o: o.untyped_storage().nbytes() if torch.is_tensor(o) else 0)
    res = harness.Reservoir(2, 7)
    outs = [torch.zeros(10 + i) for i in range(40)]
    for o in outs:
        res.offer(5, (None, o))
        assert res.held == sum(4 * t.numel() for _, t in res.items())
    res.offer(6, (None, None))
    assert len(list(res.items())) == 3 and res.held == sum(
        4 * t.numel() for _, t in res.items() if t is not None)
