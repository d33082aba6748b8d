"""Finds a cell's parts by name: its configuration file and its traffic mix
(``traffic/<mix>.json``) by the names in ``BENCHMARK.json``, and the code
they name by the names in those files: the entry adapter
(``entries/<entry>.py``), the mesh (``meshes/<mesh>.py``), the field kind
(``fields/<kind>.py``) and a reader for each metric
(``metrics/<metric>.py``).  Nothing here names a cell, a mix, a metric or a
kind: a new one is new files and new entries."""

from __future__ import annotations

import dataclasses
import functools
import importlib.util
import json
from pathlib import Path
from typing import Callable, List, Optional

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict  # the configuration file's content
    mix: dict  # the traffic file's content
    end_to_end: List[dict]
    per_layer: List[dict]


def load_benchmark() -> dict:
    with open(ROOT / "BENCHMARK.json") as fh:
        return json.load(fh)


def _applies(metric: dict, cell: str, moved: Optional[set] = None) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return moved is None or metric["moves"] in moved


def load_cell(name: str) -> Cell:
    bench = load_benchmark()
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json ({sorted(work)})")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(ROOT / conf["file"]) as fh:
        config = json.load(fh)
    with open(BENCH / "traffic" / f"{w['traffic']}.json") as fh:
        mix = json.load(fh)
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _applies(m, name, moved)]
    return Cell(name, int(w["chips"]), config, mix, e2e, per_layer)


@functools.lru_cache(maxsize=None)
def load(kind: str, name: str):
    """The module ``<kind>/<name>.py`` of the benchmark's folder."""
    path = BENCH / kind / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no {kind[:-1]} {name!r}: {path} is missing")
    spec = importlib.util.spec_from_file_location(f"_bench_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str) -> Callable[[dict], Optional[float]]:
    """``read(run) -> value or None`` of ``metrics/<metric>.py``."""
    return load("metrics", metric).read


def entry(config: dict, device: str, overrides: Optional[dict] = None):
    """The adapter of the configuration's entry point (``entries/<entry>.py``)."""
    return load("entries", config["entry"]).Entry(config, device, overrides or {})
