"""One run of one cell: set up, warm up, a closed loop of calls for the
window, the traced calls (``--trace 1``), then the check of the window's
answers against the plain reference, and the result line.

A closed loop: one caller, the next call as soon as the last returned, as
a user computing one box after another does.  ``call_s`` is the window
over the calls completed in it; the window runs from the first call's
start to the end of the last call started before ``seconds`` had passed.
"""

from __future__ import annotations

import math
import statistics
import subprocess
import sys
import time
import traceback
from typing import Dict, List, Optional

from . import guard, spec, trace
from .traffic import Traffic, rng_for


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def device_bytes(obj) -> int:
    """Bytes of the CUDA tensors in ``obj`` (a tensor, or a tuple or list of
    them; anything else holds none)."""
    import torch

    if isinstance(obj, (tuple, list)):
        return sum(device_bytes(o) for o in obj)
    if isinstance(obj, torch.Tensor) and obj.is_cuda:
        return obj.untyped_storage().nbytes()
    return 0


class Reservoir:
    """A seeded uniform sample of ``k`` calls of each size from the window.
    ``held`` is the device bytes of the answers it keeps, which no user's
    loop would hold and which the memory peak leaves out."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng = k, rng_for(seed, 2)
        self.seen: Dict[int, int] = {}
        self.kept: Dict[int, list] = {}
        self.held = 0

    def offer(self, size: int, item) -> None:
        j = self.seen.get(size, 0)
        self.seen[size] = j + 1
        slot = self.kept.setdefault(size, [])
        if j < self.k:
            slot.append(item)
        else:
            r = int(self.rng.integers(0, j + 1))
            if r >= self.k:
                return
            self.held -= device_bytes(slot[r][1])
            slot[r] = item
        self.held += device_bytes(item[1])

    def items(self):
        for size in sorted(self.kept):
            yield from self.kept[size]


def run(cell_name: str, seed: int, seconds: float, traced: bool, *, device: str = "cuda",
        t_start: Optional[float] = None, overrides: Optional[dict] = None,
        mix_overrides: Optional[dict] = None) -> dict:
    """The result of one run (the last line's object).  ``overrides`` go into
    the entry's ``Options`` (the lower-precision control, tests);
    ``mix_overrides`` into the traffic mix (tests at small sizes)."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    cell = spec.load_cell(cell_name)
    mix = {**cell.mix, **(mix_overrides or {})}
    entry = spec.entry(cell.config, device, overrides)
    cuda = device == "cuda"
    t_ctx = time.perf_counter()
    if cuda:
        torch.zeros(1, device="cuda")  # the CUDA context
    t_pool = time.perf_counter()
    traffic = Traffic(mix, cell.config, seed)
    t_warm = time.perf_counter()

    warm = []
    for n in traffic.sizes:  # every shape the window uses, nothing else
        pool = traffic.pools[n]
        for j in range(int(mix["warm_calls"])):
            t0 = time.perf_counter()
            entry.call(pool[j % len(pool)].args)
            warm.append(f"{time.perf_counter() - t0:.3f}")
    if cuda:
        torch.cuda.synchronize()
    # The memory peak: a call's own working set and what the program keeps
    # between calls, over the warm-up and each call of the window, less what
    # the check's sample holds.
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0

    sample = Reservoir(int(mix["check_per_size"]), seed)
    calls = traffic.calls()
    walls: List[float] = []
    recs: List[dict] = []
    failed = 0
    t_first = time.perf_counter()
    setup_s = t_first - t_start
    t_end = t_first
    while not walls or t_end - t_first < seconds:
        inp = next(calls)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        held = sample.held
        t0 = time.perf_counter()
        try:
            out, rec = entry.call(inp.args)
        except Exception:  # a call that raises has failed; the window goes on
            _log(f"call {len(walls)} (n={inp.size}) raised:\n{traceback.format_exc()}")
            out, rec = None, {"ierr": -1, "solves": []}
        t_end = time.perf_counter()
        walls.append(t_end - t0)
        if cuda:
            memory_peak = max(memory_peak, torch.cuda.max_memory_allocated() - held)
        rec["size"] = inp.size
        recs.append(rec)
        if rec["ierr"] != 0:
            failed += 1
        sample.offer(inp.size, (inp, out))
        del out
    window_s = t_end - t_first
    _log(f"setup: {t_ctx - t_start:.3f} s to the entry (imports), {t_pool - t_ctx:.3f} s the "
         f"CUDA context, {t_warm - t_pool:.3f} s the pools, {t_first - t_warm:.3f} s the "
         f"warm-up (calls {' '.join(warm)} s)")
    _log(f"memory_peak_bytes {memory_peak} (the sample held {sample.held} at the close)")
    guard.check()

    record = {"setup_s": setup_s, "window_s": window_s, "walls": walls, "calls": recs,
              "config": cell.config, "mix": mix, "cell": cell.name,
              "trace": None, "traced_calls": []}
    t_trace = time.perf_counter()
    if traced:
        todo = [next(calls) for _ in range(int(mix["trace_calls"]))]
        traced_recs = []
        record["trace"] = trace.profile(
            [lambda a=inp.args: traced_recs.append(entry.call(a)[1]) for inp in todo], device)
        record["traced_calls"] = traced_recs
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = spec.reader(m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    t_check = time.perf_counter()
    # The check, once the window has closed and the peak has been read.
    limits = cell.config["limits"]
    worst: Dict[str, float] = {k: 0.0 for k in limits}
    judged = 0
    ok = True
    for inp, out in sample.items():
        if out is None:
            continue
        try:
            for k, v in entry.judge(inp.args, out).items():
                worst[k] = max(worst[k], v) if math.isfinite(v) else math.inf
            judged += 1
        except Exception:  # a check that raises is no pass; the other calls are judged
            _log(f"check of a call (n={inp.size}) raised:\n{traceback.format_exc()}")
            ok = False
    sample = None
    _log(f"trace {t_check - t_trace:.3f} s, check {time.perf_counter() - t_check:.3f} s")
    checks = {k: {"value": worst[k], "limit": limits[k]} for k in limits}
    checks["failed_calls"] = {"value": failed, "limit": 0}
    checks["judged_calls"] = {"value": judged, "limit": 1}
    correct = (ok and failed == 0 and judged >= 1
               and all(worst[k] <= limits[k] for k in limits))

    dev = {"platform": "gpu" if cuda else device,
           "kind": torch.cuda.get_device_name(0) if cuda else device,
           "count": cell.chips, "memory_peak_bytes": int(memory_peak)}
    result = {"correct": bool(correct), "attempted": len(walls), "failed": failed,
              "metrics": metrics, "device": dev}
    if traced and record["trace"].get("calls"):
        tr = record["trace"]
        dev["busy_s"], dev["window_s"] = tr["busy_s"], tr["window_s"]
        result["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    if cuda:
        _log(f"card {_power_limit()}")
    _log(f"calls {len(walls)} in {window_s:.4f} s, setup {setup_s:.4f} s; the first calls "
         f"{' '.join(f'{w:.3f}' for w in walls[:3])} s, the median {statistics.median(walls):.3f} s")
    for k, v in checks.items():
        _log(f"check {k} {v['value']!r} limit {v['limit']!r}")
    result["checks"] = checks
    return result
