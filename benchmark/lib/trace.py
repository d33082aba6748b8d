"""A traced run's device record: whole calls under ``torch.profiler`` (host
and CUDA activity), read from the Chrome trace that the profiler writes in
C++, so that no per-event Python objects are built.

From the trace:

  * device operations: kernels, copies and sets, each with its interval;
    busy time is the union of their intervals inside the traced window
    (from the first call's start to the last call's end, host clock);
  * each kernel's phase: the innermost named range (``bench.call`` or a
    program range such as ``ndsm.chi_phase``) around the host call that
    launched it, matched by the trace's correlation id;
  * idle gaps: the stretches of the window in which no device operation
    runs, each named by what the host launched next (its range and its
    innermost host operation), "end of call" if nothing followed.

The trace file goes to the run's temporary directory and is deleted once
read.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
from collections import defaultdict
from typing import Callable, Dict, List

CALL_RANGE = "bench.call"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


def profile(calls: List[Callable[[], None]], device: str) -> dict:
    """Run each of ``calls`` under the profiler, each in a ``bench.call``
    range, and return ``read(trace)``."""
    import torch
    from torch.profiler import ProfilerActivity, record_function

    acts = [ProfilerActivity.CPU]
    if device == "cuda":
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for call in calls:
            with record_function(CALL_RANGE):
                call()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)
    finally:
        with contextlib.suppress(OSError):
            os.remove(path)
    return read(events["traceEvents"] if isinstance(events, dict) else events)


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def read(events: List[dict]) -> dict:
    """The device record of a trace's events (times in seconds)."""
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            dev.append(e)
        elif cat in HOST_CATS:
            host.append(e)
    calls = sorted((e["ts"], e["ts"] + e["dur"]) for e in host
                   if e.get("cat") == "user_annotation" and e.get("name") == CALL_RANGE)
    if not calls:
        return {"calls": 0}
    w0, w1 = calls[0][0], calls[-1][1]

    # Innermost range and host operation of every launch (host events nest).
    launch: Dict[int, tuple] = {}
    stack: List[dict] = []
    for e in sorted(host, key=lambda e: (e["ts"], -e["dur"])):
        while stack and stack[-1]["ts"] + stack[-1]["dur"] <= e["ts"]:
            stack.pop()
        if e["cat"] in ("cuda_runtime", "cuda_driver"):
            corr = e.get("args", {}).get("correlation")
            rng = next((s["name"] for s in reversed(stack) if s["cat"] == "user_annotation"),
                       "")
            op = next((s["name"] for s in reversed(stack) if s["cat"] == "cpu_op"), e["name"])
            if corr is not None:
                launch[corr] = (rng, op)
        stack.append(e)

    # Device operations inside the window, with the range that launched each.
    annots = [e for e in host if e.get("cat") == "user_annotation"]
    ops = []
    for e in dev:
        a, b = e["ts"], e["ts"] + e["dur"]
        if b <= w0 or a >= w1:
            continue
        rng, op = launch.get(e.get("args", {}).get("correlation"), (None, None))
        if rng is None:  # no launch record: the range that holds the operation
            rng = _range_at(annots, a)
        ops.append((a, b, e["cat"], e["name"], rng, op))
    ops.sort()

    busy_iv = _union([(max(a, w0), min(b, w1)) for a, b, *_ in ops])
    busy = sum(b - a for a, b in busy_iv)
    kernel_s = defaultdict(float)  # by range
    by_name = defaultdict(float)
    kernels = 0
    for a, b, cat, name, rng, _ in ops:
        by_name[short(name)] += (b - a) * 1e-6
        if cat == "kernel":
            kernels += 1
            kernel_s[rng] += (b - a) * 1e-6
    # Idle gaps, named by what the host launched next.
    starts = [o[0] for o in ops]
    gaps = defaultdict(float)
    t = w0
    for a, b in busy_iv + [[w1, w1]]:
        if a > t:
            i = bisect.bisect_left(starts, a)
            nxt = ops[i] if i < len(ops) and a < w1 else None
            label = f"{nxt[4]} / {nxt[5]}" if nxt else "end of call"
            gaps[label] += (a - t) * 1e-6
        t = max(t, b)
    top = lambda d: sorted(([k, v] for k, v in d.items()), key=lambda kv: -kv[1])[:10]  # noqa: E731
    return {
        "calls": len(calls),
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": busy * 1e-6,
        "kernels": kernels,
        "kernel_s_by_range": dict(kernel_s),
        "device_ops": top(by_name),
        "idle_gaps": top(gaps),
    }


def short(name: str) -> str:
    """A kernel's name without its parameter list, at most 120 characters
    (a copy's or a set's name whole)."""
    if name.endswith(")") and not name.startswith(("Memcpy", "Memset")):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    return name[:120]


def _range_at(annots, t) -> str:
    """The innermost range that holds time ``t``."""
    best, best_ts = "", None
    for e in annots:
        if e["ts"] <= t <= e["ts"] + e["dur"] and (best_ts is None or e["ts"] >= best_ts):
            best, best_ts = e["name"], e["ts"]
    return best
