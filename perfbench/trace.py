"""Spans and the device trace.

``Spans`` keeps host-clock spans in memory, by name. ``profile`` runs a
short window under ``torch.profiler`` and reduces its trace: the device's
operations (kernels, copies, fills) by name, their union (busy time), the
window's length, and the idle gaps labelled by what the host was doing."""

from __future__ import annotations

import json
import os
import tempfile
import time
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
WINDOW = "perfbench.window"
SHORT_GAP_US = 20.0  # idle gaps shorter than this are lumped together, unlabelled


class Spans:
    """Durations in seconds, by name, in memory."""

    def __init__(self):
        self.spans: dict[str, list[float]] = defaultdict(list)

    def wrap(self, name: str, fn):
        """``fn`` with each call recorded under ``name``."""
        def spanned(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.spans[name].append(time.perf_counter() - t0)
        return spanned

    def mean(self, name: str) -> float | None:
        v = self.spans.get(name)
        return sum(v) / len(v) if v else None


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    merged: list[list[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def reduce_trace(events: list[dict]) -> dict:
    """A chrome trace's events -> {"busy_s", "window_s", "ops": {name:
    seconds}, "launches": {name: count}, "gaps": {label: seconds}}. The
    window is the ``WINDOW`` annotation's span."""
    win = [e for e in events if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
    if not win:
        raise RuntimeError(f"the trace has no {WINDOW} span")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev = [e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e]
    ops: dict[str, float] = defaultdict(float)
    launches: dict[str, int] = defaultdict(int)
    spans = []
    for e in dev:
        a, b = max(float(e["ts"]), w0), min(float(e["ts"]) + float(e["dur"]), w1)
        if b > a:  # the window's part of each operation
            ops[e["name"]] += (b - a) * 1e-6
            launches[e["name"]] += 1
            spans.append((a, b))
    busy = _union(spans)
    host = [e for e in events if e.get("cat") in HOST_CATS and "dur" in e
            and e.get("name") != WINDOW]
    gaps: dict[str, float] = defaultdict(float)
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b - a >= SHORT_GAP_US:
            gaps[_host_label(host, (a + b) / 2)] += (b - a) * 1e-6
        elif b > a:
            gaps[f"gaps under {SHORT_GAP_US:g} us"] += (b - a) * 1e-6
    return {"busy_s": sum(b - a for a, b in busy) * 1e-6, "window_s": (w1 - w0) * 1e-6,
            "ops": dict(ops), "launches": dict(launches), "gaps": dict(gaps)}


def _host_label(host: list[dict], t: float) -> str:
    """What the host did at ``t``: the outermost annotation and the
    innermost operation that cover it."""
    cover = [e for e in host if float(e["ts"]) <= t <= float(e["ts"]) + float(e["dur"])]
    if not cover:
        return "host (python)"
    notes = [e for e in cover if e.get("cat") == "user_annotation"]
    inner = min(cover, key=lambda e: float(e["dur"]))["name"]
    outer = max(notes, key=lambda e: float(e["dur"]))["name"] if notes else None
    return inner if outer in (None, inner) else f"{outer} > {inner}"


def profile(fn, n: int, align=None) -> dict:
    """``fn(i)`` for i < n under torch.profiler, the window closed by a
    device synchronise; the reduced trace (``reduce_trace``). ``align``
    runs under the profiler before the window opens (ranks of a mesh meet
    there, so that none waits in the window for another's profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, record_function
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        if align is not None:
            align()
            torch.cuda.synchronize()
        with record_function(WINDOW):
            for i in range(n):
                fn(i)
            torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return reduce_trace(events)


def breakdown(red: dict, top: int = 10) -> dict:
    """The ``breakdown`` of a result line: the device operations that took
    most time and the longest idle gaps by what the host was doing."""
    def ranked(d):
        return [[k[:200], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": ranked(red["ops"]), "idle_gaps": ranked(red["gaps"])}


def device_seconds(red: dict, *parts: str) -> tuple[float, int]:
    """(seconds, launches) of the device operations whose names hold any
    of ``parts``; launches counted on the first part's operations."""
    secs = sum(v for k, v in red["ops"].items() if any(p in k for p in parts))
    n = sum(v for k, v in red["launches"].items() if parts[0] in k)
    return secs, n
