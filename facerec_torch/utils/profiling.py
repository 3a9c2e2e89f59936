"""Tracing and profiling helpers (counterpart of
``facerec_tpu/utils/profiling.py``):

  * :class:`StageTimer` — wall time per named stage, synchronising on the
    device the stage's result lives on, so asynchronous CUDA work is inside
    the stage it belongs to;
  * :func:`trace` — a ``torch.profiler`` capture of the CPU and, on a card,
    CUDA activity, written as a Chrome trace;
  * :func:`timed_call` — steady-state timing with one salted argument, so
    no call repeats its inputs.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from pathlib import Path
from typing import Any, Callable

import torch


def _tensors(tree: Any):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def block_until_ready(tree: Any) -> Any:
    """Wait for every CUDA device that holds a tensor of ``tree`` (nested
    lists, tuples and dicts); CPU tensors are ready when returned."""
    for dev in {t.device for t in _tensors(tree) if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)
    return tree


class StageTimer:
    """Accumulate wall time per named stage; waits on the device of the
    stage's result (``result=``, or ``box["result"]`` set inside the
    block) before it stops the clock."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, result: Any = None):
        t0 = time.perf_counter()
        box = {}
        try:
            yield box
        finally:
            out = box.get("result", result)
            if out is not None:
                block_until_ready(out)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> dict[str, dict[str, float]]:
        return {
            k: {"total_sec": v, "count": self.counts[k],
                "mean_ms": 1000 * v / max(self.counts[k], 1)}
            for k, v in self.totals.items()
        }


@contextlib.contextmanager
def trace(log_dir: str | Path | None = None):
    """Profile the block with ``torch.profiler`` (CPU, and CUDA where a card
    is present) and write ``<log_dir>/trace.json`` (Chrome trace format;
    open in chrome://tracing or Perfetto; default ``outputs/trace``).
    Yields the directory."""
    from torch.profiler import ProfilerActivity, profile

    from facerec_torch.config import OUTPUTS_DIR

    d = Path(log_dir) if log_dir is not None else OUTPUTS_DIR / "trace"
    d.mkdir(parents=True, exist_ok=True)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=acts) as prof:
        yield d
    prof.export_chrome_trace(str(d / "trace.json"))


def timed_call(fn: Callable, *args, iters: int = 10, salt_arg: int | None = 0) -> dict[str, float]:
    """Steady-state time of ``fn(*args)``. When ``salt_arg`` is an int, that
    positional argument (a tensor or float) has the call's index added to
    it, so every call computes on distinct inputs. One warm-up call, then
    ``iters`` calls, then a wait on every device the results live on."""
    args = list(args)
    base = args[salt_arg] if salt_arg is not None else None

    def call(i: int):
        if salt_arg is not None:
            args[salt_arg] = base + float(i)
        return fn(*args)

    block_until_ready(call(iters + 1))  # warm-up
    t0 = time.perf_counter()
    outs = [call(i) for i in range(iters)]
    block_until_ready(outs)
    dt = (time.perf_counter() - t0) / iters
    return {"mean_sec": dt, "mean_ms": dt * 1000, "iters": iters}
