"""The reduction of a device trace: busy time as the union of the device's
operations inside the window, operations by name, idle gaps by what the
host was doing."""

from __future__ import annotations

import pytest

from perfbench import trace


def ev(name, cat, ts, dur):
    return {"name": name, "cat": cat, "ts": ts, "dur": dur}


def test_busy_is_the_union_inside_the_window():
    events = [ev(trace.WINDOW, "user_annotation", 100, 1000),
              ev("k1", "kernel", 50, 100),     # half before the window
              ev("k2", "kernel", 120, 50),     # inside k1's span: counted once in busy
              ev("copy", "gpu_memcpy", 400, 100),
              ev("late", "kernel", 1090, 100),  # runs past the window's close
              ev("wait", "cuda_runtime", 200, 200),
              ev("aten::copy_", "cpu_op", 600, 400)]
    red = trace.reduce_trace(events)
    assert red["window_s"] == pytest.approx(1000e-6)
    assert red["busy_s"] == pytest.approx((170 - 100 + 100 + 10) * 1e-6)
    assert red["ops"]["k1"] == pytest.approx(50e-6)
    assert red["launches"] == {"k1": 1, "k2": 1, "copy": 1, "late": 1}
    # the gaps: 170-400 (midpoint 285, under "wait"), 500-1090 (under the copy)
    assert red["gaps"]["wait"] == pytest.approx(230e-6)
    assert red["gaps"]["aten::copy_"] == pytest.approx(590e-6)
    assert red["busy_s"] + sum(red["gaps"].values()) == pytest.approx(red["window_s"])


def test_breakdown_keeps_the_ten_largest():
    red = {"ops": {f"k{i}": float(i) for i in range(15)}, "gaps": {"host (python)": 1.0}}
    b = trace.breakdown(red)
    assert [n for n, _ in b["device_ops"]] == [f"k{i}" for i in range(14, 4, -1)]
    assert b["idle_gaps"] == [["host (python)", 1.0]]


def test_a_trace_without_the_window_is_refused():
    with pytest.raises(RuntimeError):
        trace.reduce_trace([ev("k", "kernel", 0, 1)])
