"""The port's profiling helpers (``facerec_torch/utils/profiling.py``)
against the JAX package's (``facerec_tpu/utils/profiling.py``) on the CPU:
the ``StageTimer`` summary's shape, ``timed_call``'s keys and salting, and
``trace`` writing a Chrome trace."""

import json

import jax.numpy as jnp
import pytest
import torch

from facerec_torch.utils import StageTimer, timed_call, trace
from facerec_torch.utils.profiling import block_until_ready
from facerec_tpu.utils.profiling import StageTimer as JaxStageTimer
from facerec_tpu.utils.profiling import timed_call as jax_timed_call


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _run(timer, make):
    with timer.stage("detect", result=make()):
        pass
    for _ in range(3):
        with timer.stage("embed") as box:
            box["result"] = make()
    with timer.stage("match"):
        pass
    return timer.summary()


def test_stage_timer_summary_matches_jax():
    got = _run(StageTimer(), lambda: torch.ones(4) * 2)
    ref = _run(JaxStageTimer(), lambda: jnp.ones(4) * 2)
    assert list(got) == list(ref) == ["detect", "embed", "match"]
    for k in ref:
        assert sorted(got[k]) == sorted(ref[k]) == ["count", "mean_ms", "total_sec"]
        assert got[k]["count"] == ref[k]["count"]
        assert got[k]["mean_ms"] == pytest.approx(1000 * got[k]["total_sec"] / got[k]["count"])
    assert got["embed"]["count"] == 3


def test_stage_timer_counts_a_failed_stage():
    timer = StageTimer()
    with pytest.raises(ValueError):
        with timer.stage("boom"):
            raise ValueError("x")
    assert timer.summary()["boom"]["count"] == 1


@pytest.mark.parametrize("salt_arg", [0, None])
def test_timed_call_keys_match_jax(salt_arg):
    seen = []

    def fn(x, y):
        seen.append(float(x.sum()))
        return x * y

    got = timed_call(fn, torch.zeros(3), 2.0, iters=4, salt_arg=salt_arg)
    ref = jax_timed_call(lambda x, y: x * y, jnp.zeros(3), 2.0, iters=4, salt_arg=salt_arg)
    assert sorted(got) == sorted(ref) == ["iters", "mean_ms", "mean_sec"]
    assert got["iters"] == 4 and got["mean_ms"] == pytest.approx(got["mean_sec"] * 1000)
    # one warm-up call (salt iters + 1), then iters calls salted 0..iters-1
    assert seen == ([15.0, 0.0, 3.0, 6.0, 9.0] if salt_arg == 0 else [0.0] * 5)


def test_block_until_ready_walks_nested_results():
    tree = {"a": [torch.ones(2), (torch.zeros(1), 3)], "b": None}
    assert block_until_ready(tree) is tree


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(tmp_path / "t") as d:
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    events = json.loads((d / "trace.json").read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)


def test_trace_default_directory_is_under_outputs(monkeypatch, tmp_path):
    import facerec_torch.config as C

    monkeypatch.setattr(C, "OUTPUTS_DIR", tmp_path / "outputs")
    with trace() as d:
        torch.ones(4).sum()
    assert d == tmp_path / "outputs" / "trace" and (d / "trace.json").is_file()
