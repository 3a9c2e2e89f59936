"""``facerec_torch.bench_train`` (the counterpart of ``tools/bench_train.py``)
on the CPU: the JAX tool's batch pool, its JSON keys, and the timed step
being the trainer's own (``make_train_step``)."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from facerec_torch import bench_train
from facerec_torch.train import steps
from facerec_tpu.config import MeshConfig
from facerec_tpu.parallel.mesh import build_mesh

REPO = Path(__file__).resolve().parent.parent
# the JAX tool's line
KEYS = ("model", "batch", "image", "train_step_ms", "train_imgs_per_sec", "eval_step_ms",
        "eval_imgs_per_sec", "backend", "devices", "compile_s")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jax_tool(tmp_path_factory):
    """``tools/bench_train.py`` as a module; it sets a compilation cache
    directory in the environment when imported, which is kept out of this
    process's environment."""
    with pytest.MonkeyPatch.context() as m:
        m.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path_factory.mktemp("jax_cache")))
        spec = importlib.util.spec_from_file_location("jax_bench_train",
                                                      REPO / "tools" / "bench_train.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("model_type", ["arcface", "siamese"])
def test_pool_equals_jax_make_batches(jax_tool, model_type):
    ref = jax_tool.make_batches(model_type, 8, 16, 3, build_mesh(MeshConfig()))
    got = bench_train.make_batches(model_type, 8, 16, 3, torch.device("cpu"))
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        assert list(g) == list(r)
        for k in r:
            a, b = g[k].numpy(), np.asarray(r[k])
            assert a.dtype == b.dtype and np.array_equal(a, b), k


@pytest.mark.parametrize("model_type", ["arcface", "siamese", "baseline"])
def test_line_has_the_jax_keys_and_times_the_trainers_step(monkeypatch, model_type):
    """Batch 4 at 32 px, 2 timed steps a turn: the JAX tool's keys, and every
    timed train step a call of the ``TrainStep`` that ``make_train_step``
    made (replayed on a card, eager here), in turns with its eager body."""
    made, calls = [], {"captured": 0, "eager": 0}
    real_make, real_call, real_eager = (steps.make_train_step, steps.TrainStep.__call__,
                                        steps.TrainStep.eager)

    def making(*args, **kwargs):
        made.append(real_make(*args, **kwargs))
        return made[-1]

    def calling(self, state, batch):
        calls["captured"] += 1
        return real_call(self, state, batch)

    def eager(self, state, batch):
        calls["eager"] += 1
        return real_eager(self, state, batch)

    monkeypatch.setattr(steps, "make_train_step", making)
    monkeypatch.setattr(steps.TrainStep, "__call__", calling)
    monkeypatch.setattr(steps.TrainStep, "eager", eager)
    monkeypatch.setattr(bench_train, "WARMUP", 1)
    out, note = bench_train.run(model_type, batch=4, image=32, steps=2, device="cpu")
    assert tuple(out) == KEYS
    assert (out["model"], out["batch"], out["image"], out["backend"], out["devices"]) == (
        model_type, 4, 32, "cpu", 1)
    assert out["train_step_ms"] > 0 and out["eval_step_ms"] > 0
    # the step's images/s from the captured turns, rounded to 0.1 as the JAX tool's format
    # rounds it (its rounded train_step_ms alone can be 1.4% off at a second a step)
    step_ms = sum(note["train_step_ms_turns"]) / 2
    assert out["train_step_ms"] == round(step_ms, 2)
    assert out["train_imgs_per_sec"] == round(4 / (step_ms * 1e-3), 1)
    assert [(s.model_type, s.compute_dtype) for s in made] == [(model_type, "bfloat16")]
    # warm-up 1, then captured and eager in turns (captured, eager, eager, captured), 2 each;
    # the eager body's own calls add to "eager" for every call on the CPU
    assert calls["captured"] == 1 + 2 * 2
    assert calls["eager"] == calls["captured"] + 1 + 2 * 2
    assert note["timing"] == "host_clock" and note["card"] == "cpu"
    assert len(note["train_step_ms_turns"]) == len(note["eager_step_ms_turns"]) == 2
    assert note["captured_busy_share"] is None and note["captured_device_ms_per_step"] is None
