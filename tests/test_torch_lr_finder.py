"""The port's LR range test (``facerec_torch/train/lr_finder.py``) against the
JAX package's (``facerec_tpu/train/lr_finder.py``) on the CPU: the analysis
of the same loss curves, the sweep's stop rules on the same scripted steps,
a real 12-step sweep of a baseline net from the same weights on the same
batches, and ``train_model``'s pre-pass, which must leave the trained model
exactly as a run started at the suggested rate leaves it."""

import functools
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facerec_torch.config import OptimizerConfig, SchedulerConfig, TrainConfig
from facerec_torch.convert import from_jax
from facerec_torch.data.datasets import ClassificationBatcher, ImageFolderIndex
from facerec_torch.models import get_model
from facerec_torch.models.baseline import BaselineNet
from facerec_torch.train.engine import _make_batchers, train_model
from facerec_torch.train.lr_finder import MODEL_LR_LIMITS, LearningRateFinder, find_optimal_lr
from facerec_torch.train.state import create_train_state, set_hyperparam
from facerec_torch.train.steps import make_train_step
from facerec_tpu.data.datasets import ClassificationBatcher as JaxClassificationBatcher
from facerec_tpu.data.datasets import ImageFolderIndex as JaxImageFolderIndex
from facerec_tpu.models.baseline import BaselineNet as JaxBaselineNet
from facerec_tpu.train import lr_finder as jax_lr_finder
from facerec_tpu.train import state as jax_state
from facerec_tpu.train import steps as jax_steps
from torch_zoo import jax_train_state, np_tree, port_train_state, random_stats

ADAM = dict(name="adam", learning_rate=1e-3)
SWEEP_RTOL = 1e-4  # the real sweep's losses, port against JAX


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _curve(kind: str) -> list[float]:
    """Loss curves for ``analyze``: too short to analyse; one that falls
    then rises past 3x its minimum; one that falls and never rises 3x;
    one that only rises."""
    x = np.linspace(0.0, 1.0, 40)
    return {"short": [2.3, 2.2, 2.1, 2.0],
            "rises_past_3x": list(2.3 - 1.8 * x + 40.0 * np.maximum(x - 0.6, 0.0) ** 2),
            "never_3x": list(2.3 - 1.5 * x + 0.3 * np.sin(7 * x)),
            "only_rises": list(1.0 + x ** 2)}[kind]


@pytest.mark.parametrize("kind", ["short", "rises_past_3x", "never_3x", "only_rises"])
@pytest.mark.parametrize("model_type", ["baseline", "arcface", "siamese"])
def test_analyze_matches_jax(kind, model_type):
    losses = _curve(kind)
    lrs = list(1e-7 * (10.0 ** (7 * np.arange(len(losses)) / max(len(losses) - 1, 1))))
    port, ref = LearningRateFinder(model_type), jax_lr_finder.LearningRateFinder(model_type)
    port.lrs, port.losses, ref.lrs, ref.losses = list(lrs), list(losses), list(lrs), list(losses)
    got, want = port.analyze(), ref.analyze()
    assert got == want
    assert got["valid"] == (kind != "short")
    if kind == "rises_past_3x":
        assert got["max_lr"] < lrs[-1]
    if kind == "never_3x":
        assert got["max_lr"] == lrs[-1]


def test_analyze_box_filter_matches_jax(monkeypatch):
    """Where scipy's filter raises, both fall back to the 5-tap box filter."""
    import scipy.signal

    def broken(*a, **k):
        raise ValueError("no filter")

    monkeypatch.setattr(scipy.signal, "savgol_filter", broken)
    losses = _curve("rises_past_3x")
    lrs = list(1e-7 * (10.0 ** (7 * np.arange(len(losses)) / (len(losses) - 1))))
    port, ref = LearningRateFinder("baseline"), jax_lr_finder.LearningRateFinder("baseline")
    port.lrs, port.losses, ref.lrs, ref.losses = list(lrs), list(losses), list(lrs), list(losses)
    assert port.analyze() == ref.analyze()


def test_limits_match_jax():
    assert MODEL_LR_LIMITS == jax_lr_finder.MODEL_LR_LIMITS
    for mt in ("baseline", "arcface", "siamese", "hybrid"):
        port, ref = LearningRateFinder(mt), jax_lr_finder.LearningRateFinder(mt)
        assert vars(port) == vars(ref)


# scripted per-step losses; the sweep's stop rules as JAX's code has them
SCRIPTS = {
    "finite": [2.3, 2.2, 2.0, 1.7, 1.5, 1.4, 1.3, 1.35, 1.5, 1.9, 2.4, 3.0],
    "nan": [2.3, 2.1, 1.9, float("nan"), 1.0, 1.0],
    "inf": [2.3, 2.1, float("inf"), 1.0],
    "above_4x_best": [2.0, 1.0, 0.5, 2.5, 0.1],  # only the hard 4x stop
    "above_16x_best": [2.0, 1.0, 0.5, 9.0, 0.1],  # both divergence rules
    "negative_first": [-1.0, 2.0, 1.0],  # divergence_factor * 4 * min(inf, loss) < loss
    "batches_run_out": [2.3, 2.2, 2.1],
}


def _scripted(losses, to_metrics):
    it = iter(losses)

    def step(state, batch):
        v = next(it)
        state.seen.append(batch)
        return to_metrics(v)

    return step


@pytest.mark.parametrize("script", list(SCRIPTS))
@pytest.mark.parametrize("model_type", ["baseline", "arcface"])
def test_find_stop_rules_match_jax(script, model_type):
    """The same scripted losses through each package's ``find``: the same
    LRs set, the same losses kept, the same stop and the same analysis."""
    losses = SCRIPTS[script]
    n_batches = len(losses)
    runs = []
    for pkg in ("port", "jax"):
        set_lrs = []
        state = types.SimpleNamespace(opt_state=object(), seen=[])
        if pkg == "port":
            finder = LearningRateFinder(model_type, num_steps=10)
            step = _scripted(losses, lambda v: {"loss_sum": torch.tensor(v * 8, dtype=torch.float32),
                                                "count": torch.tensor(8.0)})
            out = finder.find(state, step, range(n_batches), lambda os, lr: set_lrs.append(lr))
        else:
            finder = jax_lr_finder.LearningRateFinder(model_type, num_steps=10)
            step = _scripted(losses, lambda v: {"loss_sum": np.float32(v * 8),
                                                "count": np.float32(8.0)})
            out = finder.find(state, lambda s, b: (s, step(s, b)), range(n_batches),
                              lambda os, lr: set_lrs.append(lr))
        runs.append((finder.lrs, finder.losses, set_lrs, state.seen, out))
    (lrs, l, s, seen, out), (jlrs, jl, js, jseen, jout) = runs
    assert lrs == jlrs == s == js and seen == jseen
    np.testing.assert_array_equal(l, jl)
    assert out.keys() == jout.keys() and out["valid"] == jout["valid"]
    for k in out:
        np.testing.assert_array_equal(np.asarray(out[k], float), np.asarray(jout[k], float), k)


# ------------------------------------------------------------- a real sweep

@pytest.fixture(scope="module")
def sweep_batches(synthetic_imagefolder):
    """Each package's batches of three epochs of the train split (28 images,
    batch 8: 4 batches an epoch), 32 px."""
    root = synthetic_imagefolder / "train"
    jb = JaxClassificationBatcher(JaxImageFolderIndex.build(root), 8, 32, shuffle=True, seed=0)
    tb = ClassificationBatcher(ImageFolderIndex.build(root), 8, 32, shuffle=True, seed=0)
    return ([b for e in range(3) for b in jb.epoch(e)], [b for e in range(3) for b in tb.epoch(e)])


def test_sweep_matches_jax(sweep_batches):
    """12 sweep steps from 1e-7 to 1e-3 of a baseline net (f32, dropout 0,
    Adam) from the same weights on the same batches: the LRs exactly
    equal, the losses within ``SWEEP_RTOL`` relative, and the analysis's
    indices equal."""
    jb, tb = sweep_batches
    jnet = JaxBaselineNet(num_classes=4, dropout_rate=0.0)
    v = jax.jit(functools.partial(jnet.init, train=False))(
        {"params": jax.random.key(3), "dropout": jax.random.key(4)}, jnp.zeros((1, 32, 32, 3)))
    v = {"params": np_tree(v["params"]), "batch_stats": random_stats(v["batch_stats"], 5)}
    ref = jax_lr_finder.LearningRateFinder("baseline", end_lr=1e-3, num_steps=12)
    ref.find(jax_train_state(v, "baseline", ADAM), jax.jit(jax_steps.make_train_step(jnet, "baseline")),
             (jax.tree_util.tree_map(jnp.asarray, b) for b in jb),
             lambda os, lr: jax_state.set_hyperparam(os, "learning_rate", lr))

    net = BaselineNet(num_classes=4, dropout_rate=0.0)
    net.load_state_dict(from_jax(v, "baseline"))
    port = LearningRateFinder("baseline", end_lr=1e-3, num_steps=12)
    got = port.find(port_train_state(net, "baseline", ADAM), make_train_step("baseline", "float32"),
                    ({k: torch.from_numpy(x) for k, x in b.items()} for b in tb),
                    lambda os, lr: set_hyperparam(os, "learning_rate", lr))
    assert len(port.lrs) == 12 and port.lrs == ref.lrs
    np.testing.assert_allclose(port.losses, ref.losses, rtol=SWEEP_RTOL, atol=0)
    want = ref.analyze()
    assert got["valid"] and got["steepest_idx"] == want["steepest_idx"]
    assert got["suggested_lr"] == want["suggested_lr"]


# --------------------------------------------------- the pre-pass in train_model

def _cfg(**kw):
    base = dict(model_type="baseline", batch_size=8, epochs=2, image_size=32, seed=5,
                early_stopping=False, checkpoint_every=0, compute_dtype="float32",
                optimizer=OptimizerConfig(learning_rate=3e-3), scheduler=SchedulerConfig(name="cosine"))
    base.update(kw)
    return TrainConfig(**base)


def test_train_model_lr_finder_equals_the_run_at_its_suggestion(synthetic_imagefolder, tmp_path):
    """``train_model(use_lr_finder=True)`` sweeps a probe of its own: the
    model it trains ends bit for bit where a run started at the suggested
    rate ends (every parameter and BatchNorm statistic, and the history),
    and ``lr_finder.json`` is the sweep of a model initialised from
    ``seed + 1`` over the trainer's own train batcher."""
    with_finder = train_model(_cfg(use_lr_finder=True), synthetic_imagefolder,
                              checkpoints_root=tmp_path, model_name="lrf", device="cpu")
    analysis = json.loads((tmp_path / "lrf" / "metrics" / "lr_finder.json").read_text())
    assert analysis["valid"] and 0 < analysis["suggested_lr"] <= 1e-2
    suggested = analysis["suggested_lr"]
    plain = train_model(_cfg(optimizer=OptimizerConfig(learning_rate=suggested)),
                        synthetic_imagefolder, checkpoints_root=tmp_path, model_name="at_lr",
                        device="cpu")
    a, b = with_finder["model"].state_dict(), plain["model"].state_dict()
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    drop = lambda rows: [{k: v for k, v in r.items() if k != "time_elapsed"} for r in rows]  # noqa: E731
    assert drop(with_finder["history"]) == drop(plain["history"])
    assert with_finder["state"].step == plain["state"].step

    cfg = _cfg()
    batcher = _make_batchers(synthetic_imagefolder, cfg)[0]["train"]
    probe = get_model("baseline", num_classes=4)
    state = create_train_state(probe, cfg.replace(seed=cfg.seed + 1), "baseline", torch.device("cpu"))
    direct = find_optimal_lr(probe, "baseline", state, batcher, device="cpu", compute_dtype="float32")
    assert direct["lrs"] == analysis["lrs"] and direct["losses"] == analysis["losses"]
    assert direct["suggested_lr"] == suggested
