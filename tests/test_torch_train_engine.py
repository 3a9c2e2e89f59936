"""The port's ``train_model`` end to end on the CPU, as ``tests/test_train.py``
drives the JAX engine: a baseline learns and leaves the JAX package's
artifacts; ArcFace's phase 1 freezes the backbone and a resumed run carries
the optimizer state across the transition; a resumed run ends where an
uninterrupted one does; a trained ArcFace serves through ``build_embedder``;
and the schedulers, early stopping and configs match the JAX package's."""

import csv
import json
import math
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from facerec_torch.config import ArcFaceConfig, MeshConfig, OptimizerConfig, SchedulerConfig, TrainConfig
from facerec_torch.data.synthetic import write_synthetic_imagefolder
from facerec_torch.models import get_model
from facerec_torch.models.arcface import build_embedder
from facerec_torch.train.checkpoints import load_checkpoint, restore_into
from facerec_torch.train.early_stopping import EarlyStopping
from facerec_torch.train.engine import train_model
from facerec_torch.train.schedulers import get_scheduler
from facerec_torch.train.state import create_train_state
from facerec_tpu.config import TrainConfig as JaxTrainConfig
from facerec_tpu.train.early_stopping import EarlyStopping as JaxEarlyStopping
from facerec_tpu.train.results import TRAIN_CSV_HEADER
from facerec_tpu.train.schedulers import get_scheduler as jax_get_scheduler

REPO = Path(__file__).resolve().parent.parent
# the keys of the JAX engine's model_info.json (facerec_tpu/train/engine.py:364-378)
MODEL_INFO_KEYS = {"model_name", "model_type", "num_classes", "image_size", "batch_size",
                   "epochs_trained", "best_val_acc", "parameters", "datasets", "config",
                   "total_time_sec", "test_loss", "test_acc", "saved_at"}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _cfg(**kw):
    base = dict(model_type="baseline", batch_size=16, epochs=3, image_size=32, seed=0,
                early_stopping=False, checkpoint_every=0, compute_dtype="float32",
                optimizer=OptimizerConfig(learning_rate=3e-3),
                scheduler=SchedulerConfig(name="cosine"))
    base.update(kw)
    return TrainConfig(**base)


def test_train_baseline_e2e(synthetic_imagefolder, tmp_path):
    out = train_model(_cfg(), synthetic_imagefolder, checkpoints_root=tmp_path,
                      model_name="baseline_t", device="cpu")
    hist = out["history"]
    assert len(hist) == 3
    assert hist[-1]["train_loss"] < hist[0]["train_loss"]
    model_dir = tmp_path / "baseline_t"
    with (model_dir / "metrics" / "training_metrics.csv").open() as f:
        rows = list(csv.reader(f))
    assert rows[0] == TRAIN_CSV_HEADER and len(rows) == 4
    info = json.loads((model_dir / "model_info.json").read_text())
    assert set(info) == MODEL_INFO_KEYS
    assert info["model_type"] == "baseline" and info["num_classes"] == 4
    assert info["config"] == JaxTrainConfig.from_dict(info["config"]).to_dict()
    assert (model_dir / "final" / "metadata.json").exists()
    assert (model_dir / "metrics" / "learning_curves.csv").exists()
    cm = json.loads((model_dir / "metrics" / "confusion_matrix.json").read_text())["matrix"]
    assert np.asarray(cm).sum() == 4  # one test image per class
    ck = load_checkpoint(model_dir)  # best, then final
    assert "model" in ck and ck["metadata"]["model_type"] == "baseline"
    assert out["summary"]["parameters"]["total"] == sum(
        p.numel() for p in get_model("baseline", num_classes=4).parameters())


def _arc_cfg(epochs):
    return _cfg(model_type="arcface", epochs=epochs, checkpoint_every=1, keep_checkpoints=5,
                resume=True,
                arcface=ArcFaceConfig(two_phase=True, two_phase_epoch=1, warmup_epochs=4),
                optimizer=OptimizerConfig(name="adamw", amsgrad=True, learning_rate=1e-3),
                scheduler=SchedulerConfig(name="warmup_cosine", warmup_epochs=1))


@pytest.fixture(scope="module")
def arcface_run(synthetic_imagefolder, tmp_path_factory):
    """An arcface run of one epoch (all phase 1), then resumed to two (the
    second in phase 2)."""
    root = tmp_path_factory.mktemp("arc_ck")
    first = train_model(_arc_cfg(1), synthetic_imagefolder, checkpoints_root=root,
                        model_name="arc_r", device="cpu")
    second = train_model(_arc_cfg(2), synthetic_imagefolder, checkpoints_root=root,
                         model_name="arc_r", device="cpu")
    return root / "arc_r", first, second


def _params(sd, prefix, included=True):
    return {k: v for k, v in sd.items()
            if k.startswith(prefix) == included and not k.endswith(
                ("running_mean", "running_var", "num_batches_tracked"))}


def test_arcface_phase_one_freezes_the_backbone(arcface_run):
    """After the phase-1 epoch the backbone's parameters are their initial
    values, shrunk only by the decoupled weight decay (2 steps at lr 1e-3,
    decay 1e-4: a factor 1 - 2e-7); the head has moved."""
    model_dir, first, _ = arcface_run
    cfg = _arc_cfg(1)
    init = create_train_state(
        get_model("arcface", num_classes=4,
                  arcface_kwargs=dict(margin=0.5, scale=32.0, easy_margin=True,
                                      progressive_margin=True, warmup_epochs=4)),
        cfg, "arcface", torch.device("cpu")).model.state_dict()
    after = load_checkpoint(model_dir, "epoch_0")["model"]
    assert first["state"].step == 2 and first["state"].opt_state.hyperparams["backbone_scale"] == 1.0
    for k, v in _params(after, "backbone.").items():
        torch.testing.assert_close(v, init[k] * (1 - 2e-7), rtol=1e-6, atol=1e-9, msg=k)
    for k, v in _params(after, "backbone.", included=False).items():
        assert (v - init[k]).abs().max() > 1e-4, k


def test_resume_arcface_opt_state_roundtrip(arcface_run):
    """The resumed run starts at epoch 1 with the AMSGrad moments and the
    phase-2 hyperparameters restored, and moves the backbone."""
    model_dir, _, second = arcface_run
    assert second["history"][0]["epoch"] == 1 and len(second["history"]) == 1
    assert np.isfinite(second["history"][0]["train_loss"])
    hp = second["state"].opt_state.hyperparams
    assert hp["backbone_scale"] == 1.0 and second["state"].step == 4
    before = load_checkpoint(model_dir, "epoch_0")["model"]
    after = second["model"].state_dict()
    assert all((after[k] - v).abs().max() > 1e-5 for k, v in _params(before, "backbone.").items()
               if k.endswith("conv1.weight"))
    tree, meta = restore_into(model_dir, "epoch_1", second["model"], second["state"].opt_state)
    assert meta["has_opt_state"] and "opt_state" in tree and meta["step"] == 4
    assert set(tree["opt_state"]["slots"]) == {"mu", "nu", "nu_max"}


def test_trained_arcface_serves(arcface_run):
    """The final checkpoint of the port's arcface run loads into
    ``build_embedder`` and embeds as the trained model does."""
    model_dir, _, second = arcface_run
    emb = build_embedder(checkpoint=model_dir / "final", dtype=torch.float32, device="cpu")
    crops = torch.from_numpy(np.random.default_rng(0).uniform(0, 255, (3, 32, 32, 3))
                             .astype(np.float32))
    with torch.no_grad():
        got = emb.embed(crops)
        ref = second["model"].eval().embed(crops)
    assert got.shape == (3, 512) and torch.isfinite(got).all()
    torch.testing.assert_close(got.norm(dim=1), torch.ones(3))
    torch.testing.assert_close(got, ref)
    assert emb.arc_weight.shape == (4, 512)


def test_resume_matches_uninterrupted(tmp_path):
    """4 epochs straight against 2, then a resume to 4: the same
    parameters, step and LR. SGD with momentum, so that the trace tests the
    restored optimizer state; StepLR flips the LR at the resume boundary;
    the baseline's dropout draws follow (seed, step)."""
    root = write_synthetic_imagefolder(tmp_path / "ds", num_classes=3, per_class=8, size=32, seed=5)

    def cfg(epochs):
        return _cfg(epochs=epochs, batch_size=8, checkpoint_every=1, keep_checkpoints=5,
                    resume=True,
                    optimizer=OptimizerConfig(name="sgd", momentum=0.9, learning_rate=1e-2,
                                              use_grad_clip=False),
                    scheduler=SchedulerConfig(name="step", step_size=2, gamma=0.1))

    straight = train_model(cfg(4), root, checkpoints_root=tmp_path / "a", model_name="m",
                           device="cpu")
    train_model(cfg(2), root, checkpoints_root=tmp_path / "b", model_name="m", device="cpu")
    resumed = train_model(cfg(4), root, checkpoints_root=tmp_path / "b", model_name="m",
                          device="cpu")
    assert resumed["history"][0]["epoch"] == 2
    for row_s, row_r in zip(straight["history"][2:], resumed["history"]):
        assert row_s["train_loss"] == pytest.approx(row_r["train_loss"], rel=1e-5)
        assert row_s["val_loss"] == pytest.approx(row_r["val_loss"], rel=1e-5)
        assert row_s["lr"] == pytest.approx(row_r["lr"])
    ps, pr = straight["model"].state_dict(), resumed["model"].state_dict()
    for k in ps:
        torch.testing.assert_close(ps[k], pr[k], atol=1e-6, rtol=0, msg=k)
    assert straight["state"].step == resumed["state"].step == 4 * 3  # 18 images, batch 8
    assert (straight["state"].opt_state.hyperparams["learning_rate"]
            == resumed["state"].opt_state.hyperparams["learning_rate"])


# A mesh that does not fit a world of one rank is refused by build_mesh, as
# JAX's build_mesh refuses it on one device (tests/test_torch_parallel.py
# trains on meshes that fit).
@pytest.mark.parametrize("change,match", [
    (dict(mesh=MeshConfig(data_parallel=2, model_parallel=2)), "does not divide world size 1"),
    (dict(mesh=MeshConfig(data_parallel=2)), "!= world size 1"),
    (dict(mesh=MeshConfig(model_parallel=2)), "does not divide world size 1"),
    pytest.param(dict(use_lr_finder=True, mesh=MeshConfig(data_parallel=2)), "!= world size 1",
                 id="change3-LR finder"),
])
def test_train_model_refuses_what_is_not_ported(synthetic_imagefolder, tmp_path, change, match):
    from facerec_tpu.parallel.mesh import build_mesh as jax_build_mesh

    with pytest.raises(ValueError):  # the JAX package refuses the same mesh on one device
        jax_build_mesh(change["mesh"], devices=jax.devices()[:1])
    with pytest.raises(ValueError, match=match):
        train_model(_cfg(**change), synthetic_imagefolder, checkpoints_root=tmp_path, device="cpu")


def test_train_model_refuses_cpu_fallback(synthetic_imagefolder, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the refusal is for machines without one")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_model(_cfg(), synthetic_imagefolder, checkpoints_root=tmp_path)


def test_train_config_matches_jax():
    """The arcface_synth configuration, as model_info.json recorded it, reads
    into the port's config and writes back the same dict as the JAX one."""
    info = json.loads((REPO / "outputs/checkpoints/arcface_synth/model_info.json").read_text())
    cfg = TrainConfig.from_dict(info["config"])
    assert cfg.to_dict() == JaxTrainConfig.from_dict(info["config"]).to_dict() == info["config"]
    assert TrainConfig().to_dict() == JaxTrainConfig().to_dict()
    assert cfg.arcface.margin == 0.3 and cfg.scheduler.name == "warmup_cosine"


@pytest.mark.parametrize("name", ["cosine", "step", "exponential", "plateau", "one_cycle",
                                  "warmup_cosine", "constant"])
def test_schedulers_match_jax(name):
    cfg = SchedulerConfig(name=name, warmup_epochs=2, step_size=3, plateau_patience=1)
    from facerec_tpu.config import SchedulerConfig as JaxSchedulerConfig

    ours = get_scheduler(cfg, 1e-2, 12)
    ref = jax_get_scheduler(JaxSchedulerConfig(**cfg.to_dict()), 1e-2, 12)
    losses = [1.0, 0.9, 0.95, 0.97, 0.96, 0.8, 0.85, 0.9, 0.9, 0.9, 0.7, 0.75]
    assert [ours.step(v) for v in losses] == [ref.step(v) for v in losses]
    restored = get_scheduler(cfg, 1e-2, 12)
    restored.load_state_dict(json.loads(json.dumps(ours.state_dict())))
    assert restored.step(0.5) == ours.step(0.5)


def test_early_stopping_matches_jax():
    values = [1.0, 0.9, 0.95, 0.92, 0.91, 0.97, 0.99]
    for mode in ("min", "max"):
        ours, ref = EarlyStopping(patience=2, mode=mode, trace=True), JaxEarlyStopping(
            patience=2, mode=mode, trace=True)
        assert [ours(v) for v in values] == [ref(v) for v in values]
        assert ours.state_dict() == ref.state_dict()
    restored = EarlyStopping(patience=2)
    restored.load_state_dict(json.loads(json.dumps(ours.state_dict())))
    assert restored.counter == ours.counter and math.isfinite(restored.best)
