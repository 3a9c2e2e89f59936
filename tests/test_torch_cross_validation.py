"""The port's cross-validation (``facerec_torch/train/cross_validation.py``)
against the JAX package's on the CPU: the same folds, the same batches in
each fold, the same ``cv_results.json`` keys, a warm start that carries the
checkpoint's weights and BatchNorm statistics, and the loop's epoch and
learning-rate schedule."""

import json

import numpy as np
import pytest
import torch

from facerec_torch.config import SchedulerConfig, TrainConfig
from facerec_torch.data.datasets import ImageFolderIndex
from facerec_torch.models import get_model
from facerec_torch.models.arcface import init_like_flax
from facerec_torch.train import cross_validation as cv
from facerec_torch.train.checkpoints import load_checkpoint, save_checkpoint
from facerec_torch.train.schedulers import get_scheduler
from facerec_tpu.config import TrainConfig as JaxTrainConfig
from facerec_tpu.data import datasets as jax_datasets
from facerec_tpu.train import cross_validation as jax_cv
from facerec_tpu.train.schedulers import get_scheduler as jax_get_scheduler


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _cfg(**kw):
    base = dict(model_type="baseline", batch_size=8, image_size=32, compute_dtype="float32")
    base.update(kw)
    return TrainConfig(**base)


@pytest.mark.parametrize("n,k,seed", [(23, 5, 42), (28, 5, 42), (10, 3, 0), (7, 7, 1), (100, 4, 9)])
def test_kfold_indices_match_jax(n, k, seed):
    got, want = cv.kfold_indices(n, k, seed), jax_cv.kfold_indices(n, k, seed)
    assert len(got) == len(want) == k
    for (tr, va), (jtr, jva) in zip(got, want):
        np.testing.assert_array_equal(tr, jtr)
        np.testing.assert_array_equal(va, jva)
    assert sorted(np.concatenate([va for _, va in got]).tolist()) == list(range(n))


def _jax_fold_batchers(index, tr, va, cfg, fold):
    """The batchers JAX's ``run_cross_validation`` builds for a fold
    (facerec_tpu/train/cross_validation.py:89-98)."""
    seed = cfg.seed + fold
    sub = jax_cv._SubsetIndex
    if cfg.model_type == "siamese":
        return (jax_datasets.SiamesePairBatcher(sub(index, tr), cfg.batch_size, cfg.image_size,
                                                seed=seed),
                jax_datasets.SiamesePairBatcher(sub(index, va), cfg.batch_size, cfg.image_size,
                                                fixed_pairs=True, seed=seed))
    return (jax_datasets.ClassificationBatcher(sub(index, tr), cfg.batch_size, cfg.image_size,
                                               seed=seed),
            jax_datasets.ClassificationBatcher(sub(index, va), cfg.batch_size, cfg.image_size,
                                               shuffle=False, seed=seed))


@pytest.mark.parametrize("model_type", ["baseline", "siamese"])
def test_fold_batches_equal_jax(synthetic_imagefolder, model_type):
    """Every train and val batch of epochs 0 and 1 of each of 3 folds, bit
    for bit: shuffled images or random pairs for training, in-order images
    or fixed pairs for validation."""
    cfg = _cfg(model_type=model_type, seed=3)
    root = synthetic_imagefolder / "train"
    index, jindex = ImageFolderIndex.build(root), jax_datasets.ImageFolderIndex.build(root)
    for fold, (tr, va) in enumerate(cv.kfold_indices(len(index), 3, seed=42)):
        port = cv.fold_batchers(index, tr, va, cfg, fold)
        ref = _jax_fold_batchers(jindex, tr, va, JaxTrainConfig.from_dict(cfg.to_dict()), fold)
        for pb, jb in zip(port, ref):
            for epoch in (0, 1):
                got, want = list(pb.epoch(epoch)), list(jb.epoch(epoch))
                assert len(got) == len(want) > 0
                for g, w in zip(got, want):
                    assert g.keys() == w.keys()
                    for key in g:
                        np.testing.assert_array_equal(g[key], w[key], err_msg=f"{fold} {key}")


def test_cv_results_keys_match_jax(synthetic_imagefolder, tmp_path):
    """Both packages' ``run_cross_validation`` on a baseline, 2 folds (the
    port's of 1 epoch; JAX's of none, which compiles no step): the same
    summary keys, fold rows and ``cv_results.json``, and a checkpoint per
    fold."""
    port = cv.run_cross_validation(_cfg(), synthetic_imagefolder, n_splits=2, epochs_per_fold=1,
                                   checkpoints_root=tmp_path / "port", device="cpu")
    ref = jax_cv.run_cross_validation(JaxTrainConfig(model_type="baseline", batch_size=8,
                                                     image_size=32, compute_dtype="float32"),
                                      synthetic_imagefolder, n_splits=2, epochs_per_fold=0,
                                      checkpoints_root=tmp_path / "jax")
    assert port.keys() == ref.keys()
    assert [f.keys() for f in port["fold_results"]] == [f.keys() for f in ref["fold_results"]]
    for key in ("model_type", "n_splits", "warm_start"):
        assert port[key] == ref[key]
    (pdir,), (jdir,) = list((tmp_path / "port").glob("cv_baseline_*")), list(
        (tmp_path / "jax").glob("cv_baseline_*"))
    pj, jj = (json.loads((d / "cv_results.json").read_text()) for d in (pdir, jdir))
    assert pj.keys() == jj.keys() and pj["mean_val_acc"] == port["mean_val_acc"]
    assert sorted(p.name for p in pdir.iterdir()) == sorted(p.name for p in jdir.iterdir())
    assert all(0.0 <= f["val_acc"] <= 1.0 for f in port["fold_results"])
    meta = load_checkpoint(pdir, "fold_1")["metadata"]
    assert meta["fold"] == 1 and meta["val_acc"] == port["fold_results"][1]["val_acc"]


def test_warm_start_carries_weights_and_statistics(synthetic_imagefolder, tmp_path):
    """With no epochs to train, each fold's checkpoint is the warm start's
    weights and BatchNorm statistics exactly; without a warm start, the
    folds start from their own seeds and differ."""
    src = get_model("baseline", num_classes=4)
    init_like_flax(src, torch.Generator().manual_seed(11))
    gen = torch.Generator().manual_seed(12)
    sd = {k: (torch.rand(v.shape, generator=gen) + 0.5 if k.endswith("running_var")
              else torch.randn(v.shape, generator=gen) if k.endswith("running_mean") else v)
          for k, v in src.state_dict().items()}
    save_checkpoint(tmp_path / "warm", "best", sd)
    res = cv.run_cross_validation(_cfg(), synthetic_imagefolder, n_splits=2, epochs_per_fold=0,
                                  warm_start_model="warm", checkpoints_root=tmp_path, device="cpu")
    assert res["warm_start"] == "warm"
    (cv_dir,) = list(tmp_path.glob("cv_baseline_*"))
    for fold in (0, 1):
        got = load_checkpoint(cv_dir, f"fold_{fold}")["model"]
        assert got.keys() == sd.keys()
        for k in sd:
            assert torch.equal(got[k], sd[k]), (fold, k)
    cold = cv.run_cross_validation(_cfg(), synthetic_imagefolder, n_splits=2, epochs_per_fold=0,
                                   checkpoints_root=tmp_path / "cold", device="cpu")
    assert cold["warm_start"] is None
    (cold_dir,) = list((tmp_path / "cold").glob("cv_baseline_*"))
    a, b = (load_checkpoint(cold_dir, f"fold_{f}")["model"] for f in (0, 1))
    assert not torch.equal(a["conv1.weight"], b["conv1.weight"])


def test_epoch_and_learning_rate_schedule_match_jax(synthetic_imagefolder, tmp_path, monkeypatch):
    """Each fold sets ``state.epoch`` before each epoch (ArcFace's margin
    reads it) and takes JAX's learning rates: one scheduler step before the
    loop, one with the val loss after each epoch."""
    calls = []

    def fake_epoch(step_fn, state, batcher, device, epoch, train, max_batches=0, prefetch=2,
                   mesh=None):
        calls.append((train, epoch, state.epoch, state.opt_state.hyperparams["learning_rate"]))
        return {"loss": 2.0 - 0.1 * epoch, "acc": 0.25 * epoch}

    monkeypatch.setattr(cv, "_run_epoch", fake_epoch)
    sched_cfg = SchedulerConfig(name="plateau", plateau_patience=0)
    res = cv.run_cross_validation(_cfg(model_type="arcface", scheduler=sched_cfg),
                                  synthetic_imagefolder, n_splits=2, epochs_per_fold=3,
                                  checkpoints_root=tmp_path, device="cpu")
    ref = jax_get_scheduler(sched_cfg, 1e-3, 3)
    lrs = [ref.step()] + [ref.step(2.0 - 0.1 * e) for e in range(3)]
    for fold in (0, 1):
        fold_calls = calls[fold * 6:(fold + 1) * 6]
        assert [(t, e, s) for t, e, s, _ in fold_calls] == [
            (True, 0, 0.0), (False, 0, 0.0), (True, 1, 1.0), (False, 1, 1.0),
            (True, 2, 2.0), (False, 2, 2.0)]
        assert [lr for t, _, _, lr in fold_calls if t] == lrs[:3]
    assert res["fold_results"][0]["val_acc"] == 0.5
    assert get_scheduler(sched_cfg, 1e-3, 3).step() == lrs[0]
