"""K-fold cross-validation (counterpart of ``facerec_tpu/train/cross_validation.py``).

The JAX package's behaviour: KFold(n_splits, shuffle, seed 42) over the
train split in its fold order, a model per fold initialised from
``seed + fold``, an optional warm start from an existing model's best (else
final) checkpoint (parameters and BatchNorm statistics, not the optimizer),
a shortened loop per fold (one scheduler step before it and one with the
val loss after each epoch, ``state.epoch`` set before each epoch for
ArcFace's progressive margin), each fold's checkpoint, and the per-fold
results with their mean and std in ``cv_results.json``. Folds load through
``ClassificationBatcher`` (PIL) or ``SiamesePairBatcher``, as JAX's do.
Over a mesh (``config.mesh``, as ``train_model``) every fold trains
data-parallel; rank 0 names the run directory and writes the files.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch

from facerec_torch.config import CHECKPOINTS_DIR, TrainConfig, logger
from facerec_torch.data.datasets import ClassificationBatcher, ImageFolderIndex, SiamesePairBatcher
from facerec_torch.models import get_model
from facerec_torch.parallel.collectives import broadcast_object
from facerec_torch.parallel.mesh import Mesh, shard_params
from facerec_torch.train.checkpoints import load_checkpoint, save_checkpoint
from facerec_torch.train.engine import _quiet, _run_epoch, mesh_for
from facerec_torch.train.schedulers import get_scheduler
from facerec_torch.train.state import create_train_state, set_hyperparam
from facerec_torch.train.steps import make_eval_step, make_train_step


def kfold_indices(n: int, n_splits: int = 5, seed: int = 42) -> list[tuple[np.ndarray, np.ndarray]]:
    """sklearn KFold(shuffle=True) semantics: shuffled order, contiguous
    folds, the first n % n_splits folds one element larger."""
    order = np.random.default_rng(seed).permutation(n)
    sizes = np.full(n_splits, n // n_splits)
    sizes[: n % n_splits] += 1
    folds, start = [], 0
    for s in sizes:
        folds.append(order[start : start + s])
        start += s
    return [(np.concatenate([f for j, f in enumerate(folds) if j != i]), folds[i]) for i in range(n_splits)]


class _SubsetIndex:
    """View over an ImageFolderIndex restricted to given rows."""

    def __init__(self, index: ImageFolderIndex, rows: np.ndarray):
        self.root = index.root
        self.paths = [index.paths[i] for i in rows]
        self.labels = index.labels[rows]
        self.class_names = index.class_names

    def __len__(self):
        return len(self.paths)

    @property
    def num_classes(self):
        return len(self.class_names)


def fold_batchers(index: ImageFolderIndex, tr: np.ndarray, va: np.ndarray, config: TrainConfig,
                  fold: int):
    """The train and val batchers of one fold, seeded from ``seed + fold``:
    shuffled train and in-order val images, or random train pairs and fixed
    val pairs for siamese."""
    seed = config.seed + fold
    if config.model_type == "siamese":
        return (SiamesePairBatcher(_SubsetIndex(index, tr), config.batch_size, config.image_size,
                                   seed=seed),
                SiamesePairBatcher(_SubsetIndex(index, va), config.batch_size, config.image_size,
                                   fixed_pairs=True, seed=seed))
    return (ClassificationBatcher(_SubsetIndex(index, tr), config.batch_size, config.image_size,
                                  seed=seed),
            ClassificationBatcher(_SubsetIndex(index, va), config.batch_size, config.image_size,
                                  shuffle=False, seed=seed))


def run_cross_validation(
    config: TrainConfig,
    dataset_dir: str | Path,
    n_splits: int = 5,
    epochs_per_fold: int = 15,
    warm_start_model: str | None = None,
    checkpoints_root: str | Path | None = None,
    device: str | torch.device | None = None,
    mesh: Mesh | None = None,
) -> dict[str, Any]:
    """``n_splits``-fold cross-validation of ``config``'s model over
    ``dataset_dir/train`` on ``device`` (default: the CUDA card), over
    ``mesh`` (default: ``config.mesh`` over the process group's ranks);
    writes each fold's checkpoint and ``cv_results.json`` under
    ``<checkpoints_root>/cv_<type>_<time>`` and returns the summary."""
    mesh = mesh_for(config, device, mesh)
    dev = mesh.device
    log = logger.info if mesh.is_primary else _quiet
    ckroot = Path(checkpoints_root or CHECKPOINTS_DIR)
    index = ImageFolderIndex.build(Path(dataset_dir) / "train")
    num_classes = index.num_classes

    warm = None
    if warm_start_model:
        warm = load_checkpoint(ckroot / warm_start_model)["model"]  # best, then final
        log("CV warm-start from %s", warm_start_model)

    cv_dir = ckroot / broadcast_object(f"cv_{config.model_type}_{int(time.time())}", mesh)
    if mesh.is_primary:
        cv_dir.mkdir(parents=True, exist_ok=True)
    train_step = make_train_step(config.model_type, config.compute_dtype, mesh)
    eval_step = make_eval_step(config.model_type, config.compute_dtype, mesh=mesh)
    fold_results = []
    for fold, (tr, va) in enumerate(kfold_indices(len(index), n_splits, seed=42)):
        t0 = time.time()
        tr_b, va_b = fold_batchers(index, tr, va, config, fold)
        # a model of the fold's own: the step changes the one it trains
        model = get_model(config.model_type, num_classes=num_classes,
                          param_dtype=config.param_dtype)
        state = create_train_state(model, config.replace(seed=config.seed + fold),
                                   config.model_type, dev)
        if warm is not None:
            model.load_state_dict(warm)
        shard_params(model, mesh)
        sched = get_scheduler(config.scheduler, config.optimizer.learning_rate, epochs_per_fold)
        lr = sched.step()
        set_hyperparam(state.opt_state, "learning_rate", lr)

        best_acc = 0.0
        for epoch in range(epochs_per_fold):
            state.epoch = float(epoch)
            _run_epoch(train_step, state, tr_b, dev, epoch, True, prefetch=config.prefetch_depth,
                       mesh=mesh)
            val = _run_epoch(eval_step, state, va_b, dev, epoch, False,
                             prefetch=config.prefetch_depth, mesh=mesh)
            best_acc = max(best_acc, val["acc"])
            lr = sched.step(val["loss"])
            set_hyperparam(state.opt_state, "learning_rate", lr)
        if mesh.is_primary:
            save_checkpoint(cv_dir, f"fold_{fold}", model.state_dict(),
                            metadata={"fold": fold, "val_acc": best_acc})
        fold_results.append({"fold": fold, "val_acc": best_acc, "time_sec": round(time.time() - t0, 1)})
        log("CV fold %d/%d: val_acc=%.4f", fold + 1, n_splits, best_acc)

    accs = [f["val_acc"] for f in fold_results]
    summary = {
        "model_type": config.model_type,
        "n_splits": n_splits,
        "epochs_per_fold": epochs_per_fold,
        "fold_results": fold_results,
        "mean_val_acc": float(np.mean(accs)),
        "std_val_acc": float(np.std(accs)),
        "warm_start": warm_start_model,
    }
    if mesh.is_primary:
        (cv_dir / "cv_results.json").write_text(json.dumps(summary, indent=2))
    log("CV done: %.4f +/- %.4f", summary["mean_val_acc"], summary["std_val_acc"])
    mesh.barrier()
    return summary
