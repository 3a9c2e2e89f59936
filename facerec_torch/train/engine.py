"""Training engine: ``train_model`` (counterpart of ``facerec_tpu/train/engine.py``).

One train step per batch on each rank of a process mesh (one rank and
one device without a launcher), a background input thread that
keeps the next batches on the card, and per-epoch host control
(schedulers, early stopping, the two-phase transition) applied through the
optimizer's hyperparameters. The behaviour follows the JAX engine:

  * sequential multi-dataset training and auto versioning ``{type}_v{n}``;
  * model-aware clipping and ArcFace's clip schedule,
    min(clip, 0.5 + 0.05 epoch) for the first 10 epochs;
  * the ArcFace two-phase transition at max(10, epochs // 3) (or
    ``two_phase_epoch``), which unfreezes the backbone and halves the LR;
  * the best checkpoint on val accuracy, the per-epoch metrics CSV, early
    stopping on val loss, periodic full checkpoints with full resume
    (parameters, BN statistics, optimizer moments and hyperparameters,
    scheduler and stopper), the final save, the test evaluation, the
    confusion matrix and ``model_info.json``.

It trains all seven model types. Images load as the JAX engine loads them:
through the native JPEG loader (``data/native_loader.py``) when it builds
and every path of a split is a JPEG, otherwise through
``ClassificationBatcher`` (PIL), so that both trainers see the same
batches; a siamese model trains on ``SiamesePairBatcher``'s random pairs
and is validated and tested on its fixed pairs, and its epoch log and
history carry the same-pair and different-pair accuracies. With
``use_lr_finder`` a range test runs first on a probe model of its own
(initialised from ``seed + 1``, as the JAX engine's probe state is), writes
``metrics/lr_finder.json`` and, when its analysis is valid, starts the
schedule from the suggested rate; the model being trained is untouched by
it.

The mesh (``config.mesh``, built by ``parallel.mesh.build_mesh`` over the
ranks of the process group, or ``mesh=``) is the JAX engine's: the global
``batch_size`` is split over the data ranks, each of which reads the global
batch and keeps its slice, and the steps sum what one process would compute
on the global batch, so every rank sees the same metrics, takes the same
early-stopping and checkpoint decisions and holds the same parameters
(``shard_params`` broadcasts rank 0's after every initialisation and
resume). Only rank 0 writes checkpoints, results and logs; the ranks meet
at a barrier before ``train_model`` returns, once every file is written.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Any, Callable, Sequence

import numpy as np
import torch

from facerec_torch.config import CHECKPOINTS_DIR, TrainConfig, logger
from facerec_torch.data import native_loader
from facerec_torch.data.datasets import ClassificationBatcher, ImageFolderIndex, SiamesePairBatcher
from facerec_torch.data.pipeline import prefetch_to_device
from facerec_torch.eval.metrics import confusion_matrix, count_parameters
from facerec_torch.models import get_model
from facerec_torch.parallel.collectives import all_gather, broadcast_object
from facerec_torch.parallel.mesh import Mesh, build_mesh, shard_params
from facerec_torch.train.checkpoints import (
    latest_epoch_checkpoint,
    prune_checkpoints,
    restore_into,
    save_checkpoint,
)
from facerec_torch.train.early_stopping import EarlyStopping
from facerec_torch.train.results import ResultsManager, next_model_version
from facerec_torch.train.schedulers import get_scheduler
from facerec_torch.train.state import MODEL_CLIP_NORMS, TrainState, create_train_state, set_hyperparam
from facerec_torch.train.steps import SIAMESE_THRESHOLD, make_eval_step, make_train_step

METRIC_KEYS = ("loss_sum", "correct", "count", "grad_norm")
PAIR_KEYS = ("same_correct", "same_count", "diff_correct", "diff_count")  # siamese


def _make_batchers(data_dir: Path, config: TrainConfig):
    """Train/val/test batchers of one dataset dir (``train``, ``val`` and
    ``test`` subdirs in ImageFolder layout)."""
    out = {}
    num_classes = 0
    for split in ("train", "val", "test"):
        d = Path(data_dir) / split
        if not d.exists():
            out[split] = None
            continue
        index = ImageFolderIndex.build(d)
        num_classes = max(num_classes, index.num_classes)
        if config.model_type == "siamese":
            out[split] = SiamesePairBatcher(index, config.batch_size, config.image_size,
                                            fixed_pairs=(split != "train"), seed=config.seed)
        else:
            out[split] = _classification_batcher(index, config.batch_size, config.image_size,
                                                 shuffle=(split == "train"), seed=config.seed)
    return out, num_classes


def _classification_batcher(index: ImageFolderIndex, batch_size: int, image_size: int,
                            shuffle: bool, seed: int):
    """The native JPEG batcher when the loader builds and every path is a
    JPEG, else the PIL batcher: the JAX engine's choice, and so its batches."""
    if native_loader.available() and all(p.suffix.lower() in (".jpg", ".jpeg")
                                         for p in index.paths):
        return native_loader.NativeClassificationBatcher(index, batch_size, image_size,
                                                         shuffle=shuffle, seed=seed)
    return ClassificationBatcher(index, batch_size, image_size, shuffle=shuffle, seed=seed)


def _run_epoch(step_fn: Callable, state: TrainState, batcher, device: torch.device, epoch: int,
               train: bool, max_batches: int = 0, prefetch: int = 2,
               mesh: Mesh | None = None) -> dict[str, float]:
    """One pass over a batcher (this rank's slice of each batch with a
    mesh). The step's metrics are summed on the device in f64 and read
    once, at the end; a siamese pass also gives the accuracy on the same
    pairs and on the different pairs."""
    keys = METRIC_KEYS if train else METRIC_KEYS[:3]
    sums = None
    n_batches = 0
    for batch in prefetch_to_device(batcher.epoch(epoch), device, depth=prefetch, mesh=mesh):
        metrics = step_fn(state, batch)
        if sums is None and "same_count" in metrics:
            keys += PAIR_KEYS
        vals = torch.stack([metrics[k] for k in keys]).double()
        sums = vals if sums is None else sums + vals
        n_batches += 1
        if max_batches and n_batches >= max_batches:
            break
    totals = dict(zip(keys, sums.tolist() if sums is not None else [0.0] * len(keys)))
    count = max(totals["count"], 1.0)
    agg = {
        "loss": totals["loss_sum"] / count,
        "acc": totals["correct"] / count,
        "examples": count,
        "batches": n_batches,
    }
    if "same_count" in totals:
        agg["same_acc"] = totals["same_correct"] / max(totals["same_count"], 1.0)
        agg["diff_acc"] = totals["diff_correct"] / max(totals["diff_count"], 1.0)
    if train and n_batches:
        agg["grad_norm"] = totals["grad_norm"] / n_batches
    return agg


def _quiet(*args, **kwargs) -> None:
    """The log of a rank other than rank 0."""


def mesh_for(config: TrainConfig, device: str | torch.device | None,
             mesh: Mesh | None = None) -> Mesh:
    """``mesh``, else ``config.mesh`` over the process group's ranks; raises
    when the global batch does not split over the data ranks."""
    mesh = mesh if mesh is not None else build_mesh(config.mesh, device=device)
    dp = mesh.size(mesh.data_axis)
    if config.batch_size % dp:
        raise ValueError(f"batch_size={config.batch_size} does not split over {dp} data ranks")
    return mesh


def _lr_finder_prepass(config: TrainConfig, num_classes: int, arc_kwargs: dict, batcher,
                       dev: torch.device, results: ResultsManager, base_lr: float,
                       mesh: Mesh) -> float:
    """The LR range test on a probe: a second model built and initialised
    from ``seed + 1`` with its own optimizer, which the sweep changes and
    then drops. Writes ``lr_finder.json``; returns the suggested rate when
    the analysis is valid, else ``base_lr``."""
    from facerec_torch.train.lr_finder import find_optimal_lr

    probe = get_model(config.model_type, num_classes=num_classes, param_dtype=config.param_dtype,
                      dropout_rate=config.dropout_rate, arcface_kwargs=arc_kwargs)
    probe_state = create_train_state(probe, config.replace(seed=config.seed + 1),
                                     config.model_type, dev)
    shard_params(probe, mesh)
    analysis = find_optimal_lr(probe, config.model_type, probe_state, batcher, device=dev,
                               compute_dtype=config.compute_dtype, mesh=mesh)
    results.save_json("lr_finder.json", dict(analysis))
    if analysis.get("valid"):
        base_lr = analysis["suggested_lr"]
        if mesh.is_primary:
            logger.info("LR finder suggests %.3e", base_lr)
    return base_lr


def train_model(
    config: TrainConfig,
    dataset_dirs: Sequence[str | Path] | str | Path,
    checkpoints_root: str | Path | None = None,
    model_name: str | None = None,
    device: str | torch.device | None = None,
    mesh: Mesh | None = None,
) -> dict[str, Any]:
    """Train one model over one or more dataset directories, one after the
    other, on ``device`` (default: the CUDA card; with several ranks, each
    rank's card), over ``mesh`` (default: ``config.mesh`` over the process
    group's ranks). Returns a summary dict with final metrics and artifact
    paths, the same on every rank."""
    if isinstance(dataset_dirs, (str, Path)):
        dataset_dirs = [dataset_dirs]
    dataset_dirs = [Path(d) for d in dataset_dirs]
    mesh = mesh_for(config, device, mesh)
    dev = mesh.device
    log = logger.info if mesh.is_primary else _quiet
    # the margin head's cosine product is full f32 (PyTorch's default, made explicit)
    torch.backends.cuda.matmul.allow_tf32 = False
    batchers_per_ds = []
    num_classes = config.num_classes
    for d in dataset_dirs:
        b, nc = _make_batchers(d, config)
        if b["train"] is None:
            raise FileNotFoundError(f"no train split under {d}")
        batchers_per_ds.append(b)
        num_classes = max(num_classes, nc)

    ckroot = Path(checkpoints_root or CHECKPOINTS_DIR)
    ckroot.mkdir(parents=True, exist_ok=True)
    model_type = config.model_type
    name = broadcast_object(
        model_name or config.model_name or next_model_version(ckroot, model_type), mesh)
    model_dir = ckroot / name
    results = ResultsManager(model_dir, write=mesh.is_primary)
    log("training %s (%s) on %d dataset(s), %d classes, on %s (mesh %s)",
        name, model_type, len(dataset_dirs), num_classes, dev, mesh.shape)

    arc_kwargs = dict(
        margin=config.arcface.margin, scale=config.arcface.scale,
        easy_margin=config.arcface.easy_margin,
        progressive_margin=config.arcface.progressive_margin,
        warmup_epochs=config.arcface.warmup_epochs,
    )
    model = get_model(model_type, num_classes=num_classes, param_dtype=config.param_dtype,
                      dropout_rate=config.dropout_rate, arcface_kwargs=arc_kwargs)
    state = create_train_state(model, config, model_type, dev)
    shard_params(state.model, mesh)
    opt = state.opt_state

    # ArcFace phase 1 trains with a frozen backbone
    two_phase = model_type == "arcface" and config.arcface.two_phase
    transition_epoch = (
        config.arcface.two_phase_epoch if config.arcface.two_phase_epoch > 0
        else max(10, config.epochs // 3)
    )
    if two_phase:
        set_hyperparam(opt, "backbone_scale", 0.0)

    base_lr = config.optimizer.learning_rate
    if config.use_lr_finder:
        base_lr = _lr_finder_prepass(config, num_classes, arc_kwargs,
                                     batchers_per_ds[0]["train"], dev, results, base_lr, mesh)

    train_step = make_train_step(model_type, config.compute_dtype, mesh)
    eval_step = make_eval_step(model_type, config.compute_dtype, mesh=mesh)
    scheduler = get_scheduler(config.scheduler, base_lr, config.epochs)
    stopper = EarlyStopping(patience=config.patience, min_delta=config.min_delta, mode="min", trace=True)
    best_val_acc = -1.0

    # full resume from the newest epoch checkpoint
    start_epoch = 0
    resumed = False
    if config.resume:
        found = latest_epoch_checkpoint(model_dir)
        if found is not None:
            ep, path = found
            _, meta = restore_into(model_dir, path.name, state.model, opt)
            shard_params([state.model, opt.slots], mesh)
            state.step = int(meta.get("step", state.step))
            if "scheduler" in meta:
                scheduler.load_state_dict(meta["scheduler"])
            if "stopper" in meta:
                stopper.load_state_dict(meta["stopper"])
            best_val_acc = float(meta.get("best_val_acc", -1.0))
            start_epoch = ep + 1
            resumed = True
            log("resumed from %s (epoch %d, step %d, lr %.3e)",
                path, ep, state.step, scheduler.lr)

    lr = scheduler.lr if resumed else scheduler.step()
    set_hyperparam(opt, "learning_rate", lr)

    history_rows = []
    t0 = time.time()
    for ds_dir, batchers in zip(dataset_dirs, batchers_per_ds):
        ds_name = ds_dir.name
        for epoch in range(start_epoch, config.epochs):
            ep_start = time.time()
            state.epoch = float(epoch)
            if model_type == "arcface" and config.optimizer.use_grad_clip:
                base_clip = MODEL_CLIP_NORMS["arcface"]
                set_hyperparam(opt, "max_norm",
                               min(base_clip, 0.5 + 0.05 * epoch) if epoch < 10 else base_clip)

            train_m = _run_epoch(train_step, state, batchers["train"], dev, epoch, True,
                                 config.max_train_batches, config.prefetch_depth, mesh)
            val_m = {"loss": float("nan"), "acc": float("nan")}
            if batchers["val"] is not None:
                val_m = _run_epoch(eval_step, state, batchers["val"], dev, epoch, False,
                                   config.max_val_batches, config.prefetch_depth, mesh)

            elapsed = time.time() - ep_start
            if val_m["acc"] == val_m["acc"] and val_m["acc"] > best_val_acc:  # not NaN
                best_val_acc = val_m["acc"]
                if mesh.is_primary:
                    save_checkpoint(model_dir, "best", state.model.state_dict(),
                                    metadata={"epoch": epoch, "val_acc": best_val_acc,
                                              "val_loss": val_m["loss"], "model_type": model_type,
                                              "num_classes": num_classes, "dataset": ds_name})

            row = dict(epoch=epoch, dataset=ds_name,
                       train_loss=round(train_m["loss"], 6), train_acc=round(train_m["acc"], 6),
                       val_loss=round(val_m["loss"], 6), val_acc=round(val_m["acc"], 6),
                       best_val_acc=round(best_val_acc, 6), lr=lr, time_elapsed=round(elapsed, 3))
            results.record_epoch(**row)
            for key in ("same_acc", "diff_acc"):  # siamese, beside the CSV's columns
                if key in val_m:
                    row[key] = round(val_m[key], 6)
            history_rows.append(row)
            extra = ""
            if "same_acc" in val_m:
                extra = f" same_acc={val_m['same_acc']:.3f} diff_acc={val_m['diff_acc']:.3f}"
            log("[%s] epoch %d/%d loss=%.4f acc=%.4f val_loss=%.4f val_acc=%.4f lr=%.2e %.1fs%s",
                name, epoch + 1, config.epochs, train_m["loss"], train_m["acc"],
                val_m["loss"], val_m["acc"], lr, elapsed, extra)

            if two_phase and epoch + 1 == transition_epoch:
                set_hyperparam(opt, "backbone_scale", 1.0)
                scheduler.base_lr *= 0.5
                log("[%s] two-phase transition at epoch %d: backbone unfrozen, LR halved",
                    name, epoch + 1)

            lr = scheduler.step(val_m["loss"])
            set_hyperparam(opt, "learning_rate", lr)
            stop = (config.early_stopping and val_m["loss"] == val_m["loss"]
                    and stopper(val_m["loss"]))

            # periodic full checkpoint, taken after the end-of-epoch scheduler
            # step, so that a resumed run continues where this one would
            if (config.checkpoint_every and (epoch + 1) % config.checkpoint_every == 0
                    and mesh.is_primary):
                save_checkpoint(model_dir, f"epoch_{epoch}", state.model.state_dict(),
                                opt_state=opt.state_dict(),
                                metadata={"epoch": epoch, "val_acc": val_m["acc"],
                                          "step": state.step,
                                          "scheduler": scheduler.state_dict(),
                                          "stopper": stopper.state_dict(),
                                          "best_val_acc": best_val_acc})
                prune_checkpoints(model_dir, keep=config.keep_checkpoints)

            if stop:
                log("[%s] early stopping at epoch %d", name, epoch + 1)
                break
        start_epoch = 0  # later datasets start from epoch 0

    if mesh.is_primary:
        save_checkpoint(model_dir, "final", state.model.state_dict(),
                        metadata={"model_type": model_type, "num_classes": num_classes,
                                  "epochs": config.epochs})
    results.save_learning_curves()

    test_summary = {}
    test_b = batchers_per_ds[-1].get("test")
    if test_b is not None:
        test_summary = _test(state, test_b, model_type, config, dev, results, mesh)
        log("[%s] test: loss=%.4f acc=%.4f", name, test_summary["test_loss"],
            test_summary["test_acc"])

    info = {
        "model_name": name,
        "model_type": model_type,
        "num_classes": num_classes,
        "image_size": config.image_size,
        "batch_size": config.batch_size,
        "epochs_trained": len(history_rows),
        "best_val_acc": best_val_acc,
        "parameters": count_parameters(state.model),
        "datasets": [str(d) for d in dataset_dirs],
        "config": config.to_dict(),
        "total_time_sec": round(time.time() - t0, 2),
        **test_summary,
    }
    results.save_model_info(info)
    mesh.barrier()  # every file is written before any rank goes on
    return {"model_dir": model_dir, "state": state, "model": state.model, "summary": info,
            "history": history_rows, "best_val_acc": best_val_acc, **test_summary}


def _test(state: TrainState, batcher, model_type: str, config: TrainConfig, dev: torch.device,
          results: ResultsManager, mesh: Mesh) -> dict[str, float]:
    """Test loss and accuracy, and the confusion matrix (written to
    ``metrics/confusion_matrix.json``; 2 x 2 of pair labels for siamese);
    with a mesh the predictions of the data ranks are gathered in batch
    order."""
    step = make_eval_step(model_type, config.compute_dtype, return_outputs=True, mesh=mesh)
    y_true, y_pred = [], []
    sums = {"loss_sum": 0.0, "correct": 0.0, "count": 0.0}
    n_b = 0
    for batch in prefetch_to_device(batcher.epoch(0), dev, depth=config.prefetch_depth,
                                    mesh=mesh):
        m = step(state, batch)
        for k in sums:
            sums[k] += float(m[k])
        if model_type == "siamese":
            pred, true = (m["distances"] < SIAMESE_THRESHOLD).long(), batch["pair_label"]
        else:
            pred, true = m["probs"].argmax(-1), batch["label"]
        pred, true, mask = (all_gather(t, mesh, mesh.data_axis).cpu().numpy()
                            for t in (pred, true, batch["mask"]))
        y_pred.extend(pred[mask.astype(bool)].tolist())
        y_true.extend(true[mask.astype(bool)].tolist())
        n_b += 1
        if config.max_test_batches and n_b >= config.max_test_batches:
            break
    count = max(sums["count"], 1.0)
    cm = confusion_matrix(np.asarray(y_true), np.asarray(y_pred))
    results.save_json("confusion_matrix.json", {"matrix": cm.tolist()})
    return {"test_loss": sums["loss_sum"] / count, "test_acc": sums["correct"] / count}
