"""Evaluation engine: ``evaluate_model`` and ``predict_image`` (counterpart of
``facerec_tpu/eval/engine.py``).

Batched inference over a test split, the metric set (accuracy,
weighted precision/recall/F1, ROC-AUC, PR-AUC, calibration, per-class and
confusion), the ROC/PR curve CSVs, ``{type}_results.json`` and the appending
``experiment_summary.json``, as the JAX engine writes them. ArcFace is
evaluated on its cosine logits against the class centres.

Per-batch latency: on the card, CUDA events over the kept batches after a
warm-up; on the CPU, the wall clock (the CPU computes synchronously). The
JAX engine's slope between two dispatch chains works around a TPU runtime's
execution cache and missing barrier, neither of which a CUDA card has.

A siamese model is evaluated on fixed verification pairs (one same and one
different pair anchored at every test image): a pair is predicted same when
its embedding distance is below ``siamese_distance_threshold``; ROC-AUC and
PR-AUC are taken on the negated distance, and ``roc_curve.csv``,
``person_recognition_matrix.csv`` and ``per_person_accuracy.csv`` are
written. Every other type, ensembles included, takes the classifier branch.
``predict_image`` refuses a siamese model, which has no classes (the JAX
one cannot run it either).

Over a mesh of several ranks (default: every rank of the process group on
the data axis, as the JAX engine's ``build_mesh()``) each rank runs its
slice of every batch; the probabilities (distances), labels and masks are
gathered in batch order, so every rank computes the metrics of one
process, and rank 0 alone writes the files. The latency is each rank's own.
"""

from __future__ import annotations

import csv
import json
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch

from facerec_torch import resolve_device
from facerec_torch.config import (
    CHECKPOINTS_DIR, OUTPUTS_DIR, PROC_DATA_DIR, EvalConfig, MeshConfig, logger,
)
from facerec_torch.data.datasets import (
    ClassificationBatcher,
    ImageFolderIndex,
    SiamesePairBatcher,
    _imagenet_normalize,
    _load_image,
)
from facerec_torch.data.pipeline import prefetch_to_device
from facerec_torch.eval import metrics as M
from facerec_torch.models import get_model
from facerec_torch.parallel.collectives import all_gather
from facerec_torch.parallel.mesh import Mesh, build_mesh
from facerec_torch.train.checkpoints import load_checkpoint
from facerec_torch.train.steps import _autocast


def discover_test_dir(dataset_path: str | Path | None = None) -> Path:
    """Find a test split: ``<dataset_path>/test``, ``dataset_path`` itself
    when it is a ``test`` directory, else the first ``**/test`` under the
    processed-data tree."""
    if dataset_path is not None:
        p = Path(dataset_path)
        if (p / "test").exists():
            return p / "test"
        if p.name == "test" and p.exists():
            return p
    candidates = sorted(PROC_DATA_DIR.glob("**/test"))
    if not candidates:
        raise FileNotFoundError(f"no test split found under {PROC_DATA_DIR}")
    return candidates[0]


def _load_model_for_eval(model_type: str, model_name: str, num_classes: int,
                         checkpoints_root: Path, dev: torch.device) -> torch.nn.Module:
    """The ``best`` checkpoint of ``model_name``, else its ``final`` one, in
    eval mode on ``dev``; FileNotFoundError when it has neither."""
    ck = load_checkpoint(checkpoints_root / model_name)
    model = get_model(model_type, num_classes=num_classes)
    model.load_state_dict(ck["model"])
    return model.to(dev).eval()


def _classifier_fn(model: torch.nn.Module, model_type: str, compute_dtype: str,
                   dev: torch.device):
    """batch -> f32 softmax probabilities; ArcFace takes the labels, which
    in eval mode gives its cosine logits against the class centres."""

    @torch.no_grad()
    def apply_fn(batch: dict) -> torch.Tensor:
        with _autocast(dev, compute_dtype):
            if model_type == "arcface":
                logits = model(batch["image"], labels=batch["label"])
            else:
                logits = model(batch["image"])
        return torch.softmax(logits.float(), dim=-1)

    return apply_fn


def _latency_ms(apply_fn, batches: list, dev: torch.device, iters: int = 12) -> float:
    """Per-batch inference time over ``iters`` calls cycling through the kept
    (device-resident) batches, after one warm-up call."""
    if not batches:
        return float("nan")
    apply_fn(batches[0])
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(iters):
            apply_fn(batches[i % len(batches)])
        end.record()
        torch.cuda.synchronize(dev)
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for i in range(iters):
        apply_fn(batches[i % len(batches)])
    return (time.perf_counter() - t0) * 1e3 / iters


def evaluate_model(
    config: EvalConfig,
    dataset_path: str | Path | None = None,
    checkpoints_root: str | Path | None = None,
    outputs_root: str | Path | None = None,
    return_predictions: bool = False,
    device: str | torch.device | None = None,
    model: torch.nn.Module | None = None,
    mesh: Mesh | None = None,
) -> dict[str, Any]:
    """Evaluate the ``best`` (else ``final``) checkpoint of
    ``config.model_name`` under ``checkpoints_root``, or ``model`` when one
    is given (e.g. ``create_pretrained_ensemble``'s), on a test split, on
    ``device`` (default: the CUDA card); writes the JAX engine's artifact
    set under ``<outputs_root>/<model_name>`` and returns the metrics dict.
    ``return_predictions`` keeps the per-image arrays (``_predictions``:
    labels, argmax, probabilities in the split's sorted order; for siamese
    pair labels, predictions and distances in the fixed pairs' order) in
    the returned dict; they are never written to JSON. ``mesh`` (default:
    every rank of the process group on the data axis) runs the batches
    data-parallel; the results are the same on every rank."""
    mesh = mesh if mesh is not None else build_mesh(MeshConfig(), device=device)
    dev = mesh.device
    checkpoints_root = Path(checkpoints_root or CHECKPOINTS_DIR)
    outputs_root = Path(outputs_root or OUTPUTS_DIR)
    test_dir = discover_test_dir(dataset_path)
    index = ImageFolderIndex.build(test_dir)
    model_type = config.model_type
    model_name = config.model_name or model_type

    if model is None:
        model = _load_model_for_eval(model_type, model_name, index.num_classes,
                                     checkpoints_root, dev)
    else:
        model = model.to(dev).eval()
    out_dir = outputs_root / model_name
    if mesh.is_primary:
        out_dir.mkdir(parents=True, exist_ok=True)

    if model_type == "siamese":
        results = _evaluate_siamese(model, index, config, dev, out_dir, mesh)
    else:
        results = _evaluate_classifier(model, index, config, dev, out_dir, model_type, mesh)
    predictions = results.pop("_predictions")
    results["model_name"] = model_name
    results["model_type"] = model_type
    results["test_dir"] = str(test_dir)
    results["num_test_images"] = len(index)
    if mesh.is_primary:
        (out_dir / f"{model_type}_results.json").write_text(
            json.dumps(results, indent=2, default=str))
        _write_experiment_summary(out_dir, results)
        logger.info("[eval %s] acc=%.4f f1=%.4f roc_auc=%s %.2fms/batch",
                    model_name, results["accuracy"], results["f1"],
                    f"{results.get('roc_auc', float('nan')):.4f}",
                    results["avg_inference_time_ms"])
    mesh.barrier()
    if return_predictions:
        results["_predictions"] = predictions
    return results


def _gathered(mesh: Mesh, *tensors: torch.Tensor) -> list[np.ndarray]:
    """Each tensor's rows of every data rank, in batch order, on the host."""
    return [all_gather(t, mesh, mesh.data_axis).cpu().numpy() for t in tensors]


def _evaluate_classifier(model, index, config: EvalConfig, dev: torch.device, out_dir: Path,
                         model_type: str, mesh: Mesh) -> dict[str, Any]:
    apply_fn = _classifier_fn(model, model_type, config.compute_dtype, dev)
    # the PIL batcher in file order, as the JAX engine reads its test split
    batcher = ClassificationBatcher(index, config.batch_size, config.image_size, shuffle=False)
    all_probs, all_labels, kept = [], [], []
    n_batches = 0
    for batch in prefetch_to_device(batcher.epoch(0), dev, mesh=mesh):
        if len(kept) < 8:
            kept.append(batch)
        probs, labels, m = _gathered(mesh, apply_fn(batch), batch["label"], batch["mask"])
        m = m.astype(bool)
        all_probs.append(probs[m])
        all_labels.append(labels[m])
        n_batches += 1
    probs = np.concatenate(all_probs)
    y = np.concatenate(all_labels)
    yhat = probs.argmax(1)
    ms_per_batch = _latency_ms(apply_fn, kept, dev)

    prec, rec, f1 = M.precision_recall_f1(y, yhat, "weighted")
    results = {
        "accuracy": M.accuracy(y, yhat),
        "precision": prec,
        "recall": rec,
        "f1": f1,
        "roc_auc": M.roc_auc_ovr(y, probs, "weighted"),
        "pr_auc": M.pr_auc_ovr(y, probs),
        "avg_inference_time_ms": ms_per_batch,
        "throughput_imgs_per_sec": float(
            (len(y) / max(n_batches, 1)) / max(ms_per_batch / 1000.0, 1e-9)),
        "calibration": M.expected_calibration_error(y, probs),
        "per_class": M.per_class_metrics(y, yhat, probs, index.class_names),
        "confusion": M.enhanced_confusion_matrix(y, yhat, index.class_names),
        "_predictions": {"y": y, "yhat": yhat, "probs": probs},
    }
    if mesh.is_primary:
        _write_curves_csv(out_dir, y, probs, index.class_names)
    return results


def _evaluate_siamese(model, index, config: EvalConfig, dev: torch.device,
                      out_dir: Path, mesh: Mesh) -> dict[str, Any]:
    @torch.no_grad()
    def apply_fn(batch: dict) -> torch.Tensor:
        with _autocast(dev, config.compute_dtype):
            ea, eb = model(batch["image_a"], batch["image_b"])
        return torch.sqrt(torch.clamp(((ea.float() - eb.float()) ** 2).sum(-1), min=1e-24))

    batcher = SiamesePairBatcher(index, config.batch_size, config.image_size, fixed_pairs=True)
    dists, ys, las, lbs, kept = [], [], [], [], []
    n_batches = 0
    for batch in prefetch_to_device(batcher.epoch(0), dev, mesh=mesh):
        if len(kept) < 8:
            kept.append(batch)
        d, y, la, lb, m = _gathered(mesh, apply_fn(batch), batch["pair_label"], batch["label_a"],
                                    batch["label_b"], batch["mask"])
        m = m.astype(bool)
        for acc, v in ((dists, d), (ys, y), (las, la), (lbs, lb)):
            acc.append(v[m])
        n_batches += 1
    ms_per_batch = _latency_ms(apply_fn, kept, dev)
    dist, y, la, lb = (np.concatenate(v) for v in (dists, ys, las, lbs))
    threshold = config.siamese_distance_threshold
    yhat = (dist < threshold).astype(np.int64)

    prec, rec, f1 = M.precision_recall_f1(y, yhat, "weighted")
    fpr, tpr, _ = M.roc_curve(y, -dist)
    results = {
        "accuracy": M.accuracy(y, yhat),
        "precision": prec,
        "recall": rec,
        "f1": f1,
        "roc_auc": M.auc(fpr, tpr),
        "pr_auc": M.average_precision(y, -dist),
        "same_accuracy": M.accuracy(y[y == 1], yhat[y == 1]),
        "diff_accuracy": M.accuracy(y[y == 0], yhat[y == 0]),
        "avg_inference_time_ms": ms_per_batch,
        "throughput_pairs_per_sec": float(
            (len(y) / max(n_batches, 1)) / max(ms_per_batch / 1000.0, 1e-9)),
        "distance_threshold": threshold,
        "_predictions": {"y": y, "yhat": yhat, "dist": dist},
    }
    if mesh.is_primary:
        with (out_dir / "roc_curve.csv").open("w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["fpr", "tpr"])
            w.writerows(zip(fpr.tolist(), tpr.tolist()))
    results["per_person_accuracy"] = _write_person_matrix(out_dir, index.class_names, dist, y,
                                                          la, lb, threshold, mesh.is_primary)
    return results


def _write_person_matrix(out_dir: Path, names: list[str], dist: np.ndarray, y: np.ndarray,
                         la: np.ndarray, lb: np.ndarray, threshold: float,
                         write: bool = True) -> dict[str, float]:
    """The person-by-person recognition rate (``person_recognition_matrix.csv``:
    the share of the pairs of persons a and b decided right) and each
    person's accuracy over all their pairs (``per_person_accuracy.csv``),
    written when ``write``."""
    n = len(names)
    correct = np.zeros((n, n))
    total = np.zeros((n, n))
    for d, t, a, b in zip(dist, y, la, lb):
        ok = int((d < threshold) == bool(t))
        correct[a, b] += ok
        correct[b, a] += ok
        total[a, b] += 1
        total[b, a] += 1
    with np.errstate(invalid="ignore"):
        rate = np.where(total > 0, correct / np.maximum(total, 1), np.nan)
    per_person = {names[i]: float(np.nansum(correct[i]) / max(np.nansum(total[i]), 1))
                  for i in range(n)}
    if not write:
        return per_person
    with (out_dir / "person_recognition_matrix.csv").open("w", newline="") as f:
        w = csv.writer(f)
        w.writerow([""] + names)
        for i, nm in enumerate(names):
            w.writerow([nm] + [f"{rate[i, j]:.3f}" if total[i, j] else "" for j in range(n)])
    with (out_dir / "per_person_accuracy.csv").open("w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["person", "accuracy"])
        w.writerows(per_person.items())
    return per_person


def _write_curves_csv(out_dir: Path, y: np.ndarray, probs: np.ndarray, names: list[str]) -> None:
    """Per-class ROC and PR curves (``roc_curves.csv``, ``pr_curves.csv``)."""
    with (out_dir / "roc_curves.csv").open("w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["class", "fpr", "tpr"])
        for c, name in enumerate(names):
            mask = y == c
            if mask.any() and (~mask).any():
                fpr, tpr, _ = M.roc_curve(mask, probs[:, c])
                for a, b in zip(fpr, tpr):
                    w.writerow([name, a, b])
    with (out_dir / "pr_curves.csv").open("w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["class", "precision", "recall"])
        for c, name in enumerate(names):
            mask = y == c
            if mask.any():
                prec, rec, _ = M.precision_recall_curve(mask, probs[:, c])
                for a, b in zip(prec, rec):
                    w.writerow([name, a, b])


def _write_experiment_summary(out_dir: Path, results: dict) -> None:
    """Append the scalar results to ``experiment_summary.json``."""
    path = out_dir / "experiment_summary.json"
    history = json.loads(path.read_text()) if path.exists() else []
    entry = {k: v for k, v in results.items()
             if isinstance(v, (int, float, str)) and not isinstance(v, bool)}
    entry["timestamp"] = time.strftime("%Y-%m-%dT%H:%M:%S")
    history.append(entry)
    path.write_text(json.dumps(history, indent=2))


def predict_image(
    image_path: str | Path,
    config: EvalConfig,
    class_names: list[str],
    checkpoints_root: str | Path | None = None,
    device: str | torch.device | None = None,
) -> dict[str, Any]:
    """Top-1 class of one image with its softmax confidence, and the top 3,
    from the checkpoint ``evaluate_model`` would load, on ``device``
    (default: the CUDA card)."""
    dev = resolve_device(device)
    if config.model_type == "siamese":
        raise ValueError("predict_image classifies one image; a siamese model has no classes "
                         "(it compares pairs: evaluate it with evaluate_model)")
    model = _load_model_for_eval(config.model_type, config.model_name or config.model_type,
                                 len(class_names), Path(checkpoints_root or CHECKPOINTS_DIR), dev)
    x = _imagenet_normalize(_load_image(image_path, config.image_size))[None]
    batch = {"image": torch.from_numpy(x).to(dev),
             "label": torch.zeros(1, dtype=torch.int32, device=dev)}
    probs = _classifier_fn(model, config.model_type, config.compute_dtype, dev)(batch)
    probs = probs[0].cpu().numpy()
    top = int(probs.argmax())
    order = np.argsort(-probs)[:3]
    return {
        "predicted_class": class_names[top],
        "confidence": float(probs[top]),
        "top3": [{"class": class_names[i], "prob": float(probs[i])} for i in order],
    }
