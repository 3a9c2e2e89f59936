"""Metrics library (a copy of ``facerec_tpu/eval/metrics.py``: numpy, apart
from ``count_parameters``, which walks a torch module)."""

from __future__ import annotations

import time
from typing import Any

import numpy as np


# ---------------------------------------------------------------------------
# Classification metrics
# ---------------------------------------------------------------------------


def confusion_matrix(y_true: np.ndarray, y_pred: np.ndarray, num_classes: int | None = None) -> np.ndarray:
    y_true = np.asarray(y_true, np.int64)
    y_pred = np.asarray(y_pred, np.int64)
    n = num_classes or int(max(y_true.max(initial=0), y_pred.max(initial=0)) + 1)
    cm = np.zeros((n, n), np.int64)
    np.add.at(cm, (y_true, y_pred), 1)
    return cm


def accuracy(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    return float((y_true == y_pred).mean()) if len(y_true) else 0.0


def precision_recall_f1(
    y_true: np.ndarray, y_pred: np.ndarray, average: str = "weighted", num_classes: int | None = None
) -> tuple[float, float, float]:
    """Weighted-average P/R/F1 with zero-division -> 0 (sklearn default the
    reference relies on at testing.py:292-296)."""
    cm = confusion_matrix(y_true, y_pred, num_classes)
    tp = np.diag(cm).astype(np.float64)
    pred_c = cm.sum(0).astype(np.float64)
    true_c = cm.sum(1).astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        prec = np.where(pred_c > 0, tp / pred_c, 0.0)
        rec = np.where(true_c > 0, tp / true_c, 0.0)
        f1 = np.where(prec + rec > 0, 2 * prec * rec / (prec + rec), 0.0)
    if average == "macro":
        w = np.ones_like(true_c) / max(len(true_c), 1)
    elif average == "weighted":
        w = true_c / max(true_c.sum(), 1)
    else:
        raise ValueError(average)
    return float((prec * w).sum()), float((rec * w).sum()), float((f1 * w).sum())


def roc_curve(y_true: np.ndarray, scores: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Binary ROC curve (fpr, tpr, thresholds), sklearn-compatible ordering."""
    y_true = np.asarray(y_true).astype(bool)
    scores = np.asarray(scores, np.float64)
    order = np.argsort(-scores, kind="stable")
    y, s = y_true[order], scores[order]
    distinct = np.where(np.diff(s))[0]
    idx = np.r_[distinct, len(s) - 1]
    tps = np.cumsum(y)[idx].astype(np.float64)
    fps = (idx + 1) - tps
    tps = np.r_[0.0, tps]
    fps = np.r_[0.0, fps]
    thresholds = np.r_[np.inf, s[idx]]
    P = max(y_true.sum(), 1)
    N = max((~y_true).sum(), 1)
    return fps / N, tps / P, thresholds


def auc(x: np.ndarray, y: np.ndarray) -> float:
    return float(np.trapezoid(y, x))


def roc_auc_score(y_true: np.ndarray, scores: np.ndarray) -> float:
    fpr, tpr, _ = roc_curve(y_true, scores)
    return auc(fpr, tpr)


def roc_auc_ovr(y_true: np.ndarray, probs: np.ndarray, average: str = "macro") -> float:
    """One-vs-rest multiclass ROC-AUC (reference testing.py:302-305 uses
    sklearn's multi_class='ovr'). Classes absent from y_true are skipped."""
    y_true = np.asarray(y_true)
    probs = np.asarray(probs)
    aucs, weights = [], []
    for c in range(probs.shape[1]):
        mask = y_true == c
        if mask.any() and (~mask).any():
            aucs.append(roc_auc_score(mask, probs[:, c]))
            weights.append(mask.sum())
    if not aucs:
        return float("nan")
    if average == "weighted":
        w = np.asarray(weights, np.float64)
        return float((np.asarray(aucs) * w / w.sum()).sum())
    return float(np.mean(aucs))


def precision_recall_curve(y_true: np.ndarray, scores: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    y_true = np.asarray(y_true).astype(bool)
    scores = np.asarray(scores, np.float64)
    order = np.argsort(-scores, kind="stable")
    y, s = y_true[order], scores[order]
    distinct = np.where(np.diff(s))[0]
    idx = np.r_[distinct, len(s) - 1]
    tps = np.cumsum(y)[idx].astype(np.float64)
    fps = (idx + 1) - tps
    prec = tps / np.maximum(tps + fps, 1)
    rec = tps / max(y_true.sum(), 1)
    # sklearn appends the (1, 0) endpoint and reverses
    precision = np.r_[prec[::-1], 1.0]
    recall = np.r_[rec[::-1], 0.0]
    return precision, recall, s[idx][::-1]


def average_precision(y_true: np.ndarray, scores: np.ndarray) -> float:
    precision, recall, _ = precision_recall_curve(y_true, scores)
    # AP = sum (R_n - R_{n+1}) * P_n over the reversed (decreasing recall) arrays
    return float(-np.sum(np.diff(recall) * precision[:-1]))


def pr_auc_ovr(y_true: np.ndarray, probs: np.ndarray) -> float:
    y_true = np.asarray(y_true)
    aps = [
        average_precision(y_true == c, probs[:, c])
        for c in range(probs.shape[1])
        if (y_true == c).any()
    ]
    return float(np.mean(aps)) if aps else float("nan")


def per_class_metrics(
    y_true: np.ndarray, y_pred: np.ndarray, probs: np.ndarray | None = None,
    class_names: list[str] | None = None,
) -> dict[str, dict[str, float]]:
    """Per-class precision/recall/F1/support/accuracy/AUC
    (reference advanced_metrics.py:60-117)."""
    cm = confusion_matrix(y_true, y_pred, probs.shape[1] if probs is not None else None)
    n = cm.shape[0]
    names = class_names or [str(i) for i in range(n)]
    out = {}
    total = cm.sum()
    for c in range(n):
        tp = cm[c, c]
        fp = cm[:, c].sum() - tp
        fn = cm[c, :].sum() - tp
        tn = total - tp - fp - fn
        prec = tp / (tp + fp) if tp + fp else 0.0
        rec = tp / (tp + fn) if tp + fn else 0.0
        f1 = 2 * prec * rec / (prec + rec) if prec + rec else 0.0
        d = {
            "precision": float(prec),
            "recall": float(rec),
            "f1": float(f1),
            "support": int(cm[c, :].sum()),
            "accuracy": float((tp + tn) / total) if total else 0.0,
        }
        if probs is not None:
            mask = np.asarray(y_true) == c
            if mask.any() and (~mask).any():
                d["roc_auc"] = roc_auc_score(mask, probs[:, c])
        out[names[c]] = d
    return out


def enhanced_confusion_matrix(
    y_true: np.ndarray, y_pred: np.ndarray, class_names: list[str] | None = None
) -> dict[str, Any]:
    """TP/FP/FN + per-class P/R + top-3 misclassification targets
    (reference advanced_metrics.py:120-175)."""
    cm = confusion_matrix(y_true, y_pred)
    n = cm.shape[0]
    names = class_names or [str(i) for i in range(n)]
    per_class = {}
    for c in range(n):
        tp = int(cm[c, c])
        fp = int(cm[:, c].sum() - tp)
        fn = int(cm[c, :].sum() - tp)
        row = cm[c].copy()
        row[c] = 0
        top = np.argsort(-row)[:3]
        per_class[names[c]] = {
            "true_positives": tp,
            "false_positives": fp,
            "false_negatives": fn,
            "precision": float(tp / (tp + fp)) if tp + fp else 0.0,
            "recall": float(tp / (tp + fn)) if tp + fn else 0.0,
            "top_misclassified_as": [
                {"class": names[t], "count": int(row[t])} for t in top if row[t] > 0
            ],
        }
    return {"matrix": cm.tolist(), "class_names": names, "per_class": per_class}


def expected_calibration_error(
    y_true: np.ndarray, probs: np.ndarray, n_bins: int = 10
) -> dict[str, float]:
    """10-bin ECE + MCE (reference advanced_metrics.py:178-228)."""
    y_true = np.asarray(y_true)
    probs = np.asarray(probs, np.float64)
    conf = probs.max(axis=1)
    pred = probs.argmax(axis=1)
    correct = (pred == y_true).astype(np.float64)
    bins = np.linspace(0.0, 1.0, n_bins + 1)
    ece, mce = 0.0, 0.0
    n = len(y_true)
    for i in range(n_bins):
        mask = (conf > bins[i]) & (conf <= bins[i + 1]) if i > 0 else (conf >= bins[i]) & (conf <= bins[i + 1])
        if mask.any():
            gap = abs(correct[mask].mean() - conf[mask].mean())
            ece += mask.sum() / n * gap
            mce = max(mce, gap)
    return {"ece": float(ece), "mce": float(mce)}


# ---------------------------------------------------------------------------
# Utilities
# ---------------------------------------------------------------------------


class TimerContext:
    """Wall-clock timer context (reference advanced_metrics.py:231-255)."""

    def __init__(self, name: str = "block", log=None):
        self.name = name
        self.log = log
        self.elapsed = 0.0

    def __enter__(self):
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.start
        if self.log is not None:
            self.log.info("%s took %.4fs", self.name, self.elapsed)
        return False


def count_parameters(params: Any) -> dict[str, int]:
    """Total and per-top-level-module parameter counts of an ``nn.Module``
    (its parameters, not its buffers) or of a ``{name: tensor}`` mapping:
    the keys of the JAX tree's count (``backbone``, ``embedding``, ``bn``,
    ``arc_weight`` for ArcFace). Freezing is an optimizer scale here, so
    'trainable' equals the total."""
    named = params.named_parameters() if hasattr(params, "named_parameters") else params.items()
    by_key: dict[str, int] = {}
    for name, t in named:
        top = name.split(".")[0]
        by_key[top] = by_key.get(top, 0) + int(np.prod(tuple(t.shape)))
    total = sum(by_key.values())
    return {"total": total, "trainable": total, "by_module": by_key}
