"""Run-artifact writers (a copy of ``facerec_tpu/train/results.py``): the
reference's on-disk contract, so downstream tooling carries over:
  metrics/training_metrics.csv with header
    epoch,dataset,train_loss,train_acc,val_loss,val_acc,best_val_acc,lr,time_elapsed
  metrics/learning_curves.csv, model_info.json, confusion_matrix.json.
"""

from __future__ import annotations

import csv
import json
import time
from pathlib import Path
from typing import Any

TRAIN_CSV_HEADER = [
    "epoch", "dataset", "train_loss", "train_acc", "val_loss", "val_acc",
    "best_val_acc", "lr", "time_elapsed",
]


class ResultsManager:
    """``write=False`` keeps the history and writes nothing (the ranks of a
    mesh other than rank 0)."""

    def __init__(self, model_dir: str | Path, write: bool = True):
        self.model_dir = Path(model_dir)
        self.metrics_dir = self.model_dir / "metrics"
        self.plots_dir = self.model_dir / "plots"
        self.logs_dir = self.model_dir / "logs"
        self.write = write
        if write:
            for d in (self.metrics_dir, self.plots_dir, self.logs_dir):
                d.mkdir(parents=True, exist_ok=True)
        self._train_csv = self.metrics_dir / "training_metrics.csv"
        self.history: list[dict] = []

    def record_epoch(self, **row: Any) -> None:
        self.history.append(dict(row))
        if not self.write:
            return
        new = not self._train_csv.exists()
        with self._train_csv.open("a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=TRAIN_CSV_HEADER, extrasaction="ignore")
            if new:
                w.writeheader()
            w.writerow({k: row.get(k, "") for k in TRAIN_CSV_HEADER})

    def save_learning_curves(self) -> Path:
        """CSV learning-curves dump (reference training.py:30-68 — the
        reference computes CSVs, plotting is disabled there too)."""
        path = self.metrics_dir / "learning_curves.csv"
        if not self.history or not self.write:
            return path
        keys = ["epoch", "train_loss", "train_acc", "val_loss", "val_acc", "lr"]
        with path.open("w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=keys, extrasaction="ignore")
            w.writeheader()
            for row in self.history:
                w.writerow({k: row.get(k, "") for k in keys})
        return path

    def save_json(self, name: str, payload: dict) -> Path:
        path = self.metrics_dir / name
        if self.write:
            path.write_text(json.dumps(payload, indent=2, default=_json_default))
        return path

    def save_model_info(self, info: dict) -> Path:
        """model_info.json (reference training.py:893-915)."""
        info = dict(info)
        info.setdefault("saved_at", time.strftime("%Y-%m-%dT%H:%M:%S"))
        path = self.model_dir / "model_info.json"
        if self.write:
            path.write_text(json.dumps(info, indent=2, default=_json_default))
        return path


def _json_default(o):
    import numpy as np

    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    if isinstance(o, Path):
        return str(o)
    return str(o)


def next_model_version(checkpoints_dir: str | Path, model_type: str) -> str:
    """Auto model-versioning '{type}_v{n}' (reference training.py:264-271)."""
    base = Path(checkpoints_dir)
    n = 1
    while (base / f"{model_type}_v{n}").exists():
        n += 1
    return f"{model_type}_v{n}"
