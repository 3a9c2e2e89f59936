"""Compare-all-models flow (counterpart of ``facerec_tpu/cli/compare.py``):
train and evaluate every architecture on one dataset, then print a
comparison table. The ensemble entry is built from the members this run
trained (``create_pretrained_ensemble``), or trained from scratch when a
member's checkpoint is missing. A model type that raises becomes an
``error`` entry and the run goes on, as in the JAX package; a CUDA error
ends the run."""

from __future__ import annotations

import time
from pathlib import Path
from typing import Any

import torch

from facerec_torch import is_device_error, resolve_device
from facerec_torch.config import EvalConfig, TrainConfig, logger
from facerec_torch.models import MODEL_TYPES


def compare_all_models(
    dataset_dir: str | Path,
    epochs: int = 10,
    batch_size: int = 32,
    image_size: int | None = None,
    model_types: list[str] | None = None,
    checkpoints_root: str | Path | None = None,
    outputs_root: str | Path | None = None,
    ensemble_members: list[str] | None = None,
    device: str | torch.device | None = None,
) -> dict[str, Any]:
    """Train and evaluate each of ``model_types`` (default: all seven) on
    ``device`` (default: the CUDA card); returns one entry per type."""
    from facerec_torch.eval.engine import evaluate_model
    from facerec_torch.train.engine import train_model

    dev = resolve_device(device)
    results: dict[str, Any] = {}
    for mt in model_types or MODEL_TYPES:
        t0 = time.time()
        try:
            isize = image_size or TrainConfig().image_size
            if mt == "ensemble":
                r = _pretrained_ensemble_entry(dataset_dir, isize, batch_size,
                                               checkpoints_root, outputs_root,
                                               ensemble_members, dev)
                if r is not None:
                    r["train_time_sec"] = round(time.time() - t0, 1)
                    results[mt] = r
                    continue
            cfg = TrainConfig(model_type=mt, epochs=epochs, batch_size=batch_size,
                              image_size=isize, model_name=f"{mt}_compare")
            train_out = train_model(cfg, dataset_dir, checkpoints_root=checkpoints_root, device=dev)
            ecfg = EvalConfig(model_type=mt, model_name=f"{mt}_compare",
                              image_size=cfg.image_size, batch_size=batch_size)
            eval_out = evaluate_model(ecfg, dataset_dir, checkpoints_root=checkpoints_root,
                                      outputs_root=outputs_root, device=dev)
            results[mt] = {
                "val_acc": train_out["best_val_acc"],
                "test_acc": eval_out["accuracy"],
                "f1": eval_out["f1"],
                "roc_auc": eval_out.get("roc_auc"),
                "inference_ms": eval_out["avg_inference_time_ms"],
                "train_time_sec": round(time.time() - t0, 1),
            }
        except Exception as e:
            if is_device_error(e):
                raise
            logger.warning("compare-all: %s failed: %s", mt, e)
            results[mt] = {"error": str(e)}

    _print_table(results)
    return results


def _pretrained_ensemble_entry(dataset_dir, image_size, batch_size,
                               checkpoints_root, outputs_root,
                               ensemble_members: list[str] | None = None,
                               device: torch.device | None = None) -> dict[str, Any] | None:
    """Evaluate an ensemble assembled from this run's trained member
    checkpoints (saved as ``ensemble_compare``); None when any member
    checkpoint is missing."""
    from facerec_torch.config import CHECKPOINTS_DIR
    from facerec_torch.data.datasets import ImageFolderIndex
    from facerec_torch.eval.engine import discover_test_dir, evaluate_model
    from facerec_torch.models import DEFAULT_ENSEMBLE_MEMBERS
    from facerec_torch.models.ensemble import create_pretrained_ensemble
    from facerec_torch.train.checkpoints import save_checkpoint

    root = Path(checkpoints_root or CHECKPOINTS_DIR)
    member_names = {t: f"{t}_compare" for t in (ensemble_members or DEFAULT_ENSEMBLE_MEMBERS)}
    missing = [n for n in member_names.values()
               if not ((root / n / "best").exists() or (root / n / "final").exists())]
    if missing:
        logger.warning("ensemble: member checkpoints missing (%s); training from scratch",
                       ", ".join(missing))
        return None
    num_classes = ImageFolderIndex.build(discover_test_dir(dataset_dir)).num_classes
    model = create_pretrained_ensemble(member_names, num_classes, checkpoints_root=root)
    save_checkpoint(root / "ensemble_compare", "best", model.state_dict(),
                    metadata={"members": member_names, "num_classes": num_classes,
                              "model_type": "ensemble", "pretrained_members": True})
    ecfg = EvalConfig(model_type="ensemble", model_name="ensemble_compare",
                      image_size=image_size, batch_size=batch_size)
    eval_out = evaluate_model(ecfg, dataset_dir, checkpoints_root=root,
                              outputs_root=outputs_root, model=model, device=device)
    return {
        "val_acc": float("nan"),  # no training run; members carry their own
        "test_acc": eval_out["accuracy"],
        "f1": eval_out["f1"],
        "roc_auc": eval_out.get("roc_auc"),
        "inference_ms": eval_out["avg_inference_time_ms"],
    }


def _print_table(results: dict[str, Any]) -> None:
    header = f"{'model':<12}{'val_acc':>9}{'test_acc':>10}{'f1':>8}{'roc_auc':>9}{'ms/batch':>10}{'time_s':>9}"
    print(header)
    print("-" * len(header))
    for mt, r in results.items():
        if "error" in r:
            print(f"{mt:<12}  ERROR: {r['error'][:60]}")
        else:
            auc = f"{r['roc_auc']:.4f}" if isinstance(r.get("roc_auc"), float) else "-"
            print(f"{mt:<12}{r['val_acc']:>9.4f}{r['test_acc']:>10.4f}{r['f1']:>8.4f}"
                  f"{auc:>9}{r['inference_ms']:>10.1f}{r['train_time_sec']:>9.1f}")
