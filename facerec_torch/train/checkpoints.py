"""Checkpoint save, load and prune (counterpart of
``facerec_tpu/train/checkpoints.py``), with ``torch.save`` payloads instead
of orbax trees.

Layout, as the JAX trainer's:
  <model_dir>/
    best/            state.pt ({"model": state dict}) + metadata.json
    final/
    epoch_<n>/       also the optimizer state (the resume source)
"""

from __future__ import annotations

import json
import re
import shutil
import time
from pathlib import Path
from typing import Any, Mapping

import torch
import torch.nn as nn

PAYLOAD = "state.pt"


def _cpu(tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().clone()
    if isinstance(tree, Mapping):
        return {k: _cpu(v) for k, v in tree.items()}
    return tree


def save_checkpoint(
    ckpt_dir: str | Path,
    name: str,
    model_state: Mapping[str, torch.Tensor],
    opt_state: Mapping[str, Any] | None = None,
    metadata: dict | None = None,
) -> Path:
    """Save a model state dict (parameters and BatchNorm statistics) and,
    for resumable checkpoints (``epoch_<n>``), the optimizer's state dict."""
    path = (Path(ckpt_dir) / name).resolve()
    if path.exists():
        shutil.rmtree(path)
    path.mkdir(parents=True)
    payload = {"model": _cpu(model_state)}
    if opt_state is not None:
        payload["opt_state"] = _cpu(opt_state)
    torch.save(payload, path / PAYLOAD)
    meta = dict(metadata or {})
    meta.setdefault("timestamp", time.strftime("%Y-%m-%dT%H:%M:%S"))
    meta.setdefault("has_opt_state", opt_state is not None)
    (path / "metadata.json").write_text(json.dumps(meta, indent=2, default=str))
    return path


def load_checkpoint(ckpt_dir: str | Path, name: str | None = None) -> dict:
    """``{"model", ["opt_state"], "metadata"}`` of a checkpoint, on the CPU;
    with ``name`` None, ``best`` and then ``final``."""
    base = Path(ckpt_dir)
    if name is None:
        for cand in ("best", "final"):
            if (base / cand).exists():
                name = cand
                break
        else:
            raise FileNotFoundError(f"no best/final checkpoint under {base}")
    path = (base / name).resolve()
    tree = torch.load(path / PAYLOAD, map_location="cpu", weights_only=True)
    meta_file = path / "metadata.json"
    if meta_file.exists():
        tree["metadata"] = json.loads(meta_file.read_text())
    return tree


def restore_into(ckpt_dir: str | Path, name: str, model: nn.Module, opt_state=None) -> tuple[dict, dict]:
    """Load a checkpoint into ``model`` and, when the checkpoint recorded
    one (``has_opt_state``), into ``opt_state`` (an object with
    ``load_state_dict``). Returns ``(tree, metadata)``."""
    tree = load_checkpoint(ckpt_dir, name)
    meta = tree.pop("metadata", {})
    model.load_state_dict(tree["model"])
    if opt_state is not None and meta.get("has_opt_state") and "opt_state" in tree:
        opt_state.load_state_dict(tree["opt_state"])
    return tree, meta


def latest_epoch_checkpoint(ckpt_dir: str | Path) -> tuple[int, Path] | None:
    """The newest ``epoch_<n>`` checkpoint, for resume."""
    base = Path(ckpt_dir)
    if not base.exists():
        return None
    best: tuple[int, Path] | None = None
    for p in base.iterdir():
        m = re.fullmatch(r"epoch_(\d+)", p.name)
        if m and (best is None or int(m.group(1)) > best[0]):
            best = (int(m.group(1)), p)
    return best


def prune_checkpoints(ckpt_dir: str | Path, keep: int = 3) -> list[Path]:
    """Keep the newest ``keep`` epoch checkpoints."""
    base = Path(ckpt_dir)
    if not base.exists():
        return []
    epochs = sorted(
        (p for p in base.iterdir() if re.fullmatch(r"epoch_\d+", p.name)),
        key=lambda p: int(p.name.split("_")[1]),
    )
    removed = []
    for p in epochs[:-keep] if keep > 0 else epochs:
        shutil.rmtree(p)
        removed.append(p)
    return removed
