"""Checkpoint save, load and prune (counterpart of
``facerec_tpu/train/checkpoints.py``), with ``torch.save`` payloads instead
of orbax trees.

Layout, as the JAX trainer's:
  <model_dir>/
    best/            state.pt ({"model": state dict}) + metadata.json
    final/
    epoch_<n>/       also the optimizer state (the resume source)

``load_checkpoint`` also reads a checkpoint the JAX trainer wrote (an orbax
tree: ``manifest.ocdbt`` and ``_CHECKPOINT_METADATA``, no ``state.pt``)
through ``facerec_torch.train.orbax``, converting its ``params`` and
``batch_stats`` with ``facerec_torch.convert.from_jax`` for the
``model_type`` its ``metadata.json`` records.
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
ORBAX_MARKERS = ("manifest.ocdbt", "_CHECKPOINT_METADATA")


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


def is_orbax_checkpoint(path: str | Path) -> bool:
    """A directory the JAX trainer wrote: the orbax markers, no ``state.pt``."""
    p = Path(path)
    return not (p / PAYLOAD).exists() and all((p / m).exists() for m in ORBAX_MARKERS)


def _float32(tree: Any) -> Any:
    """A tree's bfloat16 leaves (torch tensors) as f32 numpy arrays."""
    if isinstance(tree, torch.Tensor):
        return tree.float().numpy()
    if isinstance(tree, Mapping):
        return {k: _float32(v) for k, v in tree.items()}
    return tree


def _load_orbax(path: Path) -> dict:
    from facerec_torch.convert import from_jax
    from facerec_torch.train.orbax import read_orbax_tree

    meta_file = path / "metadata.json"
    meta = json.loads(meta_file.read_text()) if meta_file.exists() else {}
    if "model_type" not in meta:
        raise ValueError(f"{path}: an orbax checkpoint whose metadata.json names no "
                         "model_type, which the conversion needs")
    tree = read_orbax_tree(path)
    variables = _float32({"params": tree["params"], "batch_stats": tree.get("batch_stats", {})})
    return {"model": from_jax(variables, meta["model_type"]), "metadata": meta}


def load_checkpoint(ckpt_dir: str | Path, name: str | None = None) -> dict:
    """``{"model", ["opt_state"], "metadata"}`` of a checkpoint, on the CPU;
    with ``name`` None, ``best`` and then ``final``. A checkpoint of the JAX
    trainer gives its model state dict and metadata (no ``opt_state``)."""
    base = Path(ckpt_dir)
    if name is None:
        for cand in ("best", "final"):
            if (base / cand).exists():
                name = cand
                break
        else:
            raise FileNotFoundError(f"no best/final checkpoint under {base}")
    path = (base / name).resolve()
    if is_orbax_checkpoint(path):
        return _load_orbax(path)
    tree = torch.load(path / PAYLOAD, map_location="cpu", weights_only=True)
    meta_file = path / "metadata.json"
    if meta_file.exists():
        tree["metadata"] = json.loads(meta_file.read_text())
    return tree


def restore_into(ckpt_dir: str | Path, name: str, model: nn.Module, opt_state=None) -> tuple[dict, dict]:
    """Load a checkpoint into ``model`` and, when the checkpoint recorded
    one (``has_opt_state``), into ``opt_state`` (an object with
    ``load_state_dict``). Returns ``(tree, metadata)``. A checkpoint of the
    JAX trainer restores the model only: asked for ``opt_state``, it
    raises, optax's state having no counterpart in ``OptaxChain``'s."""
    if opt_state is not None and is_orbax_checkpoint(Path(ckpt_dir) / name):
        raise ValueError(f"{Path(ckpt_dir) / name} is a checkpoint of the JAX trainer: the "
                         "port does not resume its optimizer state; restore the model alone "
                         "(opt_state=None) and start a new run")
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
