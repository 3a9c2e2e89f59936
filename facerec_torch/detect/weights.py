"""Detector weight loading and saving (counterpart of
``facerec_tpu/detect/weights.py``). Resolution order: an explicit
directory, then the ``FACEREC_MTCNN_WEIGHTS`` environment variable, then
``outputs/detector``. A directory holds either ``{pnet,rnet,onet}.npz``
files of '/'-joined parameter paths, read and written with numpy alone, with
a ``source.txt`` provenance marker, or facenet-pytorch's ``{pnet,rnet,
onet}.pt`` state dicts, converted on the fly (``models.convert.
convert_mtcnn_net``). Either way the loaders return Flax-layout trees, which
``facerec_torch.convert.from_jax`` turns into state dicts and ``to_jax``
back, so each package loads the other's files. The cascade's thresholds
follow the weights' source: calibrated for self-trained weights, classic for
pretrained ones.
"""

from __future__ import annotations

import os
from collections.abc import Mapping
from pathlib import Path

import numpy as np
import torch

from facerec_torch.config import (
    CALIBRATED_DETECTION_THRESHOLDS,
    CLASSIC_DETECTION_THRESHOLDS,
    OUTPUTS_DIR,
)

DEFAULT_DIR = OUTPUTS_DIR / "detector"
CALIBRATED_THRESHOLDS = CALIBRATED_DETECTION_THRESHOLDS
CLASSIC_THRESHOLDS = CLASSIC_DETECTION_THRESHOLDS
NETS = ("pnet", "rnet", "onet")


def _unflatten(flat: dict) -> dict:
    tree: dict = {}
    for k, v in flat.items():
        d = tree
        parts = k.split("/")
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return tree


def flatten_tree(tree: Mapping, prefix: str = "") -> dict:
    """'/'-joined flat ``{path: np.ndarray}`` view of a nested tree."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, Mapping):
            out.update(flatten_tree(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def save_detector_params(params: dict, directory: str | Path = DEFAULT_DIR,
                         source: str = "self-trained") -> Path:
    """Save ``{"pnet", "rnet", "onet"}`` Flax-layout trees (``to_jax`` of
    the port's nets) as ``.npz`` files with JAX's key names, plus the
    ``source.txt`` marker, so converted pretrained weights saved here keep
    their classic operating point."""
    d = Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    for net in NETS:
        np.savez(d / f"{net}.npz", **flatten_tree(params[net]))
    (d / "source.txt").write_text(source)
    return d


def load_detector_params_with_source(directory: str | Path | None = None
                                     ) -> tuple[dict, str]:
    """(params {net: tree}, source): for ``.npz`` files "self-trained"
    unless the directory's ``source.txt`` says otherwise; for
    facenet-pytorch ``.pt`` files "pretrained", which runs at the classic
    thresholds they were tuned with."""
    candidates = []
    if directory is not None:
        candidates.append(Path(directory))
    if os.environ.get("FACEREC_MTCNN_WEIGHTS"):
        candidates.append(Path(os.environ["FACEREC_MTCNN_WEIGHTS"]))
    candidates.append(DEFAULT_DIR)
    for d in candidates:
        if all((d / f"{n}.npz").exists() for n in NETS):
            params = {}
            for n in NETS:
                with np.load(d / f"{n}.npz") as z:
                    params[n] = _unflatten(dict(z))
            marker = d / "source.txt"
            source = marker.read_text().strip() if marker.exists() else "self-trained"
            return params, source
        if all((d / f"{n}.pt").exists() for n in NETS):
            from facerec_torch.convert import to_jax
            from facerec_torch.models.convert import convert_mtcnn_net, load_torch_state_dict

            return {n: to_jax(convert_mtcnn_net(load_torch_state_dict(d / f"{n}.pt"), n), n)
                    for n in NETS}, "pretrained"
    raise FileNotFoundError(f"no MTCNN weights found in {[str(c) for c in candidates]}")


def load_detector_params(directory: str | Path | None = None) -> dict:
    return load_detector_params_with_source(directory)[0]


def thresholds_for_source(source: str) -> tuple[float, float, float]:
    return CLASSIC_THRESHOLDS if source == "pretrained" else CALIBRATED_THRESHOLDS


def load_default_detector(image_hw: tuple[int, int], min_face_size: int = 20,
                          thresholds: tuple[float, float, float] | None = None,
                          max_faces: int = 16, device: str | torch.device | None = None):
    """An ``MTCNN`` for ``image_hw`` on ``device`` (default: the CUDA card)
    with the best available weights loaded; ``thresholds=None`` takes the
    operating point of the weights' source."""
    from facerec_torch.detect.mtcnn import MTCNN

    params, source = load_detector_params_with_source()
    if thresholds is None:
        thresholds = thresholds_for_source(source)
    det = MTCNN(image_hw, min_face_size=min_face_size, thresholds=thresholds,
                max_faces=max_faces, device=device)
    return det.load_jax_params(params)
