"""Detector weight loading (counterpart of ``facerec_tpu/detect/weights.py``,
``.npz`` branch). Resolution order: an explicit directory, then the
``FACEREC_MTCNN_WEIGHTS`` environment variable, then ``outputs/detector``.
Each holds ``{pnet,rnet,onet}.npz`` files of '/'-joined parameter paths, read
with numpy alone; ``facerec_torch.convert.from_jax`` turns them into state
dicts. The cascade's thresholds follow the weights' source: calibrated for
self-trained weights, classic for converted pretrained ones.
"""

from __future__ import annotations

import os
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


def load_detector_params_with_source(directory: str | Path | None = None
                                     ) -> tuple[dict, str]:
    """(params {net: tree}, source) with source "self-trained" unless the
    directory's ``source.txt`` says otherwise."""
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
    raise FileNotFoundError(f"no MTCNN .npz weights found in {[str(c) for c in candidates]}")


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
