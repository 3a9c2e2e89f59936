"""Serve configuration and path constants (a copy of the parts of
``facerec_tpu/config.py`` the serve step needs, so the port never imports
the JAX package)."""

from __future__ import annotations

import os
from dataclasses import dataclass
from pathlib import Path

PROJECT_ROOT = Path(os.environ.get("FACEREC_ROOT", Path(__file__).resolve().parent.parent))
OUTPUTS_DIR = PROJECT_ROOT / "outputs"
CHECKPOINTS_DIR = OUTPUTS_DIR / "checkpoints"
FACE_REFERENCES_DIR = PROJECT_ROOT / "face_references"

# Cascade thresholds: calibrated for the committed self-trained detector
# weights, classic for facenet-pytorch's pretrained ones.
CALIBRATED_DETECTION_THRESHOLDS: tuple[float, float, float] = (0.5, 0.5, 0.55)
CLASSIC_DETECTION_THRESHOLDS: tuple[float, float, float] = (0.6, 0.7, 0.7)


@dataclass(frozen=True)
class ServeConfig:
    """Real-time demo operating points (reference app.py:17-29)."""

    detection_threshold: float = 0.9
    recognition_threshold: float = 1.0  # euclidean on unit embeddings
    iou_tracking_threshold: float = 0.3
    skip_frames: int = 1
    embed_size: int = 160
    gallery_capacity: int = 1024
    top_k: int = 5
    max_faces: int = 16  # static per-frame face capacity
    gallery_dtype: str = "bfloat16"
