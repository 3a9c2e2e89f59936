"""Serve, train, eval, tuning and preprocessing configuration and path
constants (a copy of the parts of ``facerec_tpu/config.py`` the serve step,
the demo, the trainer, the evaluator, the tuner, the preprocessor and the
command line need, so the port never imports the JAX package), with
``set_random_seeds`` and ``check_device``."""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import typing
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

PROJECT_ROOT = Path(os.environ.get("FACEREC_ROOT", Path(__file__).resolve().parent.parent))
DATA_DIR = PROJECT_ROOT / "data"
RAW_DATA_DIR = DATA_DIR / "raw"
PROC_DATA_DIR = DATA_DIR / "processed"
OUTPUTS_DIR = PROJECT_ROOT / "outputs"
CHECKPOINTS_DIR = OUTPUTS_DIR / "checkpoints"
VIZ_DIR = OUTPUTS_DIR / "visualizations"
FACE_REFERENCES_DIR = PROJECT_ROOT / "face_references"

# Training defaults (reference src/base_config.py:32-35)
DEFAULT_BATCH_SIZE = 16
DEFAULT_EPOCHS = 50
DEFAULT_LR = 1e-3
IMG_SIZE = 224

logger = logging.getLogger("facerec_torch")
if not logger.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter("%(asctime)s [%(levelname)s] %(name)s: %(message)s"))
    logger.addHandler(_h)
    logger.setLevel(logging.INFO)

# Cascade thresholds: calibrated for the committed self-trained detector
# weights, classic for facenet-pytorch's pretrained ones.
CALIBRATED_DETECTION_THRESHOLDS: tuple[float, float, float] = (0.5, 0.5, 0.55)
CLASSIC_DETECTION_THRESHOLDS: tuple[float, float, float] = (0.6, 0.7, 0.7)


class _DictMixin:
    """``to_dict`` / ``from_dict`` over nested dataclasses, as the JAX
    package's configs round-trip (``model_info.json`` stores ``to_dict``),
    ``save_json`` / ``load_json`` and ``replace``."""

    def to_dict(self) -> dict[str, Any]:
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if dataclasses.is_dataclass(v) and not isinstance(v, type):
                v = v.to_dict() if isinstance(v, _DictMixin) else dataclasses.asdict(v)
            elif isinstance(v, tuple):
                v = list(v)
            elif isinstance(v, Path):
                v = str(v)
            out[f.name] = v
        return out

    @classmethod
    def from_dict(cls, d: dict[str, Any]):
        kwargs = {}
        hints = typing.get_type_hints(cls)
        for f in dataclasses.fields(cls):
            if f.name not in d:
                continue
            v = d[f.name]
            ftype = hints[f.name]
            if isinstance(ftype, type) and issubclass(ftype, _DictMixin) and isinstance(v, dict):
                v = ftype.from_dict(v)
            elif isinstance(v, list):
                v = tuple(v)
            kwargs[f.name] = v
        return cls(**kwargs)

    def save_json(self, path: str | Path) -> None:
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        Path(path).write_text(json.dumps(self.to_dict(), indent=2))

    @classmethod
    def load_json(cls, path: str | Path):
        return cls.from_dict(json.loads(Path(path).read_text()))

    def replace(self, **kwargs):
        return dataclasses.replace(self, **kwargs)


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


@dataclass(frozen=True)
class PreprocessingConfig(_DictMixin):
    """Detect -> align -> crop -> augment settings (reference
    data_prep.py:20-67), every field and default as the JAX package's."""

    name: str = "default"
    use_mtcnn: bool = True
    face_margin: float = 0.4
    final_size: tuple[int, int] = (IMG_SIZE, IMG_SIZE)
    min_face_size: int = 20
    # None: the thresholds of the weights' source (detect/weights.py
    # thresholds_for_source); a tuple overrides them whatever the source
    detection_thresholds: tuple[float, float, float] | None = None
    # augmentation (reference data_prep.py:38-48)
    augment: bool = True
    rotation_degrees: float = 20.0
    brightness: float = 0.2
    contrast: float = 0.2
    scale: float = 0.1
    horizontal_flip: bool = True
    # low-data augmentation: variants when a class has fewer train images
    # than the threshold (reference data_prep.py:353-396)
    low_data_threshold: int = 20
    low_data_variants: int = 5


@dataclass(frozen=True)
class MeshConfig(_DictMixin):
    """Process-mesh layout (``parallel/mesh.py``): ``data_parallel`` ranks
    each take a slice of every batch, ``model_parallel`` ranks each hold a
    row range of the serve step's gallery; -1 takes every rank that
    ``model_parallel`` leaves."""

    data_axis: str = "data"
    model_axis: str = "model"
    data_parallel: int = -1
    model_parallel: int = 1


@dataclass(frozen=True)
class OptimizerConfig(_DictMixin):
    name: str = "adam"  # adam | adamw | radam | sgd
    learning_rate: float = DEFAULT_LR
    weight_decay: float = 1e-4
    amsgrad: bool = False
    momentum: float = 0.9
    beta1: float = 0.9
    beta2: float = 0.999
    grad_clip_norm: float = 1.0  # model-aware defaults applied by the trainer
    use_grad_clip: bool = True


@dataclass(frozen=True)
class SchedulerConfig(_DictMixin):
    """LR schedule (reference training_utils.py:74-148 + warmup training.py:158-180)."""

    name: str = "cosine"  # cosine | step | exponential | plateau | one_cycle | warmup_cosine | constant
    warmup_epochs: int = 0
    step_size: int = 10
    gamma: float = 0.1
    min_lr: float = 1e-6
    plateau_patience: int = 5
    plateau_factor: float = 0.5
    one_cycle_max_lr: float | None = None


@dataclass(frozen=True)
class ArcFaceConfig(_DictMixin):
    """ArcMarginProduct behaviour (reference face_models.py:297-445)."""

    margin: float = 0.5
    scale: float = 32.0
    easy_margin: bool = True
    progressive_margin: bool = True
    warmup_epochs: int = 10  # margin/scale ramp length
    two_phase: bool = True
    two_phase_epoch: int = -1  # -1 => max(10, epochs // 3)
    label_smoothing: float = 0.05


@dataclass(frozen=True)
class TrainConfig(_DictMixin):
    model_type: str = "baseline"
    model_name: str | None = None
    batch_size: int = DEFAULT_BATCH_SIZE
    epochs: int = DEFAULT_EPOCHS
    image_size: int = IMG_SIZE
    num_classes: int = 0  # inferred from the dataset when 0
    seed: int = 42
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    scheduler: SchedulerConfig = field(default_factory=SchedulerConfig)
    arcface: ArcFaceConfig = field(default_factory=ArcFaceConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    # Early stopping on val loss (reference training_utils.py:18-71)
    early_stopping: bool = True
    patience: int = 10
    min_delta: float = 0.0
    # Precision policy: bf16 compute (autocast), f32 parameters and reductions.
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    # Loop caps; 0 = uncapped.
    max_train_batches: int = 0
    max_val_batches: int = 0
    max_test_batches: int = 0
    use_lr_finder: bool = False
    label_smoothing: float = 0.1
    checkpoint_every: int = 1
    keep_checkpoints: int = 3
    resume: bool = False
    dropout_rate: float | None = None  # override the model default when set
    # Host input pipeline
    prefetch_depth: int = 2
    shuffle_buffer: int = 2048


@dataclass(frozen=True)
class EvalConfig(_DictMixin):
    model_type: str = "baseline"
    model_name: str | None = None
    batch_size: int = 64
    image_size: int = IMG_SIZE
    seed: int = 42
    siamese_distance_threshold: float = 0.5  # reference training.py:588-590
    compute_dtype: str = "bfloat16"


@dataclass(frozen=True)
class TuningConfig(_DictMixin):
    """The native hyperparameter search (``train/tuning.py``), every field
    and default as the JAX package's."""

    model_type: str = "baseline"
    n_trials: int = 20
    epochs_per_trial: int = 12
    timeout_seconds: float | None = None
    seed: int = 42
    use_trial0_baseline: bool = True
    pruning: bool = True
    pruning_warmup_epochs: int = 3
    storage: str | None = None  # sqlite path for resume; None = in-memory
    study_name: str = "facerec_study"
    train_best: bool = False
    # LR-finder pre-pass: one range test centres the log-uniform LR window
    use_lr_finder: bool = False
    lr_finder_span: float = 5.0  # window = [suggested/span, suggested*span]
    # the range test inside every trial, on the trial's own config
    use_lr_finder_per_trial: bool = False
    sampler: str = "tpe-lite"  # "tpe-lite" | "random"


def set_random_seeds(seed: int = 42) -> None:
    """Seed the host's RNGs and torch's (CPU and every card). The trainer's
    own randomness is explicit generators seeded from its configs."""
    import random

    import numpy as np
    import torch

    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)


def check_device(device: str | None = None) -> dict[str, Any]:
    """Report the accelerator: backend ``cuda``, the device count and each
    card's name. Raises when no card is present, unless ``device`` is
    ``"cpu"``, which reports the CPU."""
    import torch

    from facerec_torch import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        n = torch.cuda.device_count()
        names = [torch.cuda.get_device_name(i) for i in range(n)]
        info = {"backend": "cuda", "device_count": n, "local_device_count": n,
                "devices": names, "torch": torch.__version__, "cuda": torch.version.cuda}
    else:
        info = {"backend": dev.type, "device_count": 1, "local_device_count": 1,
                "devices": [str(dev)], "torch": torch.__version__, "cuda": None}
    logger.info("torch backend=%s devices=%d: %s", info["backend"], info["device_count"],
                info["devices"])
    return info
