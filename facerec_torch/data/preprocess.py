"""Preprocessing: raw photos -> detected, aligned, cropped faces in the
ImageFolder train/val/test layout (counterpart of
``facerec_tpu/data/preprocess.py``; reference src/data_prep.py:203-403).

Images are letterboxed on the host to one working resolution, DETECTED IN
BATCHES by the port's MTCNN on the device, and aligned and cropped there by
the exact gather warp (one affine per face: eye-levelling rotation, margin
box, resize). The low-data augmentations run on the device from explicit
CPU generators (``ops/augment.py``). Kept from the reference: the
per-person 70/15/15 split (:309-328), the margin box (:89-106), 5 augmented
variants when a class has fewer than 20 train images (:353-396),
``max_samples_per_class``, ``test_mode``'s 3 persons x 10 images
(:284, :317), and a plain resize where no face is found. Without detector
weights the run is resize-only, with a warning, as the JAX package's is.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any

import numpy as np
import torch

from facerec_torch import resolve_device
from facerec_torch.config import PROC_DATA_DIR, RAW_DATA_DIR, PreprocessingConfig, logger

WORK_SIZE = 512  # letterbox resolution the detector runs at
IMAGE_SUFFIXES = {".jpg", ".jpeg", ".png", ".bmp", ".webp"}


def _letterbox(img: np.ndarray, size: int) -> tuple[np.ndarray, float]:
    """Resize keeping aspect to fit in (size, size), pad bottom/right."""
    from PIL import Image

    h, w = img.shape[:2]
    scale = size / max(h, w)
    nh, nw = max(int(round(h * scale)), 1), max(int(round(w * scale)), 1)
    im = Image.fromarray(img).resize((nw, nh), Image.BILINEAR)
    out = np.zeros((size, size, 3), np.uint8)
    out[:nh, :nw] = np.asarray(im)
    return out, scale


class BatchPreprocessor:
    """Batched detect -> align -> crop on ``device`` (default: the CUDA
    card). ``detector``: an ``MTCNN`` built for (WORK_SIZE, WORK_SIZE) with
    its weights loaded; when None and ``config.use_mtcnn``, the default
    weights are loaded, and without any the preprocessor resizes only."""

    def __init__(self, config: PreprocessingConfig, detector=None, batch_size: int = 32,
                 device: str | torch.device | None = None):
        self.config = config
        self.batch_size = batch_size
        self.device = resolve_device(device)
        self.detector = detector
        if config.use_mtcnn and detector is None:
            from facerec_torch.detect.weights import load_default_detector

            try:
                self.detector = load_default_detector(
                    (WORK_SIZE, WORK_SIZE), min_face_size=config.min_face_size,
                    thresholds=config.detection_thresholds, device=self.device)
            except FileNotFoundError as e:  # no weights: resize-only, as JAX's
                logger.warning("no detector weights available (%s); falling back to resize-only", e)

    def crops(self, chunk: torch.Tensor, det) -> torch.Tensor:
        """[B, WORK, WORK, 3] f32 frames and their ``Detections`` -> [B, S, S,
        3] f32 crops: the top-probability valid face per frame (reference
        data_prep.py:131-136) with margin and eye alignment, else the whole
        frame resized."""
        from facerec_torch.ops.image import align_and_crop_batched, bbox_with_margin, resize_bilinear

        out_size = self.config.final_size[0]
        best = torch.argmax(torch.where(det.valid, det.probs, -1.0), dim=1)
        bsel = torch.gather(det.boxes, 1, best[:, None, None].expand(-1, 1, 4))
        lsel = torch.gather(det.landmarks, 1, best[:, None, None, None].expand(-1, 1, 5, 2))
        vsel = torch.gather(det.valid, 1, best[:, None])[:, 0]
        bsel = bbox_with_margin(bsel, self.config.face_margin, (WORK_SIZE, WORK_SIZE))
        crops = align_and_crop_batched(chunk, bsel, lsel, out_size)[:, 0]
        fallback = resize_bilinear(chunk, (out_size, out_size))
        return torch.where(vsel[:, None, None, None], crops, fallback)

    def frames(self, images: list[np.ndarray]) -> np.ndarray:
        """The detector's input: each image letterboxed to WORK_SIZE, f32,
        padded with zero frames to a multiple of ``batch_size``, as the JAX
        package pads its static batches."""
        batch = np.stack([_letterbox(im, WORK_SIZE)[0] for im in images]).astype(np.float32)
        pad = (-len(batch)) % self.batch_size
        if pad:
            batch = np.concatenate([batch, np.zeros((pad, *batch.shape[1:]), np.float32)])
        return batch

    def process_batch(self, images: list[np.ndarray]) -> list[np.ndarray]:
        """uint8 RGB images (any sizes) -> final_size aligned crops (uint8).
        The frames go to the device in chunks of ``batch_size``."""
        out_size = self.config.final_size[0]
        if self.detector is None:
            from PIL import Image

            return [np.asarray(Image.fromarray(im).resize((out_size, out_size), Image.BILINEAR))
                    for im in images]

        batch = self.frames(images)
        crops_all = []
        for s in range(0, len(batch), self.batch_size):
            chunk = torch.from_numpy(batch[s : s + self.batch_size]).to(self.device)
            crops_all.append(self.crops(chunk, self.detector.detect(chunk)).cpu().numpy())
        crops = np.concatenate(crops_all)[: len(images)]
        return [np.clip(c, 0, 255).astype(np.uint8) for c in crops]


def process_raw_data(
    raw_dir: str | Path | None = None,
    out_dir: str | Path | None = None,
    config: PreprocessingConfig = PreprocessingConfig(),
    max_samples_per_class: int | None = None,
    test_mode: bool = False,
    detector=None,
    seed: int = 42,
    device: str | torch.device | None = None,
) -> Path:
    """Process ``raw_dir/<dataset>/<person>/<image>`` into
    ``out_dir/<dataset>/{train,val,test}/<person>/`` on ``device`` (default:
    the CUDA card), with ``preprocess_stats.json`` and ``config.json``;
    returns ``out_dir``. ``detector``: as ``BatchPreprocessor`` takes it.
    The augmented variants of person ``pi``'s ``j``-th source
    image come from a CPU generator seeded ``seed * 100_000 + pi * 100 +
    j``."""
    from PIL import Image

    from facerec_torch.ops.augment import AugmentParams, low_data_variants

    raw_dir = Path(raw_dir or RAW_DATA_DIR)
    out_base = Path(out_dir or (PROC_DATA_DIR / config.name))
    rng = np.random.default_rng(seed)
    pre = BatchPreprocessor(config, detector, device=device)
    aug_params = AugmentParams(
        rotation_degrees=config.rotation_degrees, brightness=config.brightness,
        contrast=config.contrast, scale=config.scale, horizontal_flip=config.horizontal_flip)

    datasets = [d for d in sorted(raw_dir.iterdir()) if d.is_dir()] if raw_dir.exists() else []
    if not datasets:
        raise FileNotFoundError(f"no raw datasets under {raw_dir}")
    stats: dict[str, Any] = {"config": config.to_dict(), "datasets": {}}
    for ds in datasets:
        persons = [p for p in sorted(ds.iterdir()) if p.is_dir()]
        if test_mode:
            persons = persons[:3]
        ds_stats = {}
        for pi, person in enumerate(persons):
            imgs = sorted(q for q in person.iterdir() if q.suffix.lower() in IMAGE_SUFFIXES)
            if test_mode:
                imgs = imgs[:10]
            if max_samples_per_class:
                imgs = imgs[:max_samples_per_class]
            if not imgs:
                continue
            order = rng.permutation(len(imgs))
            n_train = max(int(0.7 * len(imgs)), 1)
            n_val = max(int(0.15 * len(imgs)), 1) if len(imgs) > 2 else 0
            splits = {"train": order[:n_train],
                      "val": order[n_train : n_train + n_val],
                      "test": order[n_train + n_val :]}
            loaded = []
            for q in imgs:
                with Image.open(q) as im:
                    loaded.append(np.asarray(im.convert("RGB"), np.uint8))
            crops = pre.process_batch(loaded)
            for split, idxs in splits.items():
                d = out_base / ds.name / split / person.name
                if len(idxs):
                    d.mkdir(parents=True, exist_ok=True)
                for j, i in enumerate(idxs):
                    Image.fromarray(crops[i]).save(d / f"{person.name}_{j:04d}.jpg", quality=95)
            # low-data augmentation (reference data_prep.py:353-396)
            train_idx = splits["train"]
            if config.augment and len(train_idx) < config.low_data_threshold:
                d = out_base / ds.name / "train" / person.name
                for j, i in enumerate(train_idx[: min(len(train_idx), 10)]):
                    gen = torch.Generator().manual_seed(seed * 100_000 + pi * 100 + j)
                    image = torch.from_numpy(crops[i].astype(np.float32) / 255.0).to(pre.device)
                    var = low_data_variants(image, config.low_data_variants, aug_params, gen)
                    for v, arr in enumerate(var.cpu().numpy()):
                        Image.fromarray((arr * 255).astype(np.uint8)).save(
                            d / f"{person.name}_aug{j:02d}_{v}.jpg", quality=95)
            ds_stats[person.name] = {"images": len(imgs), "train": len(splits["train"]),
                                     "val": len(splits["val"]), "test": len(splits["test"])}
        stats["datasets"][ds.name] = ds_stats
        logger.info("processed %s: %d persons", ds.name, len(ds_stats))
    out_base.mkdir(parents=True, exist_ok=True)
    (out_base / "preprocess_stats.json").write_text(json.dumps(stats, indent=2))
    config.save_json(out_base / "config.json")
    return out_base
