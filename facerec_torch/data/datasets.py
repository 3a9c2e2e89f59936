"""Host-side datasets (copied from ``facerec_tpu/data/datasets.py``): a flat
ImageFolder index and a batcher that serves whole batches of decoded,
resized numpy arrays. All randomness flows from numpy Generators seeded per
epoch, so a batch stream is a function of (seed, epoch), and the port's
batches equal the JAX package's.

The Siamese pair batcher is not ported yet (ROADMAP).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Iterator

import numpy as np

IMG_EXTS = {".jpg", ".jpeg", ".png", ".bmp", ".webp"}


def _load_image(path: str | Path, size: int) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        im = im.convert("RGB")
        if im.size != (size, size):
            im = im.resize((size, size), Image.BILINEAR)
        return np.asarray(im, np.uint8)


@dataclasses.dataclass
class ImageFolderIndex:
    """Flat index over ``root/<class>/<image>`` (torchvision ImageFolder layout)."""

    root: Path
    paths: list[Path]
    labels: np.ndarray  # int32 [N]
    class_names: list[str]

    @classmethod
    def build(cls, root: str | Path) -> "ImageFolderIndex":
        root = Path(root)
        class_names = sorted(d.name for d in root.iterdir() if d.is_dir())
        paths, labels = [], []
        for c, name in enumerate(class_names):
            for p in sorted((root / name).iterdir()):
                if p.suffix.lower() in IMG_EXTS:
                    paths.append(p)
                    labels.append(c)
        if not paths:
            raise FileNotFoundError(f"no images under {root}")
        return cls(root=root, paths=paths, labels=np.asarray(labels, np.int32), class_names=class_names)

    def __len__(self) -> int:
        return len(self.paths)

    @property
    def num_classes(self) -> int:
        return len(self.class_names)


def _imagenet_normalize(x: np.ndarray) -> np.ndarray:
    """uint8 NHWC -> float32 NHWC, ImageNet-normalised."""
    mean = np.array([0.485, 0.456, 0.406], np.float32)
    std = np.array([0.229, 0.224, 0.225], np.float32)
    return (x.astype(np.float32) / 255.0 - mean) / std


class ClassificationBatcher:
    """Batched iterator over an ImageFolderIndex.

    Yields dicts ``{"image": [B,H,W,3] f32, "label": [B] i32, "mask": [B]
    f32}``. The final partial batch is padded to ``batch_size`` and masked,
    so every batch has one shape."""

    def __init__(
        self,
        index: ImageFolderIndex,
        batch_size: int,
        image_size: int,
        shuffle: bool = True,
        seed: int = 0,
        drop_remainder: bool = False,
        normalize: bool = True,
    ):
        self.index = index
        self.batch_size = batch_size
        self.image_size = image_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_remainder = drop_remainder
        self.normalize = normalize
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.index)
        return n // self.batch_size if self.drop_remainder else -(-n // self.batch_size)

    def epoch(self, epoch: int | None = None) -> Iterator[dict]:
        if epoch is None:
            epoch = self._epoch
            self._epoch += 1
        order = np.arange(len(self.index))
        if self.shuffle:
            np.random.default_rng((self.seed, epoch)).shuffle(order)
        bs = self.batch_size
        stop = (len(order) // bs) * bs if self.drop_remainder else len(order)
        for s in range(0, stop, bs):
            idx = order[s : s + bs]
            imgs = np.stack([_load_image(self.index.paths[i], self.image_size) for i in idx])
            labels = self.index.labels[idx]
            mask = np.ones(len(idx), np.float32)
            if len(idx) < bs:  # pad the final batch, mask out the padding
                pad = bs - len(idx)
                imgs = np.concatenate([imgs, np.zeros((pad, *imgs.shape[1:]), imgs.dtype)])
                labels = np.concatenate([labels, np.zeros(pad, np.int32)])
                mask = np.concatenate([mask, np.zeros(pad, np.float32)])
            x = _imagenet_normalize(imgs) if self.normalize else imgs.astype(np.float32) / 255.0
            yield {"image": x, "label": labels, "mask": mask}

    def __iter__(self):
        return self.epoch()
