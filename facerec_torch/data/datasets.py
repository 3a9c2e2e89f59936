"""Host-side datasets (copied from ``facerec_tpu/data/datasets.py``): a flat
ImageFolder index, a classification batcher and a Siamese pair batcher, each
serving whole batches of decoded, resized numpy arrays. All randomness flows
from numpy Generators seeded per epoch, so a batch stream is a function of
(seed, epoch), and the port's batches equal the JAX package's.
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


class SiamesePairBatcher:
    """Pair batches for verification training and evaluation.

    * Training: random pairs, each a same-identity pair with probability
      1/2 (when the anchor's class has another image), drawn from
      ``default_rng((seed, epoch))``.
    * ``fixed_pairs=True``: deterministic evaluation pairs, one positive
      and one negative anchored at every image, shuffled once by ``seed``.

    Yields ``{"image_a", "image_b", "pair_label" (1 = same), "label_a",
    "label_b", "mask"}``, the last batch padded and masked."""

    def __init__(
        self,
        index: ImageFolderIndex,
        batch_size: int,
        image_size: int,
        fixed_pairs: bool = False,
        pairs_per_epoch: int | None = None,
        seed: int = 0,
        normalize: bool = True,
    ):
        self.index = index
        self.batch_size = batch_size
        self.image_size = image_size
        self.fixed_pairs = fixed_pairs
        self.seed = seed
        self.normalize = normalize
        self.pairs_per_epoch = pairs_per_epoch or len(index)
        self._by_class = {c: np.flatnonzero(index.labels == c) for c in range(index.num_classes)}
        self._by_class = {c: v for c, v in self._by_class.items() if len(v) > 0}
        self._fixed = self._generate_fixed_pairs() if fixed_pairs else None
        self._epoch = 0

    def _generate_fixed_pairs(self) -> list[tuple[int, int, int]]:
        rng = np.random.default_rng(self.seed)
        pairs: list[tuple[int, int, int]] = []
        labels = self.index.labels
        classes = list(self._by_class)
        for i in range(len(self.index)):
            c = int(labels[i])
            same = self._by_class[c]
            if len(same) > 1:
                j = int(same[(np.flatnonzero(same == i)[0] + 1) % len(same)])
                pairs.append((i, j, 1))
            others = [oc for oc in classes if oc != c]
            if others:
                oc = others[i % len(others)]
                j = int(self._by_class[oc][i % len(self._by_class[oc])])
                pairs.append((i, j, 0))
        rng.shuffle(pairs)
        return pairs

    def _random_pairs(self, epoch: int) -> list[tuple[int, int, int]]:
        rng = np.random.default_rng((self.seed, epoch))
        labels = self.index.labels
        classes = list(self._by_class)
        pairs = []
        for _ in range(self.pairs_per_epoch):
            i = int(rng.integers(len(self.index)))
            c = int(labels[i])
            if rng.random() < 0.5 and len(self._by_class[c]) > 1:  # same pair
                j = i
                while j == i:
                    j = int(rng.choice(self._by_class[c]))
                pairs.append((i, j, 1))
            else:  # different pair
                oc = c
                while oc == c and len(classes) > 1:
                    oc = int(rng.choice(classes))
                pairs.append((i, int(rng.choice(self._by_class[oc])), 0))
        return pairs

    def __len__(self) -> int:
        n = len(self._fixed) if self.fixed_pairs else self.pairs_per_epoch
        return -(-n // self.batch_size)

    def epoch(self, epoch: int | None = None) -> Iterator[dict]:
        if epoch is None:
            epoch = self._epoch
            self._epoch += 1
        pairs = self._fixed if self.fixed_pairs else self._random_pairs(epoch)
        bs = self.batch_size
        for s in range(0, len(pairs), bs):
            chunk = pairs[s : s + bs]
            ia = [p[0] for p in chunk]
            ib = [p[1] for p in chunk]
            y = np.asarray([p[2] for p in chunk], np.int32)
            a = np.stack([_load_image(self.index.paths[i], self.image_size) for i in ia])
            b = np.stack([_load_image(self.index.paths[i], self.image_size) for i in ib])
            la = self.index.labels[ia]
            lb = self.index.labels[ib]
            mask = np.ones(len(chunk), np.float32)
            if len(chunk) < bs:
                pad = bs - len(chunk)
                a = np.concatenate([a, np.zeros((pad, *a.shape[1:]), a.dtype)])
                b = np.concatenate([b, np.zeros((pad, *b.shape[1:]), b.dtype)])
                y = np.concatenate([y, np.zeros(pad, np.int32)])
                la = np.concatenate([la, np.zeros(pad, np.int32)])
                lb = np.concatenate([lb, np.zeros(pad, np.int32)])
                mask = np.concatenate([mask, np.zeros(pad, np.float32)])
            norm = _imagenet_normalize if self.normalize else lambda v: v.astype(np.float32) / 255.0
            yield {
                "image_a": norm(a),
                "image_b": norm(b),
                "pair_label": y,
                "label_a": la,
                "label_b": lb,
                "mask": mask,
            }

    def __iter__(self):
        return self.epoch()

    def get_image_identities(self) -> list[str]:
        """The person's name of each image."""
        return [self.index.class_names[c] for c in self.index.labels]
