"""ctypes bindings for the native JPEG loader (``facerec_torch/csrc/loader.cpp``,
counterpart of ``facerec_tpu/data/native_loader.py``).

``NativeClassificationBatcher`` has the contract of
:class:`facerec_torch.data.datasets.ClassificationBatcher` (``epoch(i)`` yields
batch dicts) and is backed by a libjpeg thread pool instead of per-image PIL
decodes. Its batches equal the JAX package's native batcher's bit for bit:
the same source, and the same shuffle (``std::mt19937_64`` and
``std::shuffle`` seeded with ``seed * 100_003 + epoch``). :func:`available`
says whether the library builds and loads (``g++`` and the libjpeg headers;
``facerec_torch.build.build_loader``); without it the trainer uses the PIL
batcher, as the JAX trainer does. Every call into the library releases the
interpreter lock (``ctypes.CDLL``), so a prefetch thread decodes beside the
step.
"""

from __future__ import annotations

import ctypes
from ctypes import POINTER, c_char_p, c_float, c_int, c_int32, c_int64, c_void_p
from types import SimpleNamespace

import numpy as np

from facerec_torch import build

_SIGNATURES = {  # symbol: (argument types, return type)
    "loader_create": ((POINTER(c_char_p), POINTER(c_int32), c_int64, c_int, c_int, c_int, c_int,
                       c_int), c_void_p),
    "loader_start_epoch": ((c_void_p, c_int64), None),
    "loader_num_batches": ((c_void_p,), c_int64),
    "loader_next_batch": ((c_void_p, POINTER(c_float), POINTER(c_int32), POINTER(c_float)),
                          c_int),
    "loader_destroy": ((c_void_p,), None),
}


def _load() -> SimpleNamespace:
    """The library's functions, bound once (built first if needed)."""
    return SimpleNamespace(**{name: build.function(build.LOADER, name, args, res)
                              for name, (args, res) in _SIGNATURES.items()})


def available() -> bool:
    """Whether the loader library builds and loads here."""
    try:
        _load()
        return True
    except (RuntimeError, OSError):
        return False


class NativeClassificationBatcher:
    """Iterating ``epoch(e)`` yields ``{"image" [B,S,S,3] f32, "label" [B]
    i32, "mask" [B] f32}``; the final partial batch is zero-padded and
    masked."""

    def __init__(self, index, batch_size: int, image_size: int, shuffle: bool = True,
                 seed: int = 0, normalize: bool = True, num_threads: int = 6,
                 queue_depth: int = 4):
        self._lib = lib = _load()
        self.index = index
        self.batch_size = batch_size
        self.image_size = image_size
        self.shuffle = shuffle
        self.seed = seed
        paths = [str(p).encode() for p in index.paths]
        # the library copies paths and labels in loader_create; the buffers
        # are kept for the object's life all the same
        self._path_buf = (ctypes.c_char_p * len(paths))(*paths)
        self._labels = np.ascontiguousarray(index.labels, np.int32)
        self._handle = lib.loader_create(
            self._path_buf, self._labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(paths), batch_size, image_size, num_threads, int(normalize), queue_depth)
        self._epoch = 0

    def __len__(self) -> int:
        return -(-len(self.index.paths) // self.batch_size)

    def epoch(self, epoch: int | None = None):
        if epoch is None:
            epoch = self._epoch
            self._epoch += 1
        lib = self._lib
        seed = (self.seed * 100_003 + epoch) if self.shuffle else -1
        lib.loader_start_epoch(self._handle, seed)
        n = lib.loader_num_batches(self._handle)
        s = self.image_size
        for _ in range(n):
            images = np.empty((self.batch_size, s, s, 3), np.float32)
            labels = np.empty(self.batch_size, np.int32)
            mask = np.empty(self.batch_size, np.float32)
            ok = lib.loader_next_batch(
                self._handle,
                images.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                mask.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
            if not ok:
                return
            yield {"image": images, "label": labels, "mask": mask}

    def __iter__(self):
        return self.epoch()

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._handle = None
            self._lib.loader_destroy(handle)
