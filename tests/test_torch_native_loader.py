"""The port's native JPEG loader against the JAX package's, and the repair it
makes: both trainers consume the same batches on a JPEG tree.

The port builds its own copy of the loader into ``build/`` with ``g++``; the
JAX package's tracked library (``facerec_tpu/data/native/
libfacerec_loader.so``) must stay untouched."""

import hashlib
import threading
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from facerec_torch import build
from facerec_torch.config import TrainConfig
from facerec_torch.data import native_loader
from facerec_torch.data.datasets import ClassificationBatcher, ImageFolderIndex
from facerec_torch.data.native_loader import NativeClassificationBatcher
from facerec_torch.data.synthetic import write_synthetic_imagefolder
from facerec_torch.train import engine as torch_engine
from facerec_tpu.config import TrainConfig as JaxTrainConfig
from facerec_tpu.data.datasets import ImageFolderIndex as JaxImageFolderIndex
from facerec_tpu.data.native_loader import NativeClassificationBatcher as JaxNativeBatcher
from facerec_tpu.data.native_loader import available as jax_available
from facerec_tpu.train import engine as jax_engine

REPO = Path(__file__).resolve().parent.parent
JAX_SO = REPO / "facerec_tpu" / "data" / "native" / "libfacerec_loader.so"


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _needs_loader():
    if not native_loader.available():
        pytest.skip("the native loader does not build here (no g++ or libjpeg headers)")


@pytest.fixture(scope="module")
def jpeg_tree(tmp_path_factory):
    """3 people x 10 faces of 40 px (resized to 32 by the batchers): 18
    train images (two full batches of 8 and a tail of 2), 6 val, 6 test."""
    return write_synthetic_imagefolder(tmp_path_factory.mktemp("jpeg_tree"), num_classes=3,
                                       per_class=10, size=40, seed=2)


def _batches(batcher, epoch):
    return [{k: np.array(v, copy=True) for k, v in b.items()} for b in batcher.epoch(epoch)]


@pytest.mark.parametrize("shuffle,seed", [(False, 0), (True, 0), (True, 7)])
def test_native_batcher_matches_jax(jpeg_tree, shuffle, seed):
    """Bit for bit the JAX native batcher's batches, epochs 0 and 1,
    including the masked tail."""
    if not jax_available():
        pytest.skip("the JAX package's native loader does not build here")
    ours = NativeClassificationBatcher(ImageFolderIndex.build(jpeg_tree / "train"), 8, 32,
                                       shuffle=shuffle, seed=seed)
    ref = JaxNativeBatcher(JaxImageFolderIndex.build(jpeg_tree / "train"), 8, 32,
                           shuffle=shuffle, seed=seed)
    assert len(ours) == len(ref) == 3
    orders = []
    for epoch in (0, 1):
        got, want = _batches(ours, epoch), _batches(ref, epoch)
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            for key in ("image", "label", "mask"):
                assert np.array_equal(g[key], w[key]), key
        assert got[-1]["mask"].tolist() == [1, 1, 0, 0, 0, 0, 0, 0]
        assert not got[-1]["image"][2:].any()
        orders.append(np.concatenate([b["label"] for b in got]))
    assert np.array_equal(orders[0], orders[1]) == (not shuffle)


def _write_random_jpegs(root: Path, shape, per_class: int, classes: int, seed: int):
    rng = np.random.default_rng(seed)
    for c in range(classes):
        d = root / f"cls{c}"
        d.mkdir(parents=True)
        for i in range(per_class):
            Image.fromarray(rng.integers(0, 255, shape, dtype=np.uint8)).save(
                d / f"{i}.jpg", quality=95)
    return ImageFolderIndex.build(root)


def test_native_loader_admits_a_slow_head_batch(tmp_path):
    """A 2,500 x 2,500 JPEG heads an unshuffled epoch of one-image batches
    read by 2 workers through a 3-batch window: while one worker decodes
    it, the other fills the window with later batches, and the large one
    must still be admitted. (The loader admitted batches by queue size, so
    the batch the consumer waited for waited behind a full queue and the
    epoch never ended.)"""
    rng = np.random.default_rng(0)
    d = tmp_path / "a"
    d.mkdir()
    Image.fromarray(rng.integers(0, 255, (2500, 2500, 3), dtype=np.uint8)).save(d / "000.jpg")
    for i in range(1, 12):
        Image.fromarray(rng.integers(0, 255, (32, 32, 3), dtype=np.uint8)).save(d / f"{i:03d}.jpg")
    batcher = NativeClassificationBatcher(ImageFolderIndex.build(tmp_path), 1, 32, shuffle=False,
                                          num_threads=2, queue_depth=1)
    got = []
    reader = threading.Thread(target=lambda: got.extend(b["mask"][0] for b in batcher.epoch(0)),
                              daemon=True)
    reader.start()
    reader.join(timeout=60)
    assert not reader.is_alive(), f"the epoch stalled after {len(got)} of 12 batches"
    assert got == [1.0] * 12


def test_native_loader_decodes_like_pil(tmp_path):
    """tests/test_data.py's bars: PIL's pixels within 2/255 mean, the label
    order without shuffling, and the tail mask."""
    index = _write_random_jpegs(tmp_path, (32, 32, 3), 3, 2, seed=0)
    b = NativeClassificationBatcher(index, batch_size=4, image_size=32, shuffle=False,
                                    normalize=False)
    batches = list(b.epoch(0))
    assert len(batches) == 2
    assert batches[0]["mask"].tolist() == [1, 1, 1, 1]
    assert batches[1]["mask"].tolist() == [1, 1, 0, 0]
    imgs = np.concatenate([batches[0]["image"], batches[1]["image"]])[:6]
    labels = np.concatenate([batches[0]["label"], batches[1]["label"]])[:6]
    assert labels.tolist() == index.labels.tolist()
    for j, p in enumerate(index.paths):
        ref = np.asarray(Image.open(p), np.float32) / 255.0
        diff = np.abs(imgs[j] - ref).mean()
        assert diff < 2.0 / 255.0, f"decode mismatch on {p}: mean abs {diff:.4f}"


def test_native_loader_imagenet_normalization(tmp_path):
    index = _write_random_jpegs(tmp_path, (24, 24, 3), 1, 1, seed=1)
    b = NativeClassificationBatcher(index, batch_size=1, image_size=24, shuffle=False,
                                    normalize=True)
    img = next(iter(b.epoch(0)))["image"][0]
    ref = np.asarray(Image.open(index.paths[0]), np.float32) / 255.0
    expect = (ref - np.asarray([0.485, 0.456, 0.406], np.float32)) / np.asarray(
        [0.229, 0.224, 0.225], np.float32)
    assert np.abs(img - expect).mean() < 0.02


def test_native_resize_close_to_pil(jpeg_tree):
    """The loader's bilinear resize (40 -> 32 px) against PIL's batcher:
    within 2/255 mean after normalisation is undone."""
    index = ImageFolderIndex.build(jpeg_tree / "val")
    nat = next(iter(NativeClassificationBatcher(index, 6, 32, shuffle=False,
                                                normalize=False).epoch(0)))
    pil = next(iter(ClassificationBatcher(index, 6, 32, shuffle=False, normalize=False).epoch(0)))
    assert np.array_equal(nat["label"], pil["label"])
    assert np.abs(nat["image"] - pil["image"]).mean() < 2.0 / 255.0


def test_port_build_leaves_the_jax_library_alone():
    """The port compiles its own copy into build/ and never rewrites the
    JAX package's tracked library."""
    jax_available()  # the JAX package rebuilds its own library first where it is stale
    before = (JAX_SO.stat().st_mtime_ns, hashlib.sha256(JAX_SO.read_bytes()).hexdigest())
    build.build_loader(force=True)
    lib = build.BUILD_DIR / f"lib{build.LOADER}.so"
    assert lib.exists() and lib.resolve() != JAX_SO.resolve()
    assert native_loader.available()
    after = (JAX_SO.stat().st_mtime_ns, hashlib.sha256(JAX_SO.read_bytes()).hexdigest())
    assert after == before


def test_trainer_picks_native_only_for_jpeg_trees(jpeg_tree, tmp_path):
    cfg = TrainConfig(batch_size=8, image_size=32)
    batchers, n = torch_engine._make_batchers(jpeg_tree, cfg)
    assert n == 3 and all(isinstance(b, NativeClassificationBatcher) for b in batchers.values())
    png = tmp_path / "png" / "train" / "cls0"
    png.mkdir(parents=True)
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(png / "a.png")
    batchers, _ = torch_engine._make_batchers(tmp_path / "png", cfg)
    assert isinstance(batchers["train"], ClassificationBatcher)
    assert batchers["val"] is None and batchers["test"] is None


def _record(module, monkeypatch) -> list:
    """Record every host batch that ``module``'s trainer hands its device
    prefetcher, in order."""
    seen = []
    orig = module.prefetch_to_device

    def rec(it, *args, **kwargs):
        def tee():
            for b in it:
                seen.append({k: np.array(v, copy=True) for k, v in b.items()})
                yield b
        return orig(tee(), *args, **kwargs)

    monkeypatch.setattr(module, "prefetch_to_device", rec)
    return seen


def test_both_trainers_consume_the_same_batches(jpeg_tree, tmp_path, monkeypatch):
    """Two epochs of a baseline on one JPEG tree: every train, val and test
    batch that the port's train_model consumes equals the JAX train_model's,
    in the same order. Batches, not losses: dropout draws differ by
    framework."""
    if not jax_available():
        pytest.skip("the JAX package's native loader does not build here")
    from facerec_tpu.train.engine import train_model as jax_train_model

    kw = dict(model_type="baseline", batch_size=8, epochs=2, image_size=32, seed=3,
              early_stopping=False, checkpoint_every=0, compute_dtype="float32")
    jax_seen = _record(jax_engine, monkeypatch)
    jax_train_model(JaxTrainConfig(**kw), jpeg_tree, checkpoints_root=tmp_path / "jax",
                    model_name="m")
    torch_seen = _record(torch_engine, monkeypatch)
    torch_engine.train_model(TrainConfig(**kw), jpeg_tree, checkpoints_root=tmp_path / "torch",
                             model_name="m", device="cpu")
    # per epoch 3 train and 1 val batches; then 1 test batch
    assert len(torch_seen) == len(jax_seen) == 2 * (3 + 1) + 1
    for i, (g, w) in enumerate(zip(torch_seen, jax_seen)):
        assert g.keys() == w.keys()
        for key in g:
            assert np.array_equal(g[key], w[key]), (i, key)
    train0 = np.concatenate([b["label"] for b in torch_seen[:3]])
    train1 = np.concatenate([b["label"] for b in torch_seen[4:7]])
    assert not np.array_equal(train0, train1)  # the epochs are shuffled apart
