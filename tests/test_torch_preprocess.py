"""The port's preprocessing (``facerec_torch/data/preprocess.py``) against
the JAX package's (``facerec_tpu/data/preprocess.py``) on the CPU.

Both packages' ``WORK_SIZE`` is shrunk from 512 to 160 here (JAX's jit of
the cascade stays cheap) and the crops to 64 px; the committed
``outputs/detector`` weights detect in both. Bars:

  * the letterbox, the resize-only path and every file of a resize-only
    ``process_raw_data`` but the augmented ones are byte-equal;
  * given the same detections, the crops are within 1 uint8 level (the
    warp is f32 on both sides), and ``process_raw_data``'s JPEG files
    decode within 8 levels of JAX's (most are byte-equal);
  * end to end, both cascades choose the same faces. On the 4 photos of
    ``test_process_batch_matches_jax`` they hold the detector's 0.25 px
    bound (tests/test_torch_detect.py::test_mtcnn_matches_jax), and the
    crops then differ by at most 4 levels and 0.25 on average (measured 1
    and 0.016). A crop moves by the box's move times the local contrast,
    so the raw tree, whose low-probability faces move up to 0.74 px, is
    held on its detections (1 px) instead;
  * the augmented files come from the port's torch stream, not JAX's
    threefry: their names and counts equal JAX's, and each is the port's
    ``low_data_variants`` of its source crop under the generator seeded
    ``seed * 100_000 + pi * 100 + j``.

tests/data_side_numbers.py prints the measured values quoted here.
"""

import io
import json
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import facerec_torch.data.preprocess as tp
import facerec_tpu.data.preprocess as jp
from facerec_torch.config import PreprocessingConfig
from facerec_torch.data.synthetic import face_frames
from facerec_torch.detect.mtcnn import Detections
from facerec_torch.detect.weights import load_default_detector
from facerec_torch.ops.augment import AugmentParams, low_data_variants
from facerec_tpu.config import PreprocessingConfig as JaxPreprocessingConfig
from facerec_tpu.detect.weights import load_default_detector as jax_load_default_detector

WORK = 160
FINAL = (64, 64)
END_TO_END_MEAN, END_TO_END_MAX = 0.25, 4


@pytest.fixture(autouse=True)
def _one_thread(monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.setattr(jp, "WORK_SIZE", WORK)
    monkeypatch.setattr(tp, "WORK_SIZE", WORK)


@pytest.fixture(scope="module")
def detectors():
    jdet, jparams = jax_load_default_detector((WORK, WORK))
    return jdet, jparams, load_default_detector((WORK, WORK), device="cpu")


@pytest.fixture(scope="module")
def photos():
    return [f.astype(np.uint8) for f in face_frames(4, (120, 160), 1, np.random.default_rng(0))]


@pytest.fixture(scope="module")
def raw_tree(tmp_path_factory):
    """1 dataset x 3 persons x 6 JPEG photos of one rendered face each."""
    root = tmp_path_factory.mktemp("raw")
    frames = face_frames(18, (120, 160), 1, np.random.default_rng(1)).astype(np.uint8)
    for i, f in enumerate(frames):
        d = root / "ds0" / f"person_{i // 6}"
        d.mkdir(parents=True, exist_ok=True)
        Image.fromarray(f).save(d / f"img_{i % 6:02d}.jpg", quality=95)
    return root


def _configs(**kw):
    return JaxPreprocessingConfig(final_size=FINAL, **kw), PreprocessingConfig(final_size=FINAL, **kw)


def _tree(root):
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file()}


@pytest.mark.parametrize("hw", [(120, 160), (160, 120), (100, 100), (37, 301), (7, 3)])
def test_letterbox_matches_jax(hw):
    img = np.random.default_rng(hw[0]).integers(0, 256, (*hw, 3), dtype=np.uint8)
    for size in (64, 160):
        got, gs = tp._letterbox(img, size)
        ref, rs = jp._letterbox(img, size)
        assert gs == rs and got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)


def test_preprocessing_config_matches_jax(tmp_path):
    jc, tc = JaxPreprocessingConfig(), PreprocessingConfig()
    assert tc.to_dict() == jc.to_dict()
    tc2 = PreprocessingConfig(name="x", detection_thresholds=(0.1, 0.2, 0.3), use_mtcnn=False)
    jc2 = JaxPreprocessingConfig(name="x", detection_thresholds=(0.1, 0.2, 0.3), use_mtcnn=False)
    assert tc2.to_dict() == jc2.to_dict()
    tc2.save_json(tmp_path / "t.json")
    jc2.save_json(tmp_path / "j.json")
    assert (tmp_path / "t.json").read_text() == (tmp_path / "j.json").read_text()
    assert PreprocessingConfig.load_json(tmp_path / "j.json") == tc2


def test_process_batch_same_detections_match_jax(photos, detectors):
    """JAX's detections fed to both packages' crop step."""
    jdet, jparams, _ = detectors
    frames = np.stack([jp._letterbox(p, WORK)[0] for p in photos]).astype(np.float32)
    jd = jdet.detect(jparams, jnp.asarray(frames))
    assert np.asarray(jd.valid).any(axis=1).all()
    td = Detections(*(torch.from_numpy(np.array(a)) for a in jd))

    class Fixed:
        def __init__(self, d):
            self.d = d

        def detect(self, *_):
            return self.d

    jc, tc = _configs()
    ref = jp.BatchPreprocessor(jc, Fixed(jd), jparams, batch_size=4).process_batch(photos)
    got = tp.BatchPreprocessor(tc, Fixed(td), batch_size=4, device="cpu").process_batch(photos)
    for a, b in zip(got, ref):
        assert a.shape == b.shape == (*FINAL, 3) and a.dtype == b.dtype == np.uint8
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1


def test_process_batch_matches_jax(photos, detectors):
    """End to end on 4 photos: the chosen faces move under 0.25 px (the
    detector's bound), and the crops by the move times the photos' local
    contrast (their backgrounds are per-pixel noise of 0-80 levels)."""
    jdet, jparams, tdet = detectors
    assert _offsets(photos, detectors).max() <= 0.25
    jc, tc = _configs()
    ref = np.stack(jp.BatchPreprocessor(jc, jdet, jparams, batch_size=4).process_batch(photos))
    pre = tp.BatchPreprocessor(tc, tdet, batch_size=4, device="cpu")
    got = np.stack(pre.process_batch(photos))
    d = np.abs(got.astype(int) - ref.astype(int))
    assert d.mean() <= END_TO_END_MEAN and d.max() <= END_TO_END_MAX, (d.mean(), d.max())
    # the last batch padded with zero frames, as JAX pads it
    assert pre.frames(photos[:3]).shape == (4, WORK, WORK, 3)
    assert not pre.frames(photos[:3])[3].any()


def test_process_batch_resize_only_matches_jax(photos):
    jc, tc = _configs(use_mtcnn=False)
    ref = jp.BatchPreprocessor(jc).process_batch(photos)
    got = tp.BatchPreprocessor(tc, device="cpu").process_batch(photos)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


def _aug_names(root):
    return sorted(p.name for p in root.rglob("*_aug*.jpg"))


def _split_files(tree):
    return {k: v for k, v in tree.items() if k.endswith(".jpg") and "_aug" not in k}


def test_process_raw_data_resize_only_matches_jax(raw_tree, tmp_path):
    jc, tc = _configs(use_mtcnn=False)
    ref_dir = jp.process_raw_data(raw_tree, tmp_path / "jax", jc)
    got_dir = tp.process_raw_data(raw_tree, tmp_path / "port", tc, device="cpu")
    ref, got = _tree(ref_dir), _tree(got_dir)
    assert _split_files(got) == _split_files(ref)  # byte-equal
    assert len(_split_files(got)) == 18
    for name in ("preprocess_stats.json", "config.json"):
        assert json.loads(got[name]) == json.loads(ref[name])
        assert got[name] == ref[name]
    assert _aug_names(got_dir) == _aug_names(ref_dir)
    assert len(_aug_names(got_dir)) == 3 * 4 * 5  # 4 train images x 5 variants per person


def _offsets(photos, detectors) -> np.ndarray:
    """Per photo, the largest move of the chosen face's box and landmarks
    (px), the port's detector against JAX's; both choose the same face."""
    jdet, jparams, tdet = detectors
    x = np.stack([jp._letterbox(p, WORK)[0] for p in photos]).astype(np.float32)
    jd = jdet.detect(jparams, jnp.asarray(x))
    td = tdet.detect(torch.from_numpy(x))
    np.testing.assert_array_equal(td.valid.numpy(), np.asarray(jd.valid))
    out = []
    for i in range(len(photos)):
        jb = int(np.argmax(np.where(np.asarray(jd.valid[i]), np.asarray(jd.probs[i]), -1.0)))
        tb = int(torch.argmax(torch.where(td.valid[i], td.probs[i], -1.0)))
        assert jb == tb
        out.append(max(np.abs(td.boxes[i, tb].numpy() - np.asarray(jd.boxes[i, jb])).max(),
                       np.abs(td.landmarks[i, tb].numpy() - np.asarray(jd.landmarks[i, jb])).max()))
    return np.asarray(out)


class JaxBackedDetector:
    """The port's detector interface (torch frames in, torch
    ``Detections`` out) answered by JAX's cascade."""

    def __init__(self, jdet, jparams):
        self.jdet, self.jparams = jdet, jparams

    def detect(self, chunk: torch.Tensor) -> Detections:
        d = self.jdet.detect(self.jparams, jnp.asarray(chunk.numpy()))
        return Detections(*(torch.from_numpy(np.array(a)) for a in d))


def test_process_raw_data_with_detector_matches_jax(raw_tree, tmp_path, detectors):
    """With JAX's detections, the split files decode to JAX's within the
    JPEG of a 1-level crop difference, and the JSON files are byte-equal;
    with the port's own detector the same faces are
    chosen and their boxes and landmarks move by at most 1 px (measured:
    0.47 and 0.74 px on the faces at p 0.85 and 0.69, under 0.08 px on the
    others, at p 0.97 and above)."""
    jdet, jparams, tdet = detectors
    jc, tc = _configs()
    ref_dir = jp.process_raw_data(raw_tree, tmp_path / "jax", jc, detector=jdet,
                                  detector_params=jparams)
    got_dir = tp.process_raw_data(raw_tree, tmp_path / "port", tc,
                                  detector=JaxBackedDetector(jdet, jparams), device="cpu")
    ref, got = _tree(ref_dir), _tree(got_dir)
    ref_files, got_files = _split_files(ref), _split_files(got)
    assert sorted(got_files) == sorted(ref_files) and len(got_files) == 18
    same = sum(got_files[k] == ref_files[k] for k in ref_files)
    d = np.stack([np.abs(np.asarray(Image.open(io.BytesIO(got_files[k])), np.int32)
                         - np.asarray(Image.open(io.BytesIO(ref_files[k])), np.int32))
                  for k in ref_files])
    # crops within 1 level; a 1-level flip moves a q95 JPEG block by a few
    # levels once encoded (measured: 15 of 18 files byte-equal, mean 0.003,
    # max 5)
    assert same >= 9 and d.mean() <= 0.05 and d.max() <= 8, (same, d.mean(), d.max())
    for name in ("preprocess_stats.json", "config.json"):
        assert got[name] == ref[name]
    own_dir = tp.process_raw_data(raw_tree, tmp_path / "own", tc, detector=tdet, device="cpu")
    assert sorted(_split_files(_tree(own_dir))) == sorted(_split_files(ref))
    assert _aug_names(own_dir) == _aug_names(ref_dir) and len(_aug_names(own_dir)) == 60
    for person in sorted((raw_tree / "ds0").iterdir()):
        photos = []
        for q in sorted(person.iterdir()):
            with Image.open(q) as im:
                photos.append(np.asarray(im.convert("RGB"), np.uint8))
        assert _offsets(photos, detectors).max() <= 1.0


def test_augmented_files_come_from_the_seeded_generators(raw_tree, tmp_path):
    """Each ``<person>_aug<j>_<v>.jpg`` is variant v of the port's
    ``low_data_variants`` of the j-th train crop, drawn from the generator
    seeded ``seed * 100_000 + pi * 100 + j``; a rerun writes the same bytes,
    another seed other ones."""
    _, tc = _configs(use_mtcnn=False)
    out = tp.process_raw_data(raw_tree, tmp_path / "a", tc, seed=3, device="cpu")
    again = tp.process_raw_data(raw_tree, tmp_path / "b", tc, seed=3, device="cpu")
    other = tp.process_raw_data(raw_tree, tmp_path / "c", tc, seed=4, device="cpu")
    assert _tree(out) == _tree(again)
    augs = {k: v for k, v in _tree(out).items() if "_aug" in k}
    assert augs != {k: v for k, v in _tree(other).items() if "_aug" in k}
    # person 1, source j = 2: its train crop is the resize of its j-th train image
    rng = np.random.default_rng(3)
    rng.permutation(6)  # person 0's split
    order = rng.permutation(6)
    src = sorted((raw_tree / "ds0" / "person_1").iterdir())[order[2]]
    with Image.open(src) as im:
        crop = np.asarray(Image.fromarray(np.asarray(im.convert("RGB"))).resize(FINAL, Image.BILINEAR))
    gen = torch.Generator().manual_seed(3 * 100_000 + 1 * 100 + 2)
    var = low_data_variants(torch.from_numpy(crop.astype(np.float32) / 255.0), 5,
                            AugmentParams(), gen).numpy()
    for v in range(5):
        buf = io.BytesIO()
        Image.fromarray((var[v] * 255).astype(np.uint8)).save(buf, "JPEG", quality=95)
        assert augs[f"ds0/train/person_1/person_1_aug02_{v}.jpg"] == buf.getvalue()


@pytest.mark.parametrize("kw", [{"test_mode": True}, {"max_samples_per_class": 4},
                                {"test_mode": True, "max_samples_per_class": 2}])
def test_process_raw_data_truncation_matches_jax(tmp_path, kw):
    """test_mode's 3 persons x 10 images and the per-class cap, on 4
    persons x 12 photos, resize-only and without augmentation."""
    root = tmp_path / "raw"
    rng = np.random.default_rng(2)
    for p in range(4):
        d = root / "ds0" / f"p{p}"
        d.mkdir(parents=True)
        for i in range(12):
            Image.fromarray(rng.integers(0, 256, (20, 24, 3), dtype=np.uint8)).save(d / f"{i:02d}.png")
    jc, tc = _configs(use_mtcnn=False, augment=False)
    ref = _tree(jp.process_raw_data(root, tmp_path / "jax", jc, **kw))
    got = _tree(tp.process_raw_data(root, tmp_path / "port", tc, device="cpu", **kw))
    assert got == ref


def test_no_weights_means_resize_only(monkeypatch, caplog, photos):
    """Without detector weights the preprocessor warns and resizes, as JAX's
    does; a missing card is not a missing file and raises."""
    import facerec_torch.detect.weights as w

    def missing(*a, **k):
        raise FileNotFoundError("no MTCNN .npz weights")

    monkeypatch.setattr(w, "load_default_detector", missing)
    with caplog.at_level(logging.WARNING, logger="facerec_torch"):
        pre = tp.BatchPreprocessor(PreprocessingConfig(final_size=FINAL), device="cpu")
    assert pre.detector is None and "resize-only" in caplog.text
    ref = jp.BatchPreprocessor(JaxPreprocessingConfig(final_size=FINAL, use_mtcnn=False))
    for a, b in zip(pre.process_batch(photos), ref.process_batch(photos)):
        np.testing.assert_array_equal(a, b)

    def no_card(*a, **k):
        raise RuntimeError("no CUDA card")

    monkeypatch.setattr(w, "load_default_detector", no_card)
    with pytest.raises(RuntimeError):
        tp.BatchPreprocessor(PreprocessingConfig(), device="cpu")


def test_empty_raw_dir_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        tp.process_raw_data(tmp_path, tmp_path / "out", PreprocessingConfig(use_mtcnn=False),
                            device="cpu")
