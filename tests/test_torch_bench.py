"""``facerec_torch.bench`` (the counterpart of the root ``bench.py``) against
the JAX package on the CPU: the same frames, bench.py's line less
``vs_baseline``, and the detector's fill equal to JAX's ``FacePipeline`` on
the same frames (XLA top-k on the CPU, no Pallas)."""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as jax_bench
import facerec_tpu.data.synthetic as jax_synthetic
from facerec_torch import bench
from facerec_torch.data.synthetic import face_frames
from facerec_tpu.config import ServeConfig as JaxServeConfig
from facerec_tpu.detect.mtcnn import MTCNN as JaxMTCNN
from facerec_tpu.detect.weights import load_detector_params as jax_load
from facerec_tpu.models import get_model
from facerec_tpu.serve.pipeline import FacePipeline as JaxFacePipeline

HW = (240, 320)  # the smallest round size whose 3 x 3 cells hold bench.py's 64 px faces
# bench.py's line, less vs_baseline (a target set for a TPU v5e-8)
KEYS = ("metric", "value", "unit", "detected", "detected_expected", "detected_ok",
        "detected_p090", "detected_p090_ok")


@pytest.fixture(autouse=True)
def _one_thread(monkeypatch):
    torch.set_num_threads(1)
    # JAX's renderer draws the hair style from hash(), which changes with
    # PYTHONHASHSEED; the port draws it from crc32
    monkeypatch.setattr(jax_synthetic, "hash", lambda s: zlib.crc32(s.encode()), raising=False)


@pytest.mark.parametrize("batch,hw", [(2, HW), (1, bench.FRAME_HW)])
def test_frames_equal_bench_py(batch, hw):
    got = face_frames(batch, hw, bench.MAX_FACES, np.random.default_rng(0))
    ref = jax_bench._face_frames(batch, hw, bench.MAX_FACES, np.random.default_rng(0))
    assert got.dtype == ref.dtype and np.array_equal(got, ref)


@pytest.fixture(scope="module")
def port_run():
    """The bench path on the CPU: 2 frames, a 16-row gallery, 1 timed step."""
    torch.set_num_threads(1)
    pipe, frames = bench.prepare(batch=2, gallery=16, frame_hw=HW, device="cpu")
    out, note = bench.measure(pipe, frames, iters=1)
    return pipe, frames, out, note


def test_line_has_bench_py_keys(port_run):
    pipe, _, out, note = port_run
    assert tuple(out) == KEYS
    assert out["metric"] == bench.METRIC and out["unit"] == "faces/sec/chip" and out["value"] > 0
    assert out["detected_expected"] == 2 * bench.MAX_FACES
    assert out["detected_ok"] == (out["detected"] >= bench.BAR * 16)
    assert out["detected_p090_ok"] == (out["detected_p090"] >= bench.BAR * 16)
    assert pipe.gallery.count == 8 and pipe.config.top_k == 5 and pipe.config.embed_size == 160
    assert pipe.detector.k_rnet == 32 and pipe.detector.dtype == torch.bfloat16
    assert note["timing"] == "host_clock" and note["device_ms_per_step"] is None
    line = bench.note_line(note)
    assert line.startswith("# frames/sec=") and line.endswith(" card=cpu")
    assert "device_ms_per_step=not_measured" in line and "frame=240x320" in line


def test_detected_matches_jax(port_run):
    """JAX's ``FacePipeline`` at bench.py's configuration on the same frames
    (bf16 detector, committed weights, bench.py's random ArcFace): the same
    fill at p >= 0.6 and the same valid slots, as
    tests/test_torch_pipeline.py holds the serve step. At p >= 0.9 one face
    may cross: the two bf16 cascades round apart, and on these frames one
    face scores 0.879 in the port, 0.992 in JAX's bf16 cascade and 0.853 in
    its f32 one."""
    _, frames, out, _ = port_run
    cfg = JaxServeConfig(max_faces=8, gallery_capacity=16, top_k=5, embed_size=160,
                         detection_threshold=0.0)
    det = JaxMTCNN(HW, min_face_size=40, max_faces=8, k_pnet=64, k_rnet=32, dtype=jnp.bfloat16,
                   input_range="255")
    emb = get_model("arcface", num_classes=18, compute_dtype="bfloat16")
    v = emb.init({"params": jax.random.key(1), "dropout": jax.random.key(2)},
                 jnp.zeros((1, 160, 160, 3)), labels=jnp.zeros(1, jnp.int32), train=True)
    pipe = JaxFacePipeline(cfg, HW, det, jax_load(),
                           lambda ev, x: emb.apply(ev, x, method="embed"), embed_dim=512,
                           embed_variables={"params": v["params"],
                                            "batch_stats": v["batch_stats"]})
    pipe.gallery.add_many([f"id_{i}" for i in range(8)],
                          np.random.default_rng(1).normal(size=(8, 512)).astype(np.float32))
    ref = jax.device_get(pipe.process(frames))
    probs = np.asarray(ref.probs, np.float32)
    assert out["detected"] == int((probs >= 0.6).sum()) and out["detected"] >= 12
    assert abs(out["detected_p090"] - int((probs >= 0.9).sum())) <= 1
    np.testing.assert_array_equal(port_run[0].process(frames).valid.numpy(), np.asarray(ref.valid))


def test_gallery_above_the_host_limit_fills_on_the_device(monkeypatch):
    """Above ``HOST_GALLERY_MAX`` rows the half-filled gallery is made from
    seeded normals on the device (``add_many_device``), as bench.py does at
    production scale; below it from the rng, one upload."""
    from facerec_torch.serve.gallery import GalleryStore

    class Pipe:
        device = torch.device("cpu")

        def __init__(self, capacity):
            self.gallery = GalleryStore(capacity=capacity, dim=512, dtype="bfloat16", device="cpu")

    monkeypatch.setattr(bench, "HOST_GALLERY_MAX", 4)
    big, small = Pipe(16), Pipe(8)
    bench.fill_gallery(big, np.random.default_rng(0))
    bench.fill_gallery(small, np.random.default_rng(0))
    assert big.gallery.count == 8 and small.gallery.count == 4
    ref = torch.randn(8, 512, generator=torch.Generator().manual_seed(5))
    ref = (ref / ref.norm(dim=1, keepdim=True)).to(torch.bfloat16)
    assert torch.equal(big.gallery.embeddings[:8], ref)
    host = np.random.default_rng(0).normal(size=(4, 512)).astype(np.float32)
    host = torch.from_numpy(host / np.linalg.norm(host, axis=1, keepdims=True))
    assert torch.allclose(small.gallery.embeddings[:4].float(), host, atol=4e-3)
