"""The port's packed demo step and headless demo (``facerec_torch/serve/app.py``)
against the JAX package's behaviour (tests/test_subsystems.py), on 96 x 96
frames, and ``build_default_pipeline``'s choice of weights."""

import logging

import numpy as np
import pytest
import torch

import facerec_torch.serve.app as app
from facerec_torch.config import CHECKPOINTS_DIR, ServeConfig
from facerec_torch.detect.mtcnn import MTCNN
from facerec_torch.detect.weights import CALIBRATED_THRESHOLDS, load_detector_params
from facerec_torch.models.arcface import ArcFaceNet, build_embedder, init_like_flax
from facerec_torch.serve.app import FaceDemo, UnknownCapture, synthetic_frame_source
from facerec_torch.serve.gallery import GalleryStore
from facerec_torch.serve.pipeline import FacePipeline
from facerec_torch.train.checkpoints import save_checkpoint
from facerec_tpu.serve.app import synthetic_frame_source as jax_synthetic_frame_source
from facerec_tpu.train.checkpoints import load_checkpoint as jax_load_checkpoint

CFG = ServeConfig(max_faces=4, gallery_capacity=128, top_k=3, embed_size=32,
                  detection_threshold=0.0, recognition_threshold=10.0)
DEMO = ServeConfig(max_faces=4, skip_frames=0)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def tiny_pipeline():
    """96 x 96 frames, the committed detector weights, a narrow ArcFace
    (width 16) at 32 px crops, f32, on the CPU."""
    det = MTCNN((96, 96), min_face_size=24, max_faces=4, k_pnet=16, k_rnet=8, device="cpu")
    det.load_jax_params(load_detector_params())
    emb = build_embedder(width=16, dtype=torch.float32, seed=1, device="cpu")
    return FacePipeline(CFG, (96, 96), det, emb, device="cpu")


def test_synthetic_frame_source_matches_jax():
    for hw, seed in (((96, 96), 0), ((120, 160), 3)):
        ours, ref = synthetic_frame_source(hw, seed), jax_synthetic_frame_source(hw, seed)
        for _ in range(3):
            a, b = ours(), ref()
            assert a.dtype == b.dtype == np.uint8 and a.shape == (*hw, 3)
            np.testing.assert_array_equal(a, b)


def test_packed_demo_path_matches_identify(tiny_pipeline):
    """process_demo + faces_from_packed against identify on every host
    field; the per-slot embedding against the full result's
    (tests/test_subsystems.py's bars)."""
    src = synthetic_frame_source((96, 96))
    frames = np.stack([src(), src()])
    tiny_pipeline.gallery.add_many(["a", "b", "c"],
                                   np.random.default_rng(3).normal(size=(3, 512)))
    ref = tiny_pipeline.identify(frames)
    packed, emb = tiny_pipeline.process_demo(frames)
    assert packed.shape == (2, 4, 19) and packed.dtype == np.float32
    assert emb.shape == (2, 4, 512)
    got = tiny_pipeline.faces_from_packed(packed)
    assert [len(g) for g in got] == [len(r) for r in ref] and sum(map(len, got)) >= 2
    for g_faces, r_faces in zip(got, ref):
        for g, r in zip(g_faces, r_faces):
            assert g["name"] == r["name"] and g["name"] in ("a", "b", "c")
            assert g["box"] == pytest.approx(r["box"], abs=1e-4)
            assert g["prob"] == pytest.approx(r["prob"], rel=1e-5)
            assert g["distance"] == pytest.approx(r["distance"], rel=1e-4)
            assert np.asarray(g["landmarks"]) == pytest.approx(np.asarray(r["landmarks"]),
                                                               abs=1e-3)
    slot = got[0][0]["slot"]
    np.testing.assert_allclose(emb[0, slot].numpy(), ref[0][0]["embedding"], rtol=1e-5)


def test_demo_headless(tiny_pipeline):
    demo = FaceDemo(tiny_pipeline, DEMO, frame_source=synthetic_frame_source((96, 96)))
    frame = demo.frame_source()
    assert frame.shape == (96, 96, 3)
    faces = demo.process_frame(frame)
    assert isinstance(faces, list) and faces
    assert all("face_id" in f and "slot" in f for f in faces)


def test_demo_double_buffered_matches_serial(tiny_pipeline):
    """submit_frame runs one frame behind (None first, then the previous
    frame's pair; flush drains the last) with the faces of process_frame."""
    src = synthetic_frame_source((96, 96))
    frames = [src() for _ in range(3)]
    serial = FaceDemo(tiny_pipeline, DEMO, frame_source=lambda: None)
    want = [serial.process_frame(f) for f in frames]

    demo = FaceDemo(tiny_pipeline, DEMO, frame_source=lambda: None)
    got = []
    assert demo.submit_frame(frames[0]) is None
    for i, f in enumerate(frames[1:], start=1):
        frame_done, faces = demo.submit_frame(f)
        assert frame_done is frames[i - 1]
        got.append(faces)
    frame_done, faces = demo.flush()
    assert frame_done is frames[-1]
    got.append(faces)
    assert demo.flush() is None
    assert [len(g) for g in got] == [len(w) for w in want]
    for g_faces, w_faces in zip(got, want):
        for g, w in zip(g_faces, w_faces):
            assert g["name"] == w["name"] and g["face_id"] == w["face_id"]
            assert g["box"] == pytest.approx(w["box"], abs=1e-4)


def test_unknown_capture_flow(tiny_pipeline, monkeypatch):
    """An unknown face arms ONE pending capture that persists; naming it
    enrolls it; the cooldown holds off re-arming (fake clock)."""
    demo = FaceDemo(tiny_pipeline, DEMO, frame_source=synthetic_frame_source((96, 96)))
    emb0 = np.random.default_rng(0).normal(size=512)
    demo.embedding_for = lambda slot: emb0
    monkeypatch.setattr(tiny_pipeline.gallery, "save", lambda *a, **k: None)
    now = [0.0]
    cap = UnknownCapture(demo, cooldown_s=5.0, clock=lambda: now[0])
    frame = demo.frame_source()
    unk = {"slot": 1, "box": [10.0, 10.0, 40.0, 40.0], "name": "Unknown"}
    known = {"slot": 0, "box": [0.0, 0.0, 5.0, 5.0], "name": "bob"}

    assert not cap.offer(frame, [known])
    assert cap.offer(frame, [known, unk])
    first = cap.pending
    assert first["crop"].shape == (30, 30, 3)
    np.testing.assert_array_equal(first["embedding"], emb0)
    assert not cap.offer(frame, [unk]) and cap.pending is first
    assert not cap.name("")
    assert cap.name("alice") and cap.pending is None
    assert "alice" in tiny_pipeline.gallery.names
    now[0] = 2.0
    assert not cap.offer(frame, [unk])
    now[0] = 6.0
    assert cap.offer(frame, [unk])
    cap.dismiss()
    assert cap.pending is None
    # wired into process_frame, with the real per-slot embedding
    tiny_pipeline.gallery.clear()
    now[0] = 20.0
    demo.capture = cap
    del demo.embedding_for
    faces = demo.process_frame(frame)
    assert any(f["name"] == "Unknown" for f in faces)  # an empty gallery knows nobody
    assert cap.pending is not None and cap.pending["embedding"].shape == (512,)
    np.testing.assert_allclose(np.linalg.norm(cap.pending["embedding"]), 1.0, atol=1e-4)


def test_demo_fps_measurement(tiny_pipeline):
    demo = FaceDemo(tiny_pipeline, DEMO, frame_source=synthetic_frame_source((96, 96)))
    demo.prewarm()
    assert demo.measure_fps(n_frames=3, warmup=1) > 0
    assert demo.measure_fps(n_frames=3, warmup=0, pipelined=False) > 0


def test_demo_loop_thread(tiny_pipeline):
    """The capture thread skips every other frame, queues results and stops."""
    demo = FaceDemo(tiny_pipeline, ServeConfig(max_faces=4, skip_frames=1),
                    frame_source=synthetic_frame_source((96, 96)))
    demo.start(prewarm=False)
    try:
        frame, faces = demo.result_q.get(timeout=60)
    finally:
        demo.stop()
    assert not demo._thread.is_alive()
    assert frame.shape == (96, 96, 3) and isinstance(faces, list)


@pytest.fixture
def no_references(tmp_path, monkeypatch):
    monkeypatch.setattr(app, "FACE_REFERENCES_DIR", tmp_path / "refs")
    monkeypatch.delenv("FACEREC_FACENET_WEIGHTS", raising=False)
    return tmp_path / "refs"


def test_build_default_pipeline_orbax_checkpoint(no_references, tmp_path, monkeypatch, caplog):
    """The committed arcface_synth is an orbax tree, which the port reads
    itself: no warning, the head sized from its arc_weight (16 class
    centres), and the weights the JAX package restores, cast to bf16. The
    checkpoints directory holds the committed files alone, so a port
    checkpoint that tools/export_embedder.py wrote beside them is not seen."""
    committed = CHECKPOINTS_DIR / "arcface_synth"
    (tmp_path / "ck" / "arcface_synth").mkdir(parents=True)
    for name in ("best", "model_info.json"):
        (tmp_path / "ck" / "arcface_synth" / name).symlink_to(committed / name)
    monkeypatch.setattr(app, "CHECKPOINTS_DIR", tmp_path / "ck")
    with caplog.at_level(logging.WARNING, logger="facerec_torch"):
        pipe = app.build_default_pipeline((96, 96), ServeConfig(max_faces=2), device="cpu")
    assert not any("random-init" in r.getMessage() for r in caplog.records)
    assert pipe.embedder.arc_weight.shape == (16, 512)
    assert pipe.embedder.embedding.weight.dtype == torch.bfloat16 and not pipe.embedder.training
    params = jax_load_checkpoint(committed, "best")["params"]
    bf16 = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)  # noqa: E731
    assert torch.equal(pipe.embedder.arc_weight, bf16(params["arc_weight"]))
    assert torch.equal(pipe.embedder.embedding.weight, bf16(params["embedding"]["kernel"]).T)
    assert pipe.detector.thresholds == CALIBRATED_THRESHOLDS and pipe.gallery.count == 0


def test_build_default_pipeline_port_checkpoint(no_references, tmp_path, monkeypatch, caplog):
    """A checkpoint of the port's trainer: the head is sized from its
    arc_weight rows, and a saved gallery loads."""
    net = ArcFaceNet(512, 16, num_classes=7)
    init_like_flax(net, torch.Generator().manual_seed(0))
    save_checkpoint(tmp_path / "ck" / "mine", "final", net.state_dict())
    monkeypatch.setattr(app, "CHECKPOINTS_DIR", tmp_path / "ck")
    refs = GalleryStore(capacity=8, device="cpu")
    refs.add_many(["x", "y"], np.random.default_rng(1).normal(size=(2, 512)))
    refs.save(no_references)
    with caplog.at_level(logging.WARNING, logger="facerec_torch"):
        pipe = app.build_default_pipeline((96, 96), ServeConfig(max_faces=2),
                                          embedder_checkpoint="mine", device="cpu")
    assert not any("random-init" in r.getMessage() for r in caplog.records)
    assert pipe.embedder.arc_weight.shape == (7, 512)
    torch.testing.assert_close(pipe.embedder.arc_weight.float(),
                               net.arc_weight.to(torch.bfloat16).float())
    assert pipe.gallery.names == ["x", "y"]


def test_build_default_pipeline_refuses_facenet(no_references, tmp_path, monkeypatch):
    """FACEREC_FACENET_WEIGHTS naming a file that holds no torch-pickled
    state dict is refused, not replaced by the ArcFace fallback: an empty
    file, and a ``.npz``, which the JAX demo's docstring offers but its
    ``torch.load`` cannot read either (ROADMAP section 3). A real one is
    served: tests/test_torch_facenet.py."""
    weights = tmp_path / "facenet.pt"
    monkeypatch.setenv("FACEREC_FACENET_WEIGHTS", str(weights))
    weights.write_bytes(b"")
    with pytest.raises(EOFError):
        app.build_default_pipeline((96, 96), device="cpu")
    np.savez(tmp_path / "facenet.npz", w=np.zeros(3, np.float32))
    monkeypatch.setenv("FACEREC_FACENET_WEIGHTS", str(tmp_path / "facenet.npz"))
    with pytest.raises(RuntimeError):
        app.build_default_pipeline((96, 96), device="cpu")
