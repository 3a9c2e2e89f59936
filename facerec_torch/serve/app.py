"""The live face-recognition demo (counterpart of ``facerec_tpu/serve/app.py``;
the Streamlit UI on top of it is ``app_ui.py``, which ``run_demo`` launches
where ``streamlit`` is installed).

A capture thread feeds frames to the packed serve step (``FacePipeline.
dispatch_demo``, a replay of its CUDA graph on the card), IOU tracking gives faces stable ids, a reference gallery
with add and remove persists to ``face_references/``, recognitions are
logged, and an unknown face arms a capture prompt. ``FaceDemo`` runs without
a webcam on ``synthetic_frame_source``.

Operating points (reference app.py:17-29): detection threshold 0.9,
recognition threshold 1.0 (euclidean), one frame skipped in two, IOU
tracking 0.3.

    python -m facerec_torch.serve.app --fps 40   # headless demo fps, one JSON line
"""

from __future__ import annotations

import os
import queue
import threading
import time
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from facerec_torch import resolve_device
from facerec_torch.config import CHECKPOINTS_DIR, FACE_REFERENCES_DIR, ServeConfig, logger
from facerec_torch.serve.gallery import GalleryStore
from facerec_torch.serve.pipeline import FacePipeline, FaceTracker


def _embedder_checkpoint(model_dir: Path) -> Path | None:
    """``best``, else ``final``, of ``model_dir`` (the JAX demo's order), as
    the port's trainer or the JAX trainer wrote it; None when it has
    neither."""
    for name in ("best", "final"):
        if (model_dir / name).is_dir():
            return model_dir / name
    return None


def build_default_pipeline(frame_hw: tuple[int, int] = (480, 640),
                           config: ServeConfig = ServeConfig(),
                           embedder_checkpoint: str | None = "arcface_synth",
                           input_range: str = "255",
                           device: str | torch.device | None = None) -> FacePipeline:
    """The demo's pipeline on ``device`` (default: the CUDA card): the MTCNN
    with the committed detector weights at their source's thresholds (a
    random detector without weights), and an embedder in bf16. The embedder
    is, in this order: an InceptionResnetV1 from the facenet-pytorch state
    dict (a torch-pickled ``.pt``) that ``FACEREC_FACENET_WEIGHTS`` names;
    an ArcFace from the checkpoint ``CHECKPOINTS_DIR/<embedder_checkpoint>``
    (``best``, else ``final``; a port checkpoint or the JAX trainer's orbax
    tree, such as the committed ``arcface_synth``), its class-centre rows
    sized from the checkpoint; else, with a warning, a random ArcFace, as the
    JAX demo does without a checkpoint.
    The gallery saved in ``face_references/`` is loaded.

    ``input_range``: the pixel scale of the frames ("255" for camera
    frames, "1" or "auto" for normalised floats)."""
    from facerec_torch.detect.mtcnn import MTCNN
    from facerec_torch.detect.weights import (
        CALIBRATED_THRESHOLDS,
        load_detector_params_with_source,
        thresholds_for_source,
    )
    from facerec_torch.models.arcface import build_embedder

    dev = resolve_device(device)
    try:
        det_params, source = load_detector_params_with_source()
        thresholds = thresholds_for_source(source)
    except FileNotFoundError:
        det_params, thresholds = None, CALIBRATED_THRESHOLDS
    detector = MTCNN(frame_hw, min_face_size=40, max_faces=config.max_faces,
                     thresholds=thresholds, dtype=torch.bfloat16, input_range=input_range,
                     device=dev)
    if det_params is None:
        logger.warning("no MTCNN weights found: using a random-init detector")
    else:
        detector.load_jax_params(det_params)

    facenet_path = os.environ.get("FACEREC_FACENET_WEIGHTS")
    if facenet_path and Path(facenet_path).exists():
        from facerec_torch.models.facenet import build_facenet_embedder

        embedder = build_facenet_embedder(facenet_path, dtype=torch.bfloat16, device=dev)
    else:
        ck = (_embedder_checkpoint(CHECKPOINTS_DIR / embedder_checkpoint)
              if embedder_checkpoint else None)
        if ck is None:
            logger.warning("no embedder checkpoint %r under %s: using a random-init ArcFace "
                           "embedder", embedder_checkpoint, CHECKPOINTS_DIR)
        embedder = build_embedder(checkpoint=ck, dtype=torch.bfloat16, device=dev)

    pipe = FacePipeline(config, frame_hw, detector, embedder, embed_dim=512, device=dev)
    loaded = GalleryStore.load(FACE_REFERENCES_DIR, capacity=config.gallery_capacity,
                               dtype=pipe.gallery.dtype, device=dev)
    if loaded.count:
        pipe.gallery = loaded
        logger.info("loaded %d reference faces", loaded.count)
    return pipe


class FaceDemo:
    """Headless demo engine: capture thread -> pipeline -> results queue."""

    def __init__(self, pipeline: FacePipeline, config: ServeConfig = ServeConfig(),
                 frame_source: Callable[[], np.ndarray | None] | None = None):
        self.pipeline = pipeline
        self.config = config
        self.frame_source = frame_source or self._webcam_source()
        self.tracker = FaceTracker(config.iou_tracking_threshold)
        self.result_q: "queue.Queue[tuple[np.ndarray, list[dict]]]" = queue.Queue(maxsize=4)
        self.history: list[dict] = []
        self.capture = UnknownCapture(self)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # the last processed frame's device embeddings [1, F, D]: one row is
        # copied to the host only when a face is enrolled
        self._last_embeddings: torch.Tensor | None = None
        # double buffering: the frame dispatched but not yet read back, with
        # an event recorded right after its dispatch (on a card)
        self._inflight: tuple[np.ndarray, tuple, torch.cuda.Event | None] | None = None
        self._readback: torch.cuda.Stream | None = None

    def _webcam_source(self):
        import cv2

        cap = cv2.VideoCapture(0)
        cap.set(cv2.CAP_PROP_FRAME_WIDTH, 1280)
        cap.set(cv2.CAP_PROP_FRAME_HEIGHT, 720)

        def read():
            ok, frame = cap.read()
            if not ok:
                return None
            frame = cv2.resize(frame, (self.pipeline.frame_hw[1], self.pipeline.frame_hw[0]))
            return cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)

        return read

    def start(self, prewarm: bool = True):
        if prewarm:
            self.prewarm()
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def prewarm(self) -> None:
        """One batch-1 step on a blank frame before the loop starts: on a
        card this captures the packed step's CUDA graph (after its eager
        warm-up: cuDNN's algorithm choice, the allocator's first blocks)."""
        blank = np.zeros((1, *self.pipeline.frame_hw, 3), np.uint8)
        self.pipeline.process_demo(blank)

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)

    def _loop(self):
        frame_i = 0
        while not self._stop.is_set():
            frame = self.frame_source()
            if frame is None:
                time.sleep(0.01)
                continue
            frame_i += 1
            if self.config.skip_frames and frame_i % (self.config.skip_frames + 1):
                continue  # frame skipping (reference app.py:170-179)
            try:
                done = self.submit_frame(frame)
                if done is not None and not self.result_q.full():
                    self.result_q.put(done)
            except Exception:  # the loop outlives one bad frame (reference app.py:168-256)
                logger.exception("demo frame failed")

    def process_frame(self, frame: np.ndarray) -> list[dict]:
        """Synchronous single-frame path (enrollment snapshots, tests)."""
        return self._finalize(frame, self.pipeline.dispatch_demo(frame[None]))[1]

    def submit_frame(self, frame: np.ndarray) -> tuple[np.ndarray, list[dict]] | None:
        """Double-buffered step: dispatch THIS frame, then read back and
        return the PREVIOUS frame's (frame, faces); None on the first call.
        Results run one frame behind the camera. The dispatch returns before
        the card has finished the frame, and each dispatch's tensors are its
        own (copied out of the graph's static outputs); the previous frame
        is read back on a side stream that waits only for that frame's step,
        so the read-back and the host's work on it overlap this frame's
        step."""
        dispatched = self.pipeline.dispatch_demo(frame[None])
        prev, self._inflight = self._inflight, (frame, dispatched, self._mark())
        if prev is None:
            return None
        return self._finalize(*prev)

    def _mark(self) -> torch.cuda.Event | None:
        """An event after the work dispatched so far, on a card."""
        if self.pipeline.device.type != "cuda":
            return None
        event = torch.cuda.Event()
        event.record()
        return event

    def _read_packed(self, packed: torch.Tensor, ready: torch.cuda.Event | None) -> np.ndarray:
        """The packed result on the host. After ``ready`` (the frame's own
        dispatch) the copy runs on a side stream, so it waits for that
        frame's step and not for a later frame's, as reading a JAX buffer
        waits for that buffer alone."""
        if ready is None:
            return packed.cpu().numpy()
        if self._readback is None:
            self._readback = torch.cuda.Stream(packed.device)
        self._readback.wait_event(ready)
        with torch.cuda.stream(self._readback):
            return packed.cpu().numpy()  # synchronises the side stream alone

    def flush(self) -> tuple[np.ndarray, list[dict]] | None:
        """Read back the trailing in-flight frame (loop shutdown)."""
        prev, self._inflight = self._inflight, None
        return self._finalize(*prev) if prev is not None else None

    def _finalize(self, frame: np.ndarray, dispatched: tuple,
                  ready: torch.cuda.Event | None = None) -> tuple[np.ndarray, list[dict]]:
        packed_dev, emb = dispatched
        self._last_embeddings = emb
        faces = self.pipeline.faces_from_packed(self._read_packed(packed_dev, ready))[0]
        ids = self.tracker.update([f["box"] for f in faces])
        for f, fid in zip(faces, ids):
            f["face_id"] = fid
            if f["name"] != "Unknown":
                self.history.append({"name": f["name"], "distance": f["distance"],
                                     "time": time.strftime("%H:%M:%S")})
        self.capture.offer(frame, faces)
        return frame, faces

    def embedding_for(self, slot: int) -> np.ndarray:
        """ONE face embedding [D] of the last frame, copied to the host."""
        if self._last_embeddings is None:
            raise RuntimeError("no frame processed yet")
        return self._last_embeddings[0, slot].float().cpu().numpy()

    def measure_fps(self, n_frames: int = 40, warmup: int = 3,
                    pipelined: bool = True) -> float:
        """Headless demo-loop fps: every frame is distinct (the synthetic
        source moves the face) and is read back to the host, so the wall
        clock over the loop is end to end. ``pipelined`` takes the
        double-buffered path; False dispatches and reads back each frame in
        turn."""
        for _ in range(warmup):
            self.process_frame(self.frame_source())
        if not pipelined:
            t0 = time.perf_counter()
            for _ in range(n_frames):
                self.process_frame(self.frame_source())
            return n_frames / (time.perf_counter() - t0)
        t0 = time.perf_counter()
        done = 0
        for _ in range(n_frames):
            done += self.submit_frame(self.frame_source()) is not None
        done += self.flush() is not None
        return done / (time.perf_counter() - t0)

    # gallery management (reference app.py:404-563)
    def add_reference(self, name: str, embedding: np.ndarray, face_img: np.ndarray | None = None):
        self.pipeline.gallery.add(name, embedding)
        self.pipeline.gallery.save(images={name: face_img} if face_img is not None else None)

    def remove_reference(self, name: str) -> bool:
        ok = self.pipeline.gallery.remove(name)
        if ok:
            self.pipeline.gallery.save()
        return ok


class UnknownCapture:
    """Auto-capture of unknown faces (reference app.py:683-693).

    The first unknown face seen outside a cooldown arms a PENDING capture:
    its crop and embedding are taken at that frame, so the prompt survives
    the face leaving. It stays until ``name()`` enrolls it or ``dismiss()``
    drops it; either starts the cooldown."""

    def __init__(self, demo: FaceDemo, cooldown_s: float = 5.0,
                 clock: Callable[[], float] = time.time):
        self.demo = demo
        self.cooldown_s = cooldown_s
        self._clock = clock
        self.pending: dict | None = None
        self._cooldown_until = 0.0

    def offer(self, frame: np.ndarray, faces: list[dict]) -> bool:
        """Called once per processed frame; arms a capture if an unknown face
        is present, nothing is pending and the cooldown has passed."""
        if self.pending is not None or self._clock() < self._cooldown_until:
            return False
        unknowns = [f for f in faces if f["name"] == "Unknown"]
        if not unknowns:
            return False
        f = unknowns[0]
        x1, y1, x2, y2 = [max(int(v), 0) for v in f["box"]]
        crop = np.ascontiguousarray(frame[y1:y2, x1:x2])
        # the embedding now: the device buffer is the last frame's
        emb = (self.demo.embedding_for(f["slot"]) if "slot" in f
               else np.asarray(f["embedding"]))
        self.pending = {"crop": crop, "embedding": emb, "box": f["box"], "ts": self._clock()}
        return True

    def name(self, name: str) -> bool:
        if self.pending is None or not name:
            return False
        self.demo.add_reference(name, self.pending["embedding"], self.pending["crop"])
        self.pending = None
        self._cooldown_until = self._clock() + self.cooldown_s
        return True

    def dismiss(self) -> None:
        self.pending = None
        self._cooldown_until = self._clock() + self.cooldown_s


def synthetic_frame_source(frame_hw: tuple[int, int] = (480, 640), seed: int = 0):
    """A deterministic synthetic webcam: one rendered face moving over a
    flat background."""
    from facerec_torch.data.synthetic import _identity_params, render_face

    rng = np.random.default_rng(seed)
    ident = _identity_params(rng)
    t = [0]
    size = max(min(frame_hw) // 3, 16)

    def read():
        t[0] += 1
        face = render_face(ident, size, np.random.default_rng(t[0]))
        frame = np.full((*frame_hw, 3), 40, np.uint8)
        max_y = frame_hw[0] - size
        max_x = frame_hw[1] - size
        y = int(max_y / 2 + (max_y / 3) * np.sin(t[0] / 10))
        x = int(max_x / 2 + (max_x / 3) * np.cos(t[0] / 15))
        frame[y : y + size, x : x + size] = face
        return frame

    return read


def run_demo(device: str | torch.device | None = None) -> int:
    """The Streamlit UI (``app_ui.py``, in a ``streamlit run`` process) where
    ``streamlit`` is installed; else 20 headless synthetic frames through
    the demo, one line of names each."""
    try:
        import streamlit  # noqa: F401
    except ImportError:
        print("streamlit is not installed; running 20 headless synthetic frames instead")
        pipe = build_default_pipeline(device=device)
        demo = FaceDemo(pipe, frame_source=synthetic_frame_source(pipe.frame_hw))
        for _ in range(20):
            faces = demo.process_frame(demo.frame_source())
            print(f"frame: {len(faces)} faces", [f["name"] for f in faces])
        return 0
    import subprocess
    import sys

    cmd = [sys.executable, "-m", "streamlit", "run", str(Path(__file__).with_name("app_ui.py"))]
    if device is not None:
        cmd += ["--", "--device", str(device)]
    return subprocess.call(cmd)


def measure_demo_fps(n_frames: int = 40, device: str | torch.device | None = None) -> dict:
    """Headless demo-loop fps on the synthetic camera (the committed
    detector weights, the batch-1 packed step): serial, then pipelined."""
    pipe = build_default_pipeline(device=device)
    demo = FaceDemo(pipe, frame_source=synthetic_frame_source(pipe.frame_hw))
    t0 = time.perf_counter()
    demo.prewarm()
    prewarm_s = time.perf_counter() - t0
    fps_serial = demo.measure_fps(n_frames, pipelined=False)
    fps = demo.measure_fps(n_frames, pipelined=True)
    return {"demo_fps": fps, "frame_ms": 1000.0 / fps, "demo_fps_serial": fps_serial,
            "prewarm_s": prewarm_s, "n_frames": n_frames}


if __name__ == "__main__":
    import argparse
    import json

    ap = argparse.ArgumentParser()
    ap.add_argument("--fps", type=int, nargs="?", const=40, default=None,
                    help="measure headless demo fps over N synthetic frames")
    a = ap.parse_args()
    if a.fps:
        print(json.dumps(measure_demo_fps(a.fps)))
        raise SystemExit(0)
    raise SystemExit(run_demo())
