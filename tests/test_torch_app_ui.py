"""The port's Streamlit UI (``facerec_torch/serve/app_ui.py``) on the CPU,
through a recording stub of ``streamlit`` (which is not installed): one
script run of ``main()`` per interaction on a 96 x 96 pipeline (the tabs,
rename and delete, the unknown-face form's add and dismiss, the display
loop), ``_draw``'s box pixels against the JAX package's ``_draw`` (which
draws with OpenCV, imported here under the same stub), and ``run_demo``
launching the UI when ``streamlit`` imports and running headless when it
does not."""

import importlib
import subprocess
import sys
import types
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import pytest
import torch

import facerec_torch.serve.app as app
from facerec_torch.config import ServeConfig
from facerec_torch.detect.mtcnn import MTCNN
from facerec_torch.detect.weights import load_detector_params
from facerec_torch.models.arcface import build_embedder
from facerec_torch.serve.app import FaceDemo, synthetic_frame_source
from facerec_torch.serve.pipeline import FacePipeline

CFG = ServeConfig(max_faces=4, gallery_capacity=16, top_k=3, embed_size=32,
                  detection_threshold=0.0, recognition_threshold=10.0)


class Rerun(Exception):
    """``st.rerun()`` ends the script run, as Streamlit's does."""


class StubStreamlit(types.ModuleType):
    """Records every call as ``(name, args, kwargs)``; a button returns True
    when its key (or label) is in ``pressed``, a text input the value in
    ``typed`` under its key (or label)."""

    def __init__(self, pressed=(), typed=None):
        super().__init__("streamlit")
        self.calls: list[tuple] = []
        self.pressed = set(pressed)
        self.typed = dict(typed or {})
        self.session_state: dict = {}
        self.sidebar = self
        self.cache_resource = lambda f: f

    def _rec(self, name, *a, **k):
        self.calls.append((name, a, k))

    def names(self, name):
        return [c for c in self.calls if c[0] == name]

    @contextmanager
    def _ctx(self, label):
        self._rec("enter", label)
        yield self

    def set_page_config(self, **k):
        self._rec("set_page_config", **k)

    def title(self, text):
        self._rec("title", text)

    def checkbox(self, label, value=False):
        self._rec("checkbox", label)
        return label in self.pressed

    def tabs(self, labels):
        self._rec("tabs", labels)
        return [self._ctx(f"tab:{x}") for x in labels]

    def container(self):
        return self._ctx("container")

    def columns(self, spec):
        n = spec if isinstance(spec, int) else len(spec)
        self._rec("columns", spec)
        return [self] * n

    def button(self, label, key=None):
        self._rec("button", label, key=key)
        return (key or label) in self.pressed

    def text_input(self, label, key=None, label_visibility=None):
        self._rec("text_input", label, key=key)
        value = self.typed.get(key or label, "")
        if key is not None:
            self.session_state[key] = value
        return value

    def metric(self, label, value):
        self._rec("metric", label, value)

    def write(self, text):
        self._rec("write", text)

    def image(self, img, **k):
        self._rec("image", np.asarray(img), **k)

    def success(self, text):
        self._rec("success", text)

    def info(self, text):
        self._rec("info", text)

    def empty(self):
        self._rec("empty")
        return self

    def rerun(self):
        self._rec("rerun")
        raise Rerun


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _ui(monkeypatch, stub):
    monkeypatch.setitem(sys.modules, "streamlit", stub)
    import facerec_torch.serve.app_ui as ui

    return importlib.reload(ui)


@pytest.fixture
def demo(tmp_path, monkeypatch):
    """A FaceDemo on 96 x 96 synthetic frames (the committed detector, a
    narrow ArcFace, f32, on the CPU) whose gallery saves under tmp_path."""
    monkeypatch.setattr("facerec_torch.serve.gallery.FACE_REFERENCES_DIR", tmp_path / "refs")
    det = MTCNN((96, 96), min_face_size=24, max_faces=4, k_pnet=16, k_rnet=8, device="cpu")
    det.load_jax_params(load_detector_params())
    emb = build_embedder(width=16, dtype=torch.float32, seed=1, device="cpu")
    pipe = FacePipeline(CFG, (96, 96), det, emb, device="cpu")
    rng = np.random.default_rng(0)
    pipe.gallery.add_many(["alice", "bob"], rng.normal(size=(2, 512)))
    return FaceDemo(pipe, CFG, frame_source=synthetic_frame_source((96, 96)))


def _run(monkeypatch, demo, **stub_kw) -> StubStreamlit:
    stub = StubStreamlit(**stub_kw)
    ui = _ui(monkeypatch, stub)
    monkeypatch.setattr(ui, "_load_demo", lambda use_synthetic: demo)
    try:
        ui.main()
    except Rerun:
        pass
    return stub


def test_one_script_run_draws_the_tabs(monkeypatch, demo):
    stub = _run(monkeypatch, demo)
    assert stub.names("tabs") == [("tabs", (["Controls", "Faces", "History"],), {})]
    assert ("metric", ("gallery size", 2), {}) in stub.calls
    assert [c[1][0] for c in stub.names("write")] == ["alice", "bob"]
    keys = [c[2]["key"] for c in stub.names("button") if c[2]["key"]]
    assert keys == ["del_alice", "del_bob"]  # "ok" shows only once a new name is typed
    assert [c[2]["key"] for c in stub.names("text_input")] == ["rn_alice", "rn_bob"]
    assert not stub.names("rerun") and demo._thread is None


def test_rename_and_delete(monkeypatch, demo, tmp_path):
    _run(monkeypatch, demo, typed={"rn_alice": "carol"}, pressed={"rok_alice", "del_bob"})
    assert demo.pipeline.gallery.names == ["carol"]
    import pickle

    saved = pickle.loads((tmp_path / "refs" / "face_references.pkl").read_bytes())
    assert list(saved) == ["carol"]


def test_clear_all_references(monkeypatch, demo):
    _run(monkeypatch, demo, pressed={"Clear all references"})
    assert demo.pipeline.gallery.count == 0


def _arm_capture(demo):
    frame = demo.frame_source()
    demo.pipeline.gallery.clear()  # every face is then unknown
    faces = demo.process_frame(frame)
    assert faces and demo.capture.pending is not None
    return faces


def test_capture_form_adds_the_unknown_face(monkeypatch, demo):
    _arm_capture(demo)
    stub = _run(monkeypatch, demo, typed={"unknown_name": "dave"}, pressed={"unknown_add"})
    assert [c[2]["key"] for c in stub.names("text_input")][-1] == "unknown_name"
    assert ("success", ("added dave",), {}) in stub.calls and stub.names("rerun")
    assert "unknown_name" not in stub.session_state  # an empty field for the next stranger
    assert demo.pipeline.gallery.names == ["dave"] and demo.capture.pending is None
    assert stub.names("image")[0][2]["caption"] == "Unknown face"


def test_capture_form_dismiss(monkeypatch, demo):
    _arm_capture(demo)
    stub = _run(monkeypatch, demo, typed={"unknown_name": "eve"}, pressed={"unknown_dismiss"})
    assert demo.capture.pending is None and demo.pipeline.gallery.count == 0
    assert stub.names("rerun") and "unknown_name" not in stub.session_state
    # the same keys on every run: a second run without a pending face shows no form
    stub = _run(monkeypatch, demo)
    assert not [c for c in stub.names("text_input") if c[2]["key"] == "unknown_name"]


def test_display_loop_shows_each_result(monkeypatch, demo):
    """While the processing thread lives, each queued result is drawn."""
    frame = demo.frame_source()
    faces = demo.process_frame(frame)
    demo.result_q.put((frame, faces))
    alive = iter([True, True, False])
    demo._thread = types.SimpleNamespace(is_alive=lambda: next(alive), join=lambda timeout: None)
    stub = _run(monkeypatch, demo)
    shown = [c for c in stub.names("image") if c[2].get("channels") == "RGB"]
    assert len(shown) == 1 and shown[0][1][0].shape == (96, 96, 3)


FACES = [{"box": [40, 60, 120, 150], "name": "alice", "distance": 0.42},
         {"box": [170, 100, 262, 181], "name": "Unknown", "distance": 1.7},
         {"box": [-5, 190, 30, 230], "name": "bob", "distance": 0.05}]


def _label_zone(mask, faces, w):
    for f in faces:
        x1, y1 = int(f["box"][0]), int(f["box"][1])
        base = max(y1 - 8, 12)
        mask[max(base - 22, 0):base + 8, max(x1 - 2, 0):w] = True


def test_draw_boxes_match_jax(monkeypatch):
    """The box outlines pixel for pixel as the JAX UI's ``cv2.rectangle``
    draws them; the labels (cv2's Hershey font there, Pillow's here) stay
    in their zone above each box."""
    stub = StubStreamlit()
    ui = _ui(monkeypatch, stub)
    import facerec_tpu.serve.app_ui as jax_ui

    jax_ui = importlib.reload(jax_ui)
    frame = np.random.default_rng(0).integers(0, 255, (240, 320, 3), dtype=np.uint8)
    got, ref = ui._draw(frame, FACES), jax_ui._draw(frame, FACES)
    assert got.shape == ref.shape and got.dtype == ref.dtype == np.uint8
    box = np.zeros(frame.shape[:2], bool)
    for f in FACES:
        m = np.zeros(frame.shape, np.uint8)
        ui.draw_box(m, f["box"], (1, 1, 1))
        box |= m[..., 0].astype(bool)
    labels = np.zeros(frame.shape[:2], bool)
    _label_zone(labels, FACES, frame.shape[1])
    assert np.array_equal(got[box & ~labels], ref[box & ~labels])
    assert np.array_equal(got[~box & ~labels], frame[~box & ~labels])
    assert np.array_equal(ref[~box & ~labels], frame[~box & ~labels])
    assert not np.array_equal(got[labels], frame[labels])  # a label was drawn
    assert np.array_equal(ui._draw(frame, []), frame)


@pytest.mark.parametrize("box", [(4, 5, 15, 12), (3, 3, 4, 4), (-3, 2, 30, 8), (8, 7, 2, 3),
                                 (0, 0, 0, 0), (11, 11, 40, 40)])
def test_draw_box_matches_cv2_rectangle(monkeypatch, box):
    import cv2

    ui = _ui(monkeypatch, StubStreamlit())
    ref = np.zeros((12, 12, 3), np.uint8)
    cv2.rectangle(ref, box[:2], box[2:], (0, 255, 0), 2)
    got = np.zeros((12, 12, 3), np.uint8)
    ui.draw_box(got, box, (0, 255, 0))
    assert np.array_equal(got, ref)


def test_device_from_the_script_arguments(monkeypatch):
    ui = _ui(monkeypatch, StubStreamlit())
    monkeypatch.setattr(sys, "argv", ["app_ui.py", "--device", "cpu"])
    assert ui._device() == "cpu"
    monkeypatch.setattr(sys, "argv", ["app_ui.py"])
    assert ui._device() is None


def test_run_demo_launches_streamlit(monkeypatch):
    monkeypatch.setitem(sys.modules, "streamlit", StubStreamlit())
    cmds = []
    monkeypatch.setattr(subprocess, "call", lambda cmd: cmds.append(cmd) or 0)
    assert app.run_demo(device="cpu") == 0
    ui = str(Path(app.__file__).with_name("app_ui.py"))
    assert cmds == [[sys.executable, "-m", "streamlit", "run", ui, "--", "--device", "cpu"]]
    assert app.run_demo() == 0 and cmds[-1] == cmds[0][:5]


def test_run_demo_headless_without_streamlit(monkeypatch, demo, capsys):
    monkeypatch.setitem(sys.modules, "streamlit", None)  # import raises ImportError
    monkeypatch.setattr(app, "build_default_pipeline", lambda device=None: demo.pipeline)
    monkeypatch.setattr(subprocess, "call", lambda cmd: pytest.fail("launched streamlit"))
    assert app.run_demo(device="cpu") == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "streamlit is not installed; running 20 headless synthetic frames instead"
    assert len(out) == 21 and all(line.startswith("frame: ") for line in out[1:])
