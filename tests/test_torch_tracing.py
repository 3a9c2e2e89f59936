"""The port's tracing registry (``facerec_torch/utils/profiling.py``) on
the CPU: off means nothing recorded, profiler ranges for leaf spans, span
fields and self time, ``python.gc`` spans, and the spans and counters of
the serve pipeline, the feed and the train step."""

import gc

import numpy as np
import pytest
import torch
import torch.nn as nn
from torch.profiler import ProfilerActivity, profile

from facerec_torch.config import ServeConfig, TrainConfig
from facerec_torch.data.pipeline import prefetch_to_device
from facerec_torch.data.synthetic import face_frames
from facerec_torch.detect.mtcnn import MTCNN
from facerec_torch.detect.weights import load_detector_params
from facerec_torch.models import get_model
from facerec_torch.serve.pipeline import FacePipeline
from facerec_torch.train.state import create_train_state
from facerec_torch.train.steps import make_train_step
from facerec_torch.utils import profiling

HW = (120, 160)
CFG = dict(max_faces=2, gallery_capacity=16, top_k=3, embed_size=64, detection_threshold=0.0,
           gallery_dtype="float32")
DET = dict(min_face_size=40, max_faces=2, k_pnet=16, k_rnet=8, input_range="255")


@pytest.fixture(autouse=True)
def _fresh_registry():
    torch.set_num_threads(1)
    profiling.disable()
    profiling.reset()
    yield
    profiling.disable()
    profiling.reset()


def _names(snap, **where):
    """The names of the spans that match ``where``, less the collections a
    test's allocations may set off anywhere."""
    return [s["name"] for s in snap["spans"]
            if s["name"] != "python.gc" and all(s[k] == v for k, v in where.items())]


def test_off_records_nothing():
    assert profiling.span("x") is profiling.span("y")  # the shared null context
    with profiling.request("r"), profiling.span("a"), profiling.device_span("d", "cpu"):
        profiling.count("c", 1)
        profiling.device_count("dc", torch.tensor(3))
        gc.collect()
    assert profiling.snapshot() == {"spans": [], "counts": []}


def test_a_profiler_sees_leaf_spans_as_ranges_with_tracing_off():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.request("serve.request"):
            with profiling.span("serve.upload"):
                torch.ones(8).sum()
            with profiling.device_span("serve.step.detect", "cpu"):
                torch.ones(8).sum()
            gc.collect()
    ranges = {e.name for e in prof.events() if e.name.startswith(("serve.", "python."))}
    assert ranges == {"serve.upload", "serve.step.detect", "python.gc"}
    assert profiling.snapshot() == {"spans": [], "counts": []}


def test_device_ops_leave_out_the_ranges():
    """The profiler keeps a span's range as a user annotation, which
    ``device_ops`` does not count as device time (nothing is, on the CPU)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("serve.decode"):
            torch.ones(8).sum()
    assert [e.key for e in prof.key_averages() if e.is_user_annotation] == ["serve.decode"]
    assert profiling.device_ops(prof) == []


def test_spans_carry_their_fields_and_self_time():
    profiling.enable()
    with profiling.request("job", kind="t"):
        with profiling.span("outer"):
            with profiling.span("inner", n=1):
                pass
            with profiling.device_span("dev", "cpu", numbered=True):
                pass
            with profiling.device_span("dev", "cpu", numbered=True):
                pass
        profiling.count("things", 3)
    with profiling.span("loose"):
        pass
    snap = profiling.snapshot()
    by = {(s["name"], s["attrs"].get("index")): s for s in snap["spans"]}
    job, outer = by[("job", None)], by[("outer", None)]
    assert job["parent"] is None and job["request"] == job["id"] and job["attrs"] == {"kind": "t"}
    assert outer["parent"] == job["id"]
    assert by[("inner", None)]["parent"] == outer["id"]
    assert by[("inner", None)]["attrs"] == {"n": 1}
    assert [by[("dev", i)]["parent"] for i in (0, 1)] == [outer["id"]] * 2
    assert all(s["request"] == job["id"] for s in snap["spans"]
               if s["name"] not in ("loose", "python.gc"))
    assert by[("loose", None)]["request"] is None and by[("loose", None)]["parent"] is None
    assert all(s["clock"] == "host" and s["start"] <= s["end"] for s in snap["spans"])
    assert snap["counts"][0]["name"] == "things" and snap["counts"][0]["value"] == 3
    assert snap["counts"][0]["request"] == job["id"]
    own = profiling.self_times(snap["spans"])
    kids = [s for s in snap["spans"] if s["parent"] == outer["id"]]
    assert len(kids) >= 3
    assert own[outer["id"]] == pytest.approx(
        (outer["end"] - outer["start"]) - sum(k["end"] - k["start"] for k in kids), abs=1e-12)
    assert own[by[("inner", None)]["id"]] == pytest.approx(
        by[("inner", None)]["end"] - by[("inner", None)]["start"])


def test_self_time_counts_overlapping_children_once():
    spans = [{"id": 1, "name": "p", "start": 0.0, "end": 10.0, "parent": None, "clock": "host"},
             {"id": 2, "name": "a", "start": 1.0, "end": 4.0, "parent": 1, "clock": "host"},
             {"id": 3, "name": "b", "start": 3.0, "end": 6.0, "parent": 1, "clock": "host"},
             {"id": 4, "name": "c", "start": 2.0, "end": 3.0, "parent": 1, "clock": "cuda:0"}]
    assert profiling.self_times(spans)[1] == pytest.approx(5.0)


def test_gc_inside_an_enabled_region_is_a_span():
    profiling.enable()
    with profiling.span("work"):
        gc.collect()
    snap = profiling.snapshot()
    work = next(s for s in snap["spans"] if s["name"] == "work")
    coll = [s for s in snap["spans"] if s["name"] == "python.gc"]
    assert any(c["parent"] == work["id"] and c["attrs"]["generation"] == 2 for c in coll)


class _MeanEmbedder(nn.Module):
    """A fixed projection of each crop's mean colour rows: embeddings that
    differ by face, cheap on the CPU."""

    def __init__(self, size: int, dim: int = 512):
        super().__init__()
        self.proj = torch.randn(size * 3, dim, generator=torch.Generator().manual_seed(0))

    def embed(self, crops: torch.Tensor) -> torch.Tensor:
        return crops.float().mean(2).reshape(len(crops), -1) @ self.proj


def test_identify_is_one_request_with_its_spans_and_slots():
    det = MTCNN(HW, **DET, device="cpu").load_jax_params(load_detector_params())
    pipe = FacePipeline(ServeConfig(**CFG), HW, det, _MeanEmbedder(CFG["embed_size"]),
                        device="cpu")
    rng = np.random.default_rng(1)
    pipe.gallery.add_many([f"id{i}" for i in range(4)],
                          rng.normal(size=(4, 512)).astype(np.float32))
    frames = face_frames(2, HW, 1, np.random.default_rng(0))
    profiling.enable()
    faces = pipe.identify(frames)
    snap = profiling.snapshot()
    reqs = [s for s in snap["spans"] if s["name"] == "serve.request"]
    assert len(reqs) == 1
    rid = reqs[0]["id"]
    assert _names(snap, parent=rid) == ["serve.upload", "serve.launch", "serve.readback",
                                        "serve.decode"]
    launch = next(s for s in snap["spans"] if s["name"] == "serve.launch")
    assert _names(snap, parent=launch["id"]) == ["serve.step.detect", "serve.step.align",
                                                 "serve.step.embed", "serve.step.match"]
    assert all(s["request"] == rid for s in snap["spans"] if s["name"] != "python.gc")
    counts = {c["name"]: c for c in snap["counts"]}
    assert counts["serve.valid_slots"]["value"] == sum(len(f) for f in faces) > 0
    assert counts["serve.valid_slots"]["request"] == rid
    # five NMS calls a step, each at least one round
    rounds = [c["value"] for c in snap["counts"] if c["name"] == "detect.nms_rounds"]
    assert len(rounds) == 5 and all(r >= 1 for r in rounds)


def test_the_feed_records_its_spans_and_depth():
    batches = [{"x": np.full((2, 3), i, np.float32)} for i in range(4)]
    profiling.enable()
    got = [b["x"][0, 0].item() for b in prefetch_to_device(iter(batches), device="cpu")]
    assert got == [0, 1, 2, 3]
    snap = profiling.snapshot()
    assert _names(snap).count("train.feed.stage") == 4
    assert _names(snap).count("train.feed.wait") == 5  # the last get takes the end
    depths = [c["value"] for c in snap["counts"] if c["name"] == "train.feed.depth"]
    assert len(depths) == 5 and all(0 <= d <= 2 for d in depths)


def test_an_eager_train_step_records_its_four_parts():
    cfg = TrainConfig(model_type="baseline", batch_size=4, num_classes=4)
    state = create_train_state(get_model("baseline", num_classes=4), cfg, "baseline",
                               torch.device("cpu"))
    rng = np.random.default_rng(0)
    batch = {"image": torch.from_numpy(rng.standard_normal((4, 32, 32, 3), dtype=np.float32)),
             "label": torch.from_numpy(rng.integers(0, 4, 4).astype(np.int64))}
    step = make_train_step("baseline")
    profiling.enable()
    step(state, batch)
    snap = profiling.snapshot()
    req = next(s for s in snap["spans"] if s["name"] == "train.step")
    launch = next(s for s in snap["spans"] if s["name"] == "train.step.launch")
    assert launch["parent"] == req["id"]
    assert _names(snap, parent=launch["id"]) == ["train_step.forward", "train_step.backward",
                                                 "train_step.grads", "train_step.optimizer"]
    assert all(s["request"] == req["id"] for s in snap["spans"] if s["name"] != "python.gc")
