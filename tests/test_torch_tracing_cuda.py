"""The tracing registry's device side on the card (``csrc/trace_stamp.cu``):
stamps inside a captured CUDA graph take fresh slots on every replay and
time work as CUDA events do; a graph captured with tracing off stamps
nothing; the clock's resolution.

These tests need an NVIDIA card and ``nvcc``; without them they skip. On
the card: ``python -m pytest tests/test_torch_tracing_cuda.py -m cuda -s``."""

import numpy as np
import pytest
import torch
import torch.nn as nn

from facerec_torch.config import ServeConfig, TrainConfig
from facerec_torch.data.synthetic import face_frames
from facerec_torch.detect.mtcnn import MTCNN
from facerec_torch.detect.weights import load_detector_params
from facerec_torch.models import get_model
from facerec_torch.serve.pipeline import FacePipeline
from facerec_torch.train.state import create_train_state
from facerec_torch.train.steps import make_train_step
from facerec_torch.utils import profiling

pytestmark = pytest.mark.cuda

HW = (120, 160)
SLEEP_CYCLES = 40_000_000  # about 20 ms at the H100's clocks


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the stamp kernel has no CPU or interpret mode")
    profiling.disable()
    profiling.reset()
    yield torch.device("cuda", torch.cuda.current_device())
    profiling.disable()
    profiling.reset()


def _cursor(dev) -> int:
    torch.cuda.synchronize(dev)
    return int(profiling.REGISTRY.ring(dev).buf[0].item())


def test_stamps_in_a_graph_take_fresh_slots_and_time_as_events_do(dev):
    profiling.enable()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        with profiling.device_span("test.sleep", dev):
            torch.cuda._sleep(SLEEP_CYCLES)
    profiling.reset()
    events = []
    for _ in range(3):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        events.append((a, b))
    assert _cursor(dev) == 6  # two stamps a replay
    snap = profiling.snapshot()
    spans = [s for s in snap["spans"] if s["name"] == "test.sleep"]
    assert len(spans) == 3 and len({s["id"] for s in spans}) == 3
    assert all(s["clock"] == str(dev) for s in spans)
    assert [s["start"] for s in spans] == sorted(s["start"] for s in spans)
    for s, (a, b) in zip(spans, events):
        ms = (s["end"] - s["start"]) * 1e3
        ref = a.elapsed_time(b)
        print(f"span {ms:.4f} ms, events {ref:.4f} ms")
        assert ms == pytest.approx(ref, rel=0.05)


def test_a_traced_train_step_graph_stamps_each_replay(dev):
    state, step, batches = _train(dev)
    profiling.enable()
    for b in batches[:2]:
        step(state, b)  # the first captures the traced graph
    profiling.reset()
    for b in batches:
        step(state, b)
    snap = profiling.snapshot()
    reqs = [s["id"] for s in snap["spans"] if s["name"] == "train.step"]
    assert len(reqs) == len(batches)
    for part in ("forward", "backward", "grads", "optimizer"):
        got = [s for s in snap["spans"] if s["name"] == f"train_step.{part}"]
        assert [s["request"] for s in got] == reqs
        assert all(s["end"] > s["start"] for s in got)


def _train(dev):
    cfg = TrainConfig(model_type="baseline", batch_size=8, num_classes=4)
    state = create_train_state(get_model("baseline", num_classes=4), cfg, "baseline", dev)
    rng = np.random.default_rng(0)
    batches = [{"image": torch.from_numpy(rng.standard_normal((8, 32, 32, 3),
                                                             dtype=np.float32)).to(dev),
                "label": torch.from_numpy(rng.integers(0, 4, 8).astype(np.int64)).to(dev)}
               for _ in range(4)]
    return state, make_train_step("baseline"), batches


class _MeanEmbedder(nn.Module):
    def __init__(self, size: int, dev, dim: int = 512):
        super().__init__()
        self.proj = torch.randn(size * 3, dim, generator=torch.Generator().manual_seed(0)).to(dev)

    def embed(self, crops: torch.Tensor) -> torch.Tensor:
        return crops.float().mean(2).reshape(len(crops), -1) @ self.proj


@pytest.mark.parametrize("path", ["serve", "train"])
def test_a_graph_captured_with_tracing_off_stamps_nothing(dev, path):
    profiling.enable()  # makes the ring, which stays
    profiling.disable()
    if path == "train":
        state, step, batches = _train(dev)

        def call(i):
            return step(state, batches[i % len(batches)])
    else:
        cfg = ServeConfig(max_faces=2, gallery_capacity=16, top_k=3, embed_size=64,
                          detection_threshold=0.0, gallery_dtype="float32")
        det = MTCNN(HW, min_face_size=40, max_faces=2, k_pnet=16, k_rnet=8,
                    input_range="255", device=dev).load_jax_params(load_detector_params())
        pipe = FacePipeline(cfg, HW, det, _MeanEmbedder(64, dev), device=dev)
        frames = face_frames(2, HW, 1, np.random.default_rng(0)).astype(np.uint8)

        def call(i):
            return pipe.identify(frames)
    call(0)  # captures with tracing off
    base = _cursor(dev)
    for i in range(1, 6):
        call(i)
    assert _cursor(dev) == base == 0
    assert profiling.snapshot() == {"spans": [], "counts": []}


def test_the_clock_resolution(dev):
    steps = profiling.timer_steps_ns(dev, 256)
    print(f"%globaltimer: smallest step {min(steps)} ns, median "
          f"{sorted(steps)[len(steps) // 2]} ns over {len(steps)} changes "
          f"({torch.cuda.get_device_name(dev)})")
    assert min(steps) > 0
