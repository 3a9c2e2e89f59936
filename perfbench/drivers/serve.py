"""Serve traffic: a closed loop of batch requests to
``FacePipeline.identify``, one batch in flight.

Set-up renders the traffic's frame pool from the seed (the benchmark's own
copy of the renderer), loads the detector's committed weights, makes the
embedder's weights and the gallery's rows on the card from the seed, builds
the port's pipeline on them and warms it up with the traffic's
``warmup_requests`` (the first captures the step; the rest bring the host
and the card to the pace they keep, which the first seconds of requests
fall short of). The window then sends request after request for the
run's seconds, each a batch of the pool with a salt of the request's
number in one pixel, so that no two uploads are alike. A request's
latency is from its hand-off to ``identify`` to its answer on the host.

With ``trace``, spans are recorded around the pipeline's ``upload``, and
after the window a few requests run under the profiler and each stage is
timed eagerly by CUDA events on a window batch.

Once the window has closed and the peak memory has been read, the
program's state is freed and a sample of the window's requests, drawn
from the seed, is judged by the plain reference (``judge_serve``)."""

from __future__ import annotations

import gc
import math
import sys
import time

import numpy as np
import torch

from perfbench import embedders, flops, harness, render, trace, weights
from perfbench.judge_serve import ServeJudge, failed_request, merge
from perfbench.reference import mtcnn as ref_mtcnn
from perfbench.reference.match import Gallery
from perfbench.reference.precision import no_tf32


def detector_trees(config: dict) -> dict:
    """{net: {layer: {name: array}}} from the committed ``.npz`` files."""
    d = harness.ROOT / config["detector"]["weights"]
    trees = {}
    for net in ("pnet", "rnet", "onet"):
        tree: dict = {}
        with np.load(d / f"{net}.npz") as z:
            for key in z.files:
                layer, leaf = key.split("/")
                tree.setdefault(layer, {})[leaf] = z[key]
        trees[net] = tree
    return trees


def detector_spec(config: dict, traffic: dict) -> ref_mtcnn.DetectorSpec:
    det = config["detector"]
    return ref_mtcnn.DetectorSpec(tuple(traffic["frame_hw"]), det["min_face_size"],
                                  det["max_faces"], det["k_pnet"], det["k_rnet"])


def frame_pool(traffic: dict, seed: int) -> list[np.ndarray]:
    rng = np.random.default_rng(weights.sub_seed(seed, "frames"))
    return [np.clip(render.face_frames(traffic["batch"], tuple(traffic["frame_hw"]),
                                       traffic["faces_per_frame"], rng), 0, 255).astype(np.uint8)
            for _ in range(traffic["pool_batches"])]


def salt(batch: np.ndarray, i: int) -> np.ndarray:
    """Write request ``i``'s number into the first frame's first pixel."""
    batch[0, 0, 0, :] = (i & 0xFF, (i >> 8) & 0xFF, 1 + ((i >> 16) & 0x7F))
    return batch


def request_frames(pool: list[np.ndarray], i: int) -> np.ndarray:
    """The frames request ``i`` sent."""
    return salt(pool[i % len(pool)].copy(), i)


def row_name(i: int) -> str:
    return f"id_{i}"


def row_of(name: str) -> int | None:
    return int(name[3:]) if name.startswith("id_") and name[3:].isdigit() else None


def flops_per_request(config: dict, traffic: dict) -> int:
    """The benchmark's FLOPs of one request (``flops.serve_flops``), the
    embedder's from its kind's module."""
    emb = config["embedder"]
    return flops.serve_flops(
        {**config, "detector": {**config["detector"], "frame_hw": traffic["frame_hw"]}},
        traffic["batch"], traffic["enrolled"], embedders.get(emb["kind"]).macs(emb))


def build(cell: dict, seed: int, device):
    """The port's pipeline for the cell, its gallery filled, and the
    benchmark's inputs: (pipeline, frame pool, embedder weights, detector
    trees)."""
    from facerec_torch.config import ServeConfig
    from facerec_torch.detect.mtcnn import MTCNN
    from facerec_torch.serve.pipeline import FacePipeline

    config, traffic = cell["config"], cell["traffic"]
    det_c, emb_c, srv = config["detector"], config["embedder"], config["serve"]
    dtype = getattr(torch, config["dtype"])
    hw = tuple(traffic["frame_hw"])
    pool = frame_pool(traffic, seed)
    trees = detector_trees(config)
    emb_mod = embedders.get(emb_c["kind"])
    state = weights.make_state(emb_mod.shapes(emb_c), seed, device, dtype)
    scfg = ServeConfig(max_faces=det_c["max_faces"], gallery_capacity=traffic["gallery_capacity"],
                       top_k=srv["top_k"], embed_size=emb_c["crop"],
                       detection_threshold=srv["detection_threshold"],
                       recognition_threshold=srv["recognition_threshold"],
                       gallery_dtype=srv["gallery_dtype"])
    det = MTCNN(hw, min_face_size=det_c["min_face_size"], max_faces=det_c["max_faces"],
                k_pnet=det_c["k_pnet"], k_rnet=det_c["k_rnet"], dtype=dtype,
                input_range=det_c["input_range"], device=device)
    det.load_jax_params(trees)
    emb = emb_mod.program(state, emb_c, device, dtype)
    pipe = FacePipeline(scfg, hw, det, emb, embed_dim=emb_c["embedding_dim"], device=device)
    n = traffic["enrolled"]
    names = [row_name(i) for i in range(n)]
    for start, rows in weights.gallery_rows(n, emb_c["embedding_dim"], seed, device):
        pipe.gallery.add_many_device(names[start:start + len(rows)], rows)
    return pipe, pool, state, trees


class Window:
    """The requests of a run, their latencies, and a sample of ``k`` of
    their answers drawn from the seed as they come (reservoir sampling:
    every request is as likely to be kept, and the answers not kept are
    let go at once, so the process holds no more of them as the window
    goes on)."""

    def __init__(self, k: int, seed: int):
        self.latencies: list[float] = []
        self.sample: dict[int, object] = {}
        self.failed = 0
        self.seconds = 0.0
        self._k = k
        self._rng = np.random.default_rng(weights.sub_seed(seed, "sample"))

    def keep(self, i: int, ans) -> None:
        """Request ``i`` (the ``i``-th of the window) answered ``ans``."""
        if i < self._k:
            self.sample[i] = ans
            return
        j = int(self._rng.integers(0, i + 1))
        if j < self._k:
            drop = sorted(self.sample)[j]
            del self.sample[drop]
            self.sample[i] = ans


def send(pipe, pool, i: int, win: Window | None = None):
    frames = salt(pool[i % len(pool)], i)
    t0 = time.perf_counter()
    try:
        ans = pipe.identify(frames)
    except Exception as e:  # a failed request is counted and the loop goes on
        print(f"perfbench: request {i} failed: {e!r}", file=sys.stderr)
        ans = None
    if win is not None:
        win.latencies.append(time.perf_counter() - t0)
        win.keep(len(win.latencies) - 1, ans)
        win.failed += ans is None
    return ans


def run_window(pipe, pool, seconds: float, first: int, k: int, seed: int) -> Window:
    win = Window(k, seed)
    t0 = time.perf_counter()
    deadline = t0 + seconds
    i = first
    while time.perf_counter() < deadline:
        send(pipe, pool, i, win)
        i += 1
    win.seconds = time.perf_counter() - t0
    return win


def percentile(values: list[float], q: float) -> float:
    """The nearest-rank ``q``-th percentile of all the values."""
    s = sorted(values)
    return s[max(math.ceil(q / 100.0 * len(s)) - 1, 0)]


def _cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


@torch.no_grad()
def stage_ms(pipe, frames: np.ndarray, reps: int) -> dict[str, float]:
    """Each stage of the step, eager, by CUDA events on one batch."""
    from facerec_torch.ops.arcface import l2_normalize
    from facerec_torch.serve.pipeline import DEFAULT_LANDMARKS

    x = pipe.upload(frames)
    r = pipe.step(x)
    lmk = torch.where(r.valid[..., None, None], r.landmarks,
                      torch.tensor(DEFAULT_LANDMARKS, device=x.device))
    s = pipe.config.embed_size
    crops = pipe.align(x, r.boxes, lmk).reshape(-1, s, s, 3)
    emb = l2_normalize(pipe.embedder.embed(crops).float())
    return {"detect": _cuda_ms(lambda: pipe.detector.detect(x), reps),
            "align": _cuda_ms(lambda: pipe.align(x, r.boxes, lmk), reps),
            "embed": _cuda_ms(lambda: pipe.embedder.embed(crops), reps),
            "match": _cuda_ms(lambda: pipe.match(emb), reps)}


def reference_judge(cell: dict, seed: int, device, state: dict, trees: dict) -> ServeJudge:
    """The plain reference's side of the comparison, on the benchmark's
    weights and the gallery rows drawn again from the seed."""
    no_tf32()
    config, traffic = cell["config"], cell["traffic"]
    emb_c = config["embedder"]
    emb_mod = embedders.get(emb_c["kind"])
    gallery = Gallery(weights.gallery_rows(traffic["enrolled"], emb_c["embedding_dim"], seed,
                                           device))
    return ServeJudge(ref_mtcnn.weights_from_npz(trees, device), detector_spec(config, traffic),
                      lambda p, crops: emb_mod.reference(p, state, crops), emb_c["crop"],
                      gallery, row_of)


def check(cell: dict, seed: int, device, pool, answers: dict[int, list], state: dict,
          trees: dict) -> dict[str, float]:
    """The reference's judgement of the sampled answers (request -> answer)."""
    judge = reference_judge(cell, seed, device, state, trees)
    readings = []
    with torch.no_grad():
        for i, ans in answers.items():
            frames = torch.from_numpy(request_frames(pool, i)).to(device)
            if ans is None:
                readings.append(failed_request())
            else:
                readings.append(judge.judge(ans, frames))
    return merge(readings)


def run(cell: dict, seed: int, seconds: float, traced: bool, t0: float, device) -> dict:
    """One run; returns what the result line needs."""
    traffic, config = cell["traffic"], cell["config"]
    on_card = torch.device(device).type == "cuda"
    request_flops = flops_per_request(config, traffic)  # an unknown kind fails here
    pipe, pool, state, trees = build(cell, seed, device)
    # the first request captures the step; the rest bring the host and the
    # card to the pace they keep through the window
    for j in range(traffic["warmup_requests"]):
        send(pipe, pool, (1 << 22) + j)
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    spans = trace.Spans()
    if traced:
        pipe.upload = spans.wrap("serve.upload", pipe.upload)
    win = run_window(pipe, pool, seconds, 0, traffic["check_requests"], seed)
    if traced:
        del pipe.upload  # the spans are the window's alone
    n = len(win.latencies)
    out = {"attempted": n, "failed": win.failed, "setup_s": setup_s,
           "frames_per_s": traffic["batch"] * (n - win.failed) / win.seconds,
           "latency_p95_ms": percentile(win.latencies, 95) * 1e3}
    ctx = {"spans": spans, "window": {"requests": n, "seconds": win.seconds},
           "config": config, "traffic": traffic, "chips": 1, "flops_per_request": request_flops}
    if traced and on_card:
        ctx["profile"] = trace.profile(lambda j: send(pipe, pool, n + j),
                                       traffic["profiled_requests"])
        ctx["stages_ms"] = stage_ms(pipe, pool[0], traffic["stage_reps"])
    out["ctx"] = ctx
    out["memory_peak_bytes"] = torch.cuda.max_memory_allocated() if on_card else 0
    answers = win.sample
    del pipe, win
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    c0 = time.perf_counter()
    out["numbers"] = check(cell, seed, device, pool, answers, state, trees)
    out["check_s"] = time.perf_counter() - c0
    return out


def main(cell: dict, seed: int, seconds: float, traced: bool, t0: float) -> int:
    out = run(cell, seed, seconds, traced, t0, "cuda")
    return harness.emit(cell, out, traced)
