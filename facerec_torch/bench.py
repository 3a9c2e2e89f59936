"""End-to-end serve benchmark: detect -> align -> embed -> match throughput
on one card (counterpart of the repository's root ``bench.py``).

    python -m facerec_torch.bench [--device cuda|cpu]
    python -m facerec_torch.cli.main bench

The configuration is ``bench.py``'s: 48 frames of 480 x 640 with 8
photo-style faces each, rendered first from ``default_rng(0)``; MTCNN
(min face 40, ``k_pnet`` 64, ``k_rnet`` 32, bf16, 0..255 input) with the
committed detector weights, drawn at random where the file is missing; a
full-width ResNet-18 ArcFace embedder from seed 1 in bf16; top-5 against a
half-filled bf16 gallery (``add_many`` from the same rng up to 8,192 rows,
seeded normals made on the card with ``add_many_device`` above). Knobs, with
``bench.py``'s names and defaults: ``BENCH_BATCH`` (48), ``BENCH_GALLERY``
(1,024), ``BENCH_K_RNET`` (32) and ``BENCH_TRANSFER`` (unset: also time a
fresh uint8 upload per step).

The fill comes from one ``process`` of the frames; then
``FacePipeline.benchmark`` times the captured step by CUDA events. The last
line of stdout is ``bench.py``'s JSON line without ``vs_baseline`` (its
5,000 faces/s is a target set for a TPU v5e-8, not for this card); a ``#``
line on stderr gives the frame rate, the configuration, the device and the
card's name and power limit, the device and host ms per step. With
``--device cpu`` the same path runs on the plain versions and the step is
timed with the host clock, which the ``#`` line says.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

FRAME_HW = (480, 640)
MAX_FACES = 8
BAR = 0.95  # share of the B x max_faces slots the detector must fill (bench.py)
HOST_GALLERY_MAX = 8192  # above this, the gallery is generated on the device
ITERS, TRANSFER_ITERS = 20, 12  # bench.py's timed steps
METRIC = "aligned faces/sec/chip (detect->align->embed->match)"


def card_label(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi reports them; on the
    CPU, ``cpu``."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[device.index or 0]


def build_pipeline(frame_hw: tuple[int, int], gallery_capacity: int, k_rnet: int,
                   device: torch.device):
    """``bench.py``'s pipeline on ``device``."""
    from facerec_torch.config import ServeConfig
    from facerec_torch.detect.mtcnn import MTCNN, init_like_flax
    from facerec_torch.detect.weights import load_detector_params
    from facerec_torch.models.arcface import build_embedder
    from facerec_torch.serve.pipeline import FacePipeline

    cfg = ServeConfig(max_faces=MAX_FACES, gallery_capacity=gallery_capacity, top_k=5,
                      embed_size=160, detection_threshold=0.0)
    det = MTCNN(frame_hw, min_face_size=40, max_faces=cfg.max_faces, k_pnet=64, k_rnet=k_rnet,
                dtype=torch.bfloat16, input_range="255", device=device)
    try:
        det.load_jax_params(load_detector_params())
    except FileNotFoundError:
        gen = torch.Generator().manual_seed(0)
        for net in (det.pnet, det.rnet, det.onet):
            init_like_flax(net.float().cpu(), gen)
        det.to(device=device, dtype=torch.bfloat16)
    emb = build_embedder(dtype=torch.bfloat16, seed=1, device=device)
    return FacePipeline(cfg, frame_hw, det, emb, embed_dim=512, device=device)


def fill_gallery(pipe, rng: np.random.Generator) -> None:
    """Half the gallery's capacity: host normals from ``rng`` in one upload,
    or above ``HOST_GALLERY_MAX`` rows seeded normals made on the device."""
    n = pipe.gallery.capacity // 2
    names = [f"id_{i}" for i in range(n)]
    if n > HOST_GALLERY_MAX:
        gen = torch.Generator(device=pipe.device).manual_seed(5)
        pipe.gallery.add_many_device(names, torch.randn(n, 512, generator=gen,
                                                        device=pipe.device))
    else:
        pipe.gallery.add_many(names, rng.normal(size=(n, 512)).astype(np.float32))


def _host_timed(fn, b: int, faces: int, iters: int, warmup: int) -> dict[str, float]:
    """``fn`` timed with the host clock after ``warmup`` calls (the CPU's
    counterpart of ``FacePipeline._timed``)."""
    for _ in range(warmup):
        fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    dt = (time.perf_counter() - t0) / iters
    return {"sec_per_batch": dt, "host_sec_per_batch": dt, "frames_per_sec": b / dt,
            "faces_per_sec": b * faces / dt}


def prepare(batch: int = 48, gallery: int = 1024, k_rnet: int = 32,
            frame_hw: tuple[int, int] = FRAME_HW, device: str | torch.device | None = None
            ) -> tuple:
    """``bench.py``'s pipeline with its gallery filled, and its frames:
    (pipeline, frames [batch, H, W, 3] f32)."""
    from facerec_torch import resolve_device
    from facerec_torch.data.synthetic import face_frames

    pipe = build_pipeline(frame_hw, gallery, k_rnet, resolve_device(device))
    rng = np.random.default_rng(0)
    frames = face_frames(batch, frame_hw, MAX_FACES, rng)  # before the gallery draws
    fill_gallery(pipe, rng)
    return pipe, frames


def measure(pipe, frames: np.ndarray, transfer: bool = False, iters: int = ITERS,
            transfer_iters: int = TRANSFER_ITERS) -> tuple[dict, dict]:
    """The fill from one ``process``, then the timed steps; returns
    (``bench.py``'s result line less ``vs_baseline``, the details its ``#``
    line prints)."""
    batch = len(frames)
    t0 = time.time()
    probs = pipe.process(frames).probs.float().cpu().numpy()
    found = float((probs >= 0.6).sum())
    found_090 = float((probs >= 0.9).sum())
    expected = batch * MAX_FACES
    if found < BAR * expected:
        print(f"# WARNING detector found {found:.0f}/{expected} faces at prob>=0.6",
              file=sys.stderr)
    on_card = pipe.device.type == "cuda"
    if on_card:
        stats = pipe.benchmark(frames, iters=iters)
    else:
        x = pipe.upload(frames)
        stats = _host_timed(lambda: pipe.run_step(x), batch, MAX_FACES, iters, warmup=1)
    tstats = None
    if transfer:
        if on_card:
            tstats = pipe.benchmark_transfer(frames, iters=transfer_iters)
        else:
            u8 = np.clip(frames, 0, 255).astype(np.uint8)
            tstats = _host_timed(lambda: pipe.process(u8), batch, MAX_FACES, transfer_iters,
                                 warmup=1)
    total_s = time.time() - t0
    out = {
        "metric": METRIC,
        "value": round(stats["faces_per_sec"], 1),
        "unit": "faces/sec/chip",
        "detected": int(found),
        "detected_expected": expected,
        "detected_ok": bool(found >= BAR * expected),
        "detected_p090": int(found_090),
        "detected_p090_ok": bool(found_090 >= BAR * expected),
    }
    if tstats is not None:
        out["transfer_inclusive_faces_per_sec"] = round(tstats["faces_per_sec"], 1)
    note = {"frames/sec": stats["frames_per_sec"], "batch": batch,
            "frame": tuple(pipe.frame_hw), "max_faces": MAX_FACES,
            "gallery": pipe.gallery.capacity, "total_bench_s": total_s,
            "device": pipe.device.type, "timing": "cuda_events" if on_card else "host_clock",
            "device_ms_per_step": stats["sec_per_batch"] * 1e3 if on_card else None,
            "host_ms_per_step": stats["host_sec_per_batch"] * 1e3,
            "detected": f"{found:.0f}/{expected}", "detected@0.9": f"{found_090:.0f}",
            "card": card_label(pipe.device)}
    return out, note


def note_line(note: dict) -> str:
    """The ``#`` line: ``key=value`` fields, the card's label last."""
    def fmt(k, v):
        if v is None:
            return f"{k}=not_measured"
        if isinstance(v, float):
            return f"{k}={v:.1f}" if k in ("frames/sec", "total_bench_s") else f"{k}={v:.3f}"
        return f"{k}={v}" if not isinstance(v, tuple) else f"{k}={v[0]}x{v[1]}"

    return "# " + " ".join(fmt(k, v) for k, v in note.items() if k != "card") + \
        f" card={note['card']}"


def main(argv: list[str] | None = None, device: str | None = None) -> int:
    """Read the knobs from the environment, run, print the two lines."""
    if device is None:
        p = argparse.ArgumentParser(prog="python -m facerec_torch.bench",
                                    description="end-to-end serve benchmark (bench.py's)")
        p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
        device = p.parse_args(argv).device
    pipe, frames = prepare(batch=int(os.environ.get("BENCH_BATCH", 48)),
                           gallery=int(os.environ.get("BENCH_GALLERY", 1024)),
                           k_rnet=int(os.environ.get("BENCH_K_RNET", 32)), frame_hw=FRAME_HW,
                           device=device)
    out, note = measure(pipe, frames, transfer=bool(os.environ.get("BENCH_TRANSFER")),
                        iters=ITERS, transfer_iters=TRANSFER_ITERS)
    print(json.dumps(out), flush=True)
    print(note_line(note), file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
