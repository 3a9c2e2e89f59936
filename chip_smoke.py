"""Chip smoke test of the PyTorch/CUDA port (``facerec_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises (and so exits nonzero) on failure:

  1. build    every CUDA kernel of the serve step from ``facerec_torch/csrc``
              (one ``nvcc`` per source, all at once);
  2. K1       the gallery top-k kernel against its plain PyTorch version: the
              serve shape (384 x 1024 x 512, bf16 gallery, count 512), count
              < k, count 0, an f32 gallery, and a ragged 131,072-row gallery;
              indices exact, values within 2e-3 (bf16) / 1e-4 (f32);
  3. K2       the 2-shear rotation kernel against ``rotate_patches`` at
              384 x 208 -> 160, angles up to +-15 degrees; max abs <= 1.0 and
              mean < 1e-3 on 0..255 input;
  4. serve    the port's serve step at ``bench.py``'s configuration (48 frames
              of 480 x 640 with 8 rendered faces each, MTCNN with the
              committed detector weights in bf16, a full-width ResNet-18
              ArcFace embedder in bf16 from seed 1, a 1024-row bf16 gallery
              half filled), once with every launch count set to 0 just before:
              both kernels must have launched, and at least 0.95 x 384 faces
              must be found at p >= 0.6; then the same step on a small input,
              on the card and on the CPU, must agree; then faces/s after
              warm-up, timed with CUDA events, and a per-stage breakdown;
  5. summary  one JSON line of kernels (time, plain version's time, library
              call's time, bound, launches, error), the card's name and power
              limit, and the result line.

Exits nonzero, printing no result, when no CUDA card is present or when run
outside a checkout of the repository.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s, f32 FLOP/s on
# the CUDA cores (both kernels compute in f32).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

FRAME_HW = (480, 640)
BATCH = 48
FACES = 8


def _card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def check_k1(dev):
    """Phase 2. Returns (inputs at the serve shape, max abs error there)."""
    import torch

    from facerec_torch.ops.gallery import gallery_topk, gallery_topk_plain

    g0 = torch.Generator(device=dev).manual_seed(11)

    def unit(rows, dim):
        x = torch.randn(rows, dim, generator=g0, device=dev)
        return x / x.norm(dim=1, keepdim=True)

    q = unit(BATCH * FACES, 512)
    g_serve = unit(1024, 512).to(torch.bfloat16)
    g_big = unit(131072, 512).to(torch.bfloat16)
    cases = [("serve", g_serve, 512, 2e-3), ("count<k", g_serve, 3, 2e-3),
             ("count0", g_serve, 0, 2e-3), ("f32", g_serve.float(), 512, 1e-4),
             ("ragged131072", g_big, 100003, 2e-3)]
    serve_err = None
    for name, g, count, tol in cases:
        cnt = torch.tensor(count, dtype=torch.int32, device=dev)
        v1, i1 = gallery_topk(q, g, cnt, k=5)
        v0, i0 = gallery_topk_plain(q, g, cnt, k=5)
        torch.cuda.synchronize()
        nv = min(count, 5)
        idx_ok = torch.equal(i1[:, :nv], i0[:, :nv])
        err = (v1[:, :nv] - v0[:, :nv]).abs().max().item() if nv else 0.0
        pad_ok = torch.equal(i1, i0) and torch.equal(v1[:, nv:], v0[:, nv:])
        print(f"K1 {name}: G={g.shape[0]} {str(g.dtype)[6:]} count={count} indices_exact={idx_ok} "
              f"masked_slots_exact={pad_ok} max_abs_err={err:.3g} (tol {tol})", flush=True)
        if not (idx_ok and pad_ok and err <= tol):
            bad = (i1[:, :nv] != i0[:, :nv]).any(dim=1).nonzero().flatten()[:3].tolist()
            raise AssertionError(f"K1 {name} disagrees with its plain version (rows {bad})")
        if name == "serve":
            serve_err = err
    return (q, g_serve, 512), serve_err


def check_k2(dev):
    """Phase 3. Returns (inputs at the serve shape, max abs error)."""
    import torch

    from facerec_torch.ops.warp_kernel import rotate_patches_kernel
    from facerec_torch.ops.warp_fast import rotate_patches

    g0 = torch.Generator(device=dev).manual_seed(12)
    n, p, e = BATCH * FACES, 208, 160
    patches = (torch.rand(n, p, p, 3, generator=g0, device=dev) * 255).to(torch.bfloat16)
    angles = (torch.rand(n, generator=g0, device=dev) * 2 - 1) * math.radians(15.0)
    centers = p * (0.4 + 0.2 * torch.rand(n, 2, generator=g0, device=dev))
    got = rotate_patches_kernel(patches, angles, centers, e).float()
    ref = rotate_patches(patches, angles, centers, e).float()
    torch.cuda.synchronize()
    err = (got - ref).abs()
    mx, mean = err.max().item(), err.mean().item()
    print(f"K2 rotate: N={n} P={p} E={e} max_abs_err={mx:.3g} mean_abs_err={mean:.3g} "
          f"exact_share={(err == 0).float().mean().item():.6f}", flush=True)
    if not (mx <= 1.0 and mean < 1e-3):
        raise AssertionError("K2 disagrees with its plain version")
    return (patches, angles, centers, e), mx


def build_pipeline(dev, frame_hw, max_faces, dtype, batch_cfg):
    import torch

    from facerec_torch.config import ServeConfig
    from facerec_torch.detect.mtcnn import MTCNN
    from facerec_torch.detect.weights import load_detector_params
    from facerec_torch.models.arcface import build_embedder
    from facerec_torch.serve.pipeline import FacePipeline

    cfg = ServeConfig(max_faces=max_faces, detection_threshold=0.0, **batch_cfg)
    det = MTCNN(frame_hw, min_face_size=40, max_faces=max_faces, k_pnet=64, k_rnet=32,
                dtype=dtype, input_range="255", device=dev)
    det.load_jax_params(load_detector_params())
    emb = build_embedder(dtype=dtype, seed=1, device=dev)
    return FacePipeline(cfg, frame_hw, det, emb, embed_dim=512, device=dev)


def small_input_agrees(dev) -> None:
    """The port's step on 2 small frames, f32, on the card (kernels) and on
    the CPU (plain versions): same valid slots, embeddings within cosine
    0.999, same top-1 matches."""
    import numpy as np
    import torch

    from facerec_torch.data.synthetic import face_frames

    hw = (120, 160)
    frames = face_frames(2, hw, 1, np.random.default_rng(0))
    names = [f"id{i}" for i in range(8)]
    gal = np.random.default_rng(3).normal(size=(8, 512)).astype(np.float32)
    results = []
    for d in (dev, torch.device("cpu")):
        pipe = build_pipeline(d, hw, 2, torch.float32,
                              dict(gallery_capacity=16, top_k=3, embed_size=160))
        probe = pipe.process(frames).embeddings.reshape(-1, 512).cpu().numpy()
        g = gal.copy()
        g[[1, 5, 2, 6]] = probe + 0.02 * np.random.default_rng(4).normal(size=probe.shape)
        pipe.gallery.add_many(names, g)
        results.append(pipe.process(frames))
    a, b = ([t.cpu() for t in r] for r in results)
    va, vb = a[3], b[3]
    cos = (a[4] * b[4]).sum(-1)[va]
    same_top1 = torch.equal(a[6][..., 0][va], b[6][..., 0][vb])
    print(f"small input card vs cpu: valid {va.sum().item()}/{vb.sum().item()} "
          f"min_cos={cos.min().item():.6f} same_top1={same_top1}", flush=True)
    if not (torch.equal(va, vb) and va.any() and cos.min().item() > 0.999 and same_top1):
        raise AssertionError("the step on the card disagrees with the CPU step on a small input")


def serve(dev):
    """Phase 4. Returns the kernels' launches in one step and step stats."""
    import numpy as np
    import torch

    from facerec_torch.data.synthetic import face_frames
    from facerec_torch.ops.gallery import gallery_topk
    from facerec_torch.ops.warp_kernel import rotate_patches_kernel

    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    frames = face_frames(BATCH, FRAME_HW, FACES, rng)
    print(f"rendered {BATCH} frames in {time.perf_counter() - t0:.1f} s", flush=True)
    pipe = build_pipeline(dev, FRAME_HW, FACES, torch.bfloat16,
                          dict(gallery_capacity=1024, top_k=5, embed_size=160))
    n_ids = 1024 // 2
    pipe.gallery.add_many([f"id_{i}" for i in range(n_ids)],
                          rng.normal(size=(n_ids, 512)).astype(np.float32))
    t0 = time.perf_counter()
    pipe.process(frames)  # first call: cuDNN autotuning, allocator warm-up
    torch.cuda.synchronize()
    print(f"first step {time.perf_counter() - t0:.2f} s", flush=True)

    gallery_topk.launches = 0
    rotate_patches_kernel.launches = 0
    r = pipe.process(frames)
    torch.cuda.synchronize()
    launches = {"gallery_topk": gallery_topk.launches,
                "shear_rotate": rotate_patches_kernel.launches}
    print(f"launches in one step: {launches}", flush=True)
    if min(launches.values()) < 1:
        raise AssertionError(f"the serve step did not go through every kernel: {launches}")

    probs = r.probs.float().cpu().numpy()
    expected = BATCH * FACES
    found, found_090 = int((probs >= 0.6).sum()), int((probs >= 0.9).sum())
    valid = r.valid.cpu().numpy()
    emb = r.embeddings.cpu().numpy()
    idx = r.match_indices.cpu().numpy()
    scores = r.match_scores.cpu().numpy()
    norms = np.linalg.norm(emb[valid], axis=-1)
    print(f"detected {found}/{expected} at p>=0.6, {found_090}/{expected} at p>=0.9; "
          f"valid slots {int(valid.sum())}", flush=True)
    if found < 0.95 * expected:
        raise AssertionError(f"detector found {found}/{expected} faces at p>=0.6 (< 0.95 bar)")
    if not (emb.shape == (BATCH, FACES, 512) and np.isfinite(emb).all()
            and np.allclose(norms, 1.0, atol=1e-3) and np.isfinite(scores).all()
            and (idx[valid] >= 0).all() and (idx[valid] < n_ids).all()
            and (np.abs(scores[valid]) <= 1.0 + 1e-3).all()):
        raise AssertionError("serve step outputs are malformed")

    small_input_agrees(dev)

    stats = pipe.benchmark(frames, iters=10, warmup=2)
    x = pipe.upload(frames)
    stages = stage_breakdown(pipe, x)
    busy = device_busy(pipe, x)
    return launches, dict(stats, detected=found, detected_p090=found_090,
                          detected_expected=expected, stages_ms=stages, **busy)


def device_busy(pipe, x, steps: int = 3) -> dict:
    """Share of the wall time the card spends in kernels and copies over
    ``steps`` serve steps (torch.profiler; the profiler's own host cost
    lengthens the wall time, so the share is a lower bound), and the
    kernels that take the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            pipe.step(x)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev_events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    total_us = sum(e.self_device_time_total for e in dev_events)
    top = sorted(dev_events, key=lambda e: -e.self_device_time_total)[:8]
    out = {"device_busy_share": total_us / wall_us if total_us else None,
           "device_ms_per_step": total_us / steps / 1e3,
           "top_kernels_ms_per_step": {e.key[:80]: e.self_device_time_total / steps / 1e3
                                       for e in top}}
    print("profile: " + json.dumps(out), flush=True)
    return out


def stage_breakdown(pipe, x) -> dict:
    """CUDA-event time of each stage of the step, run alone on the step's
    own intermediate tensors."""
    import torch

    from facerec_torch.ops.arcface import l2_normalize
    from facerec_torch.ops.gallery import gallery_topk
    from facerec_torch.ops.warp_fast import align_and_crop_fast_batched

    cfg = pipe.config
    with torch.no_grad():
        d = pipe.detector.detect(x)
        crops = align_and_crop_fast_batched(x.float(), d.boxes, d.landmarks, cfg.embed_size,
                                            out_dtype=torch.bfloat16)
        flat = crops.reshape(-1, cfg.embed_size, cfg.embed_size, 3)
        emb = l2_normalize(pipe.embedder.embed(flat).float())
        g, c = pipe.gallery.embeddings, pipe.gallery.count_device
        out = {
            "detect": _time_ms(lambda: pipe.detector.detect(x), iters=5, warmup=1),
            "align": _time_ms(lambda: align_and_crop_fast_batched(
                x.float(), d.boxes, d.landmarks, cfg.embed_size, out_dtype=torch.bfloat16),
                iters=5, warmup=1),
            "embed": _time_ms(lambda: pipe.embedder.embed(flat), iters=5, warmup=1),
            "match": _time_ms(lambda: gallery_topk(emb, g, c, k=cfg.top_k), iters=20),
        }
    print("stage ms: " + json.dumps(out), flush=True)
    return out


def kernel_rows(k1_in, k1_err, k2_in, k2_err, launches) -> list[dict]:
    import torch

    from facerec_torch.ops.gallery import gallery_topk, gallery_topk_plain
    from facerec_torch.ops.warp_kernel import rotate_patches_kernel
    from facerec_torch.ops.warp_fast import rotate_patches

    q, g, count = k1_in
    cnt = torch.tensor(count, dtype=torch.int32, device=q.device)
    gf = g.float()[:count]
    b, dim = q.shape
    k = 5
    k1_bound, k1_by = _bound_ms(b * dim * 4 + count * dim * g.element_size() + b * k * 8,
                                2.0 * b * count * dim)
    patches, angles, centers, e = k2_in
    n, p = patches.shape[0], patches.shape[1]
    c = patches.shape[3]
    # per output element: two y-pass values (2 products + 1 sum each) and
    # the x pass (2 products + 1 sum)
    k2_bound, k2_by = _bound_ms(n * p * p * c * 2 + n * e * e * c * 2 + n * (4 + 8),
                                9.0 * n * e * e * c)
    return [
        {"name": "gallery_topk", "route": "cuda", "source": "facerec_torch/csrc/gallery_topk.cu",
         "replaces": "facerec_tpu/ops/gallery.py:70", "launches": launches["gallery_topk"],
         "max_abs_err": k1_err,
         "ms": _time_ms(lambda: gallery_topk(q, g, cnt, k=k), iters=50),
         "plain_ms": _time_ms(lambda: gallery_topk_plain(q, g, cnt, k=k), iters=50),
         "bound_ms": k1_bound, "bound_by": k1_by,
         "library_ms": _time_ms(lambda: torch.topk(torch.matmul(q, gf.T), k), iters=50)},
        {"name": "shear_rotate", "route": "cuda", "source": "facerec_torch/csrc/shear_rotate.cu",
         "replaces": "facerec_tpu/ops/pallas_warp.py:84", "launches": launches["shear_rotate"],
         "max_abs_err": k2_err,
         "ms": _time_ms(lambda: rotate_patches_kernel(patches, angles, centers, e), iters=20),
         "plain_ms": _time_ms(lambda: rotate_patches(patches, angles, centers, e), iters=5),
         "bound_ms": k2_bound, "bound_by": k2_by, "library_ms": None},
    ]


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card present; nothing was run", file=sys.stderr)
        return 2
    if not (ROOT / "facerec_torch" / "csrc").is_dir():
        print(f"chip_smoke: {ROOT} is not a checkout of the repository (no facerec_torch/)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from facerec_torch import build

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 products in full f32
    torch.backends.cudnn.allow_tf32 = False
    card = _card()
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    secs = build.build(force=True)
    print(f"build: {len(build.SOURCES)} kernels in {secs:.1f} s", flush=True)
    for name in build.SOURCES:
        for line in (build.BUILD_DIR / f"{name}.log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    k1_in, k1_err = check_k1(dev)
    k2_in, k2_err = check_k2(dev)
    launches, stats = serve(dev)
    print("serve: " + json.dumps({"faces_per_sec": stats["faces_per_sec"],
                                  "sec_per_batch": stats["sec_per_batch"],
                                  "host_sec_per_batch": stats["host_sec_per_batch"],
                                  "detected": stats["detected"],
                                  "detected_p090": stats["detected_p090"],
                                  "detected_expected": stats["detected_expected"],
                                  "stages_ms": stats["stages_ms"],
                                  "device_busy_share": stats["device_busy_share"],
                                  "card": card}), flush=True)
    rows = kernel_rows(k1_in, k1_err, k2_in, k2_err, launches)
    print(json.dumps({"kernels": rows, "card": card}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
