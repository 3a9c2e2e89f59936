"""Chip smoke test of the PyTorch/CUDA port (``facerec_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises (and so exits nonzero) on failure:

  1. build    every CUDA kernel of the serve step from ``facerec_torch/csrc``
              (one ``nvcc`` per source, all at once), and the host JPEG loader
              (``csrc/loader.cpp``) with ``g++``; a loader that does not build
              prints the compiler's error and leaves the trainer on PIL;
  2. K1       the gallery top-k kernel against its plain PyTorch version fed
              the queries as the kernel rounds them (to the gallery dtype):
              the serve shape (384 x 1024 x 512, bf16 gallery, count 512),
              count < k, count 0, an f32 gallery, 131,072 rows with count
              100,003, 1,048,576 rows with count 524,287, counts at the edges
              of the kernel's row tiles and splits, k = 1 and 32, 37 queries,
              and identical rows on both sides of a split boundary (the lower
              row first). Indices exact, except where the plain scores of the
              two rows lie within 1e-5 (summation order; at most 0.1% of the
              slots); values within 1e-5, and within 2e-3 (bf16) / 1e-4 (f32)
              of the plain version with f32 queries. Then K1's time at
              1,024 / 131,072 / 1,048,576 rows (counts 512 / 65,536 / 524,288)
              beside its bound and two library yardsticks;
  3. K2       the 2-shear rotation kernel against ``rotate_patches``, bit
              for bit (``torch.equal``) on 0..255 input: 384 x 208 -> 160
              with angles up to +-15 degrees, angles of 0, angles of +-1e-7
              rad about off-centre centres (lines whose fine base rounds up
              to 8), angles beyond the clamp, centres at and beyond the
              0.1 x P cap, E == P, 128 -> 96, N = 1 and N = 0 (no launch);
  4. serve    the port's serve step at ``bench.py``'s configuration (48 frames
              of 480 x 640 with 8 rendered faces each, MTCNN with the
              committed detector weights in bf16, a full-width ResNet-18
              ArcFace embedder in bf16 from seed 1, a 1024-row bf16 gallery
              half filled), once with every launch count set to 0 just before:
              both kernels must have launched, and at least 0.95 x 384 faces
              must be found at p >= 0.6; then the same step on a small input,
              on the card and on the CPU, must agree; then faces/s after
              warm-up, timed with CUDA events, and a per-stage breakdown;
  5. serve 1M the same step with a 1,048,576-row gallery holding 524,288
              seeded ``torch.randn`` rows enrolled on the card
              (``GalleryStore.add_many_device``), as ``bench.py`` runs its
              production scale: launch counts from 0, both kernels launched,
              faces/s and the stage breakdown;
     serve_precise  the 1,024-row step with ``precise_align=True`` (the exact
              gather warp; K1 launched, K2 not): faces/s, stage ms and fill,
              and against the fast path on the same frames the same valid
              slots and embedding cosine > 0.98 where the eye angle is within
              +-15 degrees;
     serve_facenet  the 1,024-row step with a full-width InceptionResnetV1
              (FaceNet, repeats 5/10/5, 512-d, 160 px, bf16, seed 1) as the
              embedder: both kernels launched once, fill, the small input on
              the card against the CPU with FaceNet, faces/s, stage ms and
              the busy share, printed beside the ArcFace serve path's. On
              each serve path, each kernel it launched is held against its
              plain version on the inputs that path gave it;
     fold     the embed stage alone, every BatchNorm folded into its
              producer against unfolded, for the serve path's ArcFace and
              serve_facenet's FaceNet on each path's own 384 crops (bf16,
              BatchNorm statistics randomised from a seed): CUDA-event ms in
              turns and the embeddings' cosine > 1 - 1e-3; launch counts
              from 0 around the embed work, which launches neither kernel;
  6. train    the port's trainer (``train_model``) on the card with the
              configuration ``outputs/checkpoints/arcface_synth`` was trained
              with (full-width ResNet-18 ArcFace, 160 px, batch 32, 16 classes,
              AdamW + AMSGrad, warmup-cosine, progressive margin, bf16
              compute), for 6 epochs, on a synthetic ImageFolder of 16 x 40
              faces (28/6/6 per class) written to a temporary directory: best
              val accuracy >= 0.5 and the last epoch's train accuracy above the
              first; one f32 train step on the card against the same step on
              the CPU (loss and grad_norm within 1e-3 relative); then ms/step
              and images/s on device-resident batches (CUDA events), model
              TFLOP/s from the layer shapes, images/s of a whole epoch with
              loading, the device busy share and the peak memory; which
              batcher the trainer took (``loader``: native or pil) and each
              batcher's images/s alone, native then PIL, on the same tree.
              This path has no TPU kernel: neither Pallas kernel is reached
              from ``train_model``;
     eval     ``evaluate_model`` on the checkpoint the train phase wrote, on
              its test split (16 x 6 images of 160 px, default bf16 compute):
              accuracy >= the train bar, ROC-AUC, ms/batch and images/s;
              ``predict_image`` on 8 test images gives ``evaluate_model``'s
              argmax for each. No TPU kernel either;
     zoo      on the same tree, beside the ArcFace checkpoint: ``train_model``
              on cnn, attention, hybrid and siamese (full width, the
              arcface_synth optimizer and schedule, 3 epochs each; every
              loss finite, the last epoch's below the first's), each step
              timed on device-resident batches with its busy share and peak
              memory; one f32 step of each on the card against the CPU
              (1e-3); ``evaluate_model`` on each checkpoint (fixed pairs
              for siamese); the default ensemble from
              ``create_pretrained_ensemble`` (cnn + attention + the ArcFace)
              evaluated, its logits the mean of its members' within 1e-5.
              K1 and K2 must launch 0 times; one ``zoo:`` line per type;
     tune     on the same tree: ``train_model`` with ``use_lr_finder`` at
              the arcface_synth configuration for 2 epochs (a valid
              suggestion <= 5e-4 that the schedule starts from), 3 f32
              sweep steps on the card against the CPU from the same weights
              and batches (equal LRs, losses within 1e-3 relative);
              ``run_cross_validation`` (5 folds of 2 epochs, warm-started
              from the ArcFace checkpoint); ``python -m
              facerec_torch.cli.main hyperopt`` in a subprocess (arcface, 6
              trials of 3 epochs, the LR-finder pre-pass; no FAIL row, each
              trial's parameters equal to a replay of the study's draws on
              the host); ``generate_visualization_report`` on the ArcFace
              checkpoint (embeddings on the card against the CPU's) and
              ``main(["check-gpu"])``. K1 and K2 must launch 0 times;
     prep     ``process_raw_data`` on the card at the JAX package's settings
              (WORK_SIZE 512, batch 32, 224 px crops, margin 0.4, the
              committed detector weights at their source's thresholds,
              augmentation on) over a raw tree of 6 persons x 12 JPEG photos
              of one ``face_frames`` face each (480 x 640, rng(0)):
              ``process_batch`` images/s after a warm-up batch and its stage
              ms (``StageTimer``), faces found (>= 65 of 72), the split and
              augmented file counts; on 4 photos the card against the CPU:
              the chosen faces within 1% of the box side, the crops made
              from the same detections within 1 level on average, and the
              end-to-end crop difference printed; ``apply_augment`` card
              against CPU on the same draws (1e-4).
              K1 and K2 must launch 0 times;
     detector ``train_net`` for P-, R- and O-Net on the card at
              tests/test_detector.py's configuration (150 scenes, 120 steps,
              batch 256, seeds 0/1/2): mining s and ms per step (CUDA
              events); saved with ``save_detector_params``, loaded back and
              detecting on 16 ``render_scene(rng(77))`` scenes: >= 10 found
              at mean IoU > 0.4 (the JAX test's bars); 3 f32 steps per net
              on the card against the CPU (1e-4 relative). K1 and K2 must
              launch 0 times;
     demo    ``measure_demo_fps(40)`` through ``build_default_pipeline`` on
              480 x 640 synthetic camera frames (the committed detector
              weights, batch-1 packed steps): pipelined and serial fps, frame
              ms; ``process_demo`` + ``faces_from_packed`` against
              ``identify`` on two frames; both kernels held on the demo's
              inputs; and ``benchmark_transfer`` (a fresh uint8 upload per
              step) beside ``benchmark`` at bench.py's configuration;
  7. summary  one JSON line of kernels (time by CUDA events, the kernel's
              own device time and the wrapper's host time, plain version's
              time, library call's time, bound from this run's inputs,
              launches, error; K1 at three gallery sizes; K2 at forced
              tilings, each bit for bit), the card's name and power limit,
              and the result line.

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
# the CUDA cores (K2 and K1's f32 path), dense bf16 FLOP/s on the tensor
# cores (K1's bf16 path).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_TC_FLOPS = 989e12

FRAME_HW = (480, 640)
BATCH = 48
FACES = 8
SERVE_ROWS = 1024  # bench.py's default gallery capacity
MID_ROWS = 131072
BIG_ROWS = 1 << 20  # bench.py's production gallery capacity
MAX_NEAR_TIE_SHARE = 1e-3
TRAIN_EPOCHS = 6  # past the 5-epoch margin warmup
TRAIN_BAR = 0.5  # best val accuracy; chance is 1/16
TRAIN_STEP_RTOL = 1e-3  # card against CPU, f32
PRECISE_COS = 0.98  # fast against exact align within +-15 degrees (tests/test_ops.py)
FOLD_COS = 1e-3  # folded against unfolded embeddings, bf16
DEMO_FRAMES = 40
ZOO_TYPES = ("cnn", "attention", "hybrid", "siamese")
ZOO_EPOCHS = 3
ENSEMBLE_ATOL = 1e-5  # the average ensemble's logits against the mean of its members'
TUNE_EPOCHS = 2  # the LR-finder run and each CV fold
TUNE_FOLDS = 5
TUNE_TRIALS = 6
TUNE_TRIAL_EPOCHS = 3
SWEEP_STEPS = 3  # sweep steps held against the CPU (1-3 s each there)
ARCFACE_LR_CAP = 5e-4  # the LR finder's cap on its arcface suggestion
VIZ_COS = 0.9999  # f32 embeddings on the card against the CPU's
PREP_PERSONS = 6
PREP_PER_PERSON = 12
PREP_BATCH = 32  # BatchPreprocessor's default, the JAX package's
PREP_MIN_FOUND = 65  # of 72: 90%
AUG_ATOL = 1e-4  # apply_augment on the card against the CPU, f32 in [0, 1]
# The chosen face's box and landmarks, card against CPU, as a share of the
# box side: the cascade's bf16 crop weights turn last-bit f32 differences
# into sub-pixel box moves (0.48 px, 0.3% of the side, in the first runs)
PREP_DET_SHARE = 0.01
DET_SCENES = 150  # tests/test_detector.py's configuration (train_detector: 2,500)
DET_STEPS = 120  # (train_detector: 800)
DET_BATCH = 256
DET_AGREE_SCENES = 20
DET_AGREE_STEPS = 3
DET_RTOL = 1e-4  # train_net on the card against the CPU, f32


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


def _bound_ms(nbytes: float, flops: float, peak: float = F32_FLOPS) -> tuple[float, str]:
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def _unit(gen, rows, dim, dev):
    import torch

    x = torch.randn(rows, dim, generator=gen, device=dev)
    return x / x.norm(dim=1, keepdim=True)


def _k1_case(name, q, g, count, k, tol):
    """One K1 comparison. Returns (max abs error against the rounded-query
    plain version, near-tie slots, valid slots)."""
    import torch

    from facerec_torch.ops.gallery import gallery_topk, gallery_topk_plain

    cnt = torch.tensor(count, dtype=torch.int32, device=q.device)
    v1, i1 = gallery_topk(q, g, cnt, k=k)
    v0, i0 = gallery_topk_plain(q.to(g.dtype), g, cnt, k=k)
    vf, _ = gallery_topk_plain(q, g, cnt, k=k)
    torch.cuda.synchronize()
    nv = min(count, k)
    pad_ok = torch.equal(i1[:, nv:], i0[:, nv:]) and torch.equal(v1[:, nv:], v0[:, nv:])
    differ = i1[:, :nv] != i0[:, :nv]
    near, gap = int(differ.sum().item()), 0.0
    if near:
        s1 = (q.to(g.dtype).float()[:, None, :] * g[i1[:, :nv].long()].float()).sum(-1)
        gap = (s1 - v0[:, :nv]).abs()[differ].max().item()
    err = (v1 - v0)[:, :nv].abs().max().item() if nv else 0.0
    err_f = (v1 - vf)[:, :nv].abs().max().item() if nv else 0.0
    print(f"K1 {name}: B={q.shape[0]} G={g.shape[0]} {str(g.dtype)[6:]} count={count} k={k} "
          f"near_tie_slots={near}/{differ.numel()} (gap {gap:.3g}) masked_slots_exact={pad_ok} "
          f"max_abs_err={err:.3g} (tol 1e-5) vs_f32_queries={err_f:.3g} (tol {tol})", flush=True)
    if not (pad_ok and gap <= 1e-5 and err <= 1e-5 and err_f <= tol):
        bad = differ.any(dim=1).nonzero().flatten()[:3].tolist()
        raise AssertionError(f"K1 {name} disagrees with its plain version (rows {bad})")
    return err, near, differ.numel()


def check_k1(dev):
    """Phase 2. Returns (queries at the serve shape, the three timed
    galleries by rows, max abs error at the serve shape)."""
    import torch

    from facerec_torch.ops.gallery import bf16_rows_per_split, bf16_splits, gallery_topk

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(11)
    q = _unit(gen, BATCH * FACES, 512, dev)
    q37 = _unit(gen, 37, 512, dev)
    g_serve = _unit(gen, SERVE_ROWS, 512, dev).to(torch.bfloat16)
    g_big = _unit(gen, MID_ROWS, 512, dev).to(torch.bfloat16)
    g_huge = torch.empty(BIG_ROWS, 512, dtype=torch.bfloat16, device=dev)
    step = min(MID_ROWS, BIG_ROWS)  # in slices: no 2 GiB f32 temporary
    for r in range(0, BIG_ROWS, step):
        g_huge[r:r + step] = _unit(gen, step, 512, dev).to(torch.bfloat16)
    # identical rows across a split boundary and a tile boundary, each the
    # best match of one query: the lower row must come first
    g_ties, q_ties = g_big.clone(), q.clone()
    per = bf16_rows_per_split(100003, bf16_splits(q.shape[0], g_ties.shape[0], sms))
    pairs = [(per - 1, per), (2 * per - 1, 2 * per), (127, 128)]
    for n, (lo, hi) in enumerate(pairs):
        g_ties[hi] = g_ties[lo]
        q_ties[n] = g_ties[lo].float()
    # one 128-row tile in every split of the bf16 kernel at 384 queries
    split_edge = bf16_splits(q.shape[0], g_big.shape[0], sms) * 128
    cases = [("serve", q, g_serve, 512, 5, 2e-3), ("count<k", q, g_serve, 3, 5, 2e-3),
             ("count0", q, g_serve, 0, 5, 2e-3), ("f32", q, g_serve.float(), 512, 5, 1e-4),
             ("ragged131072", q, g_big, 100003, 5, 2e-3),
             ("ragged1048576", q, g_huge, BIG_ROWS // 2 - 1, 5, 2e-3),
             *[(f"tile_edge{c}", q, g_big, c, 5, 2e-3) for c in (127, 128, 129, 256, 257)],
             *[(f"split_edge{c}", q, g_big, c, 5, 2e-3)
               for c in (split_edge - 1, split_edge, split_edge + 1, 2 * split_edge + 1)],
             ("k1", q, g_big, 65536, 1, 2e-3), ("k32", q, g_big, 65536, 32, 2e-3),
             ("k32_count<k", q, g_serve, 20, 32, 2e-3), ("B37", q37, g_big, 100003, 5, 2e-3),
             ("B37_1048576", q37, g_huge, BIG_ROWS // 2 - 1, 5, 2e-3),
             ("split_ties", q_ties, g_ties, 100003, 5, 2e-3)]
    serve_err, near, slots = None, 0, 0
    for name, qq, g, count, k, tol in cases:
        err, n_near, n_slots = _k1_case(name, qq, g, count, k, tol)
        near, slots = near + n_near, slots + n_slots
        if name == "serve":
            serve_err = err
    _, i_ties = gallery_topk(q_ties, g_ties, 100003, k=2)
    got = [i_ties[n].tolist() for n in range(len(pairs))]
    print(f"K1 split_ties: pairs {pairs} came back as {got}", flush=True)
    if got != [list(p) for p in pairs]:
        raise AssertionError("K1 did not give exact ties to the lower row")
    print(f"K1 near-tie slots: {near} of {slots} ({near / slots:.2e}; limit "
          f"{MAX_NEAR_TIE_SHARE})", flush=True)
    if near > MAX_NEAR_TIE_SHARE * slots:
        raise AssertionError(f"K1 swapped {near} of {slots} slots against its plain version")
    return q, {SERVE_ROWS: g_serve, MID_ROWS: g_big, BIG_ROWS: g_huge}, serve_err


def _kernel_device_ms(fn, names: tuple[str, ...], iters: int = 20) -> float:
    """Device time per call of the CUDA kernels whose names contain one of
    ``names``, from torch.profiler over ``iters`` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if any(n in e.key for n in names)) / iters / 1e3


def _host_ms(fn, iters: int = 50) -> float:
    """Host time per call, the card left to catch up afterwards."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / iters * 1e3


def time_k1(q, galleries, k: int = 5) -> list[dict]:
    """K1 at the three gallery sizes, each half filled: kernel (CUDA events
    over back-to-back calls, the kernels' own device time, and the
    wrapper's host time per call), plain version, bound and two library
    yardsticks (a bf16 product with f32 output, and the f32 product;
    ``torch.topk`` after each)."""
    import torch

    from facerec_torch.ops.gallery import gallery_topk, gallery_topk_plain

    out = []
    for rows, g in galleries.items():
        count = rows // 2
        cnt = torch.tensor(count, dtype=torch.int32, device=q.device)
        b, dim = q.shape
        qb, gv = q.to(torch.bfloat16), g[:count]
        gf = gv.float()
        bound, by = _bound_ms(b * dim * 4 + count * dim * 2 + b * k * 8, 2.0 * b * count * dim,
                              BF16_TC_FLOPS)
        try:
            torch.mm(qb, gv.T, out_dtype=torch.float32)
            lib_kind = "topk(mm(bf16, bf16, out_dtype=f32))"

            def lib():
                return torch.topk(torch.mm(qb, gv.T, out_dtype=torch.float32), k)
        except (TypeError, RuntimeError) as e:
            print(f"torch.mm takes no out_dtype here ({str(e).splitlines()[0][:200]}); the "
                  "yardstick is a bf16 product", flush=True)
            lib_kind = "topk(mm(bf16, bf16).float())"

            def lib():
                return torch.topk(torch.mm(qb, gv.T).float(), k)
        iters = 50 if rows <= SERVE_ROWS else 20 if rows <= MID_ROWS else 10
        row = {"rows": rows, "count": count, "queries": b, "k": k,
               "l2": "warm (valid rows fit in the 50 MB L2)" if count * dim * 2 < 50e6 else
                     "cold (valid rows exceed the 50 MB L2)",
               "ms": _time_ms(lambda: gallery_topk(q, g, cnt, k=k), iters=iters),
               "host_ms": _host_ms(lambda: gallery_topk(q, g, cnt, k=k)),
               "device_ms": _kernel_device_ms(lambda: gallery_topk(q, g, cnt, k=k),
                                              ("topk_partial", "topk_merge")),
               "plain_ms": _time_ms(lambda: gallery_topk_plain(qb, g, cnt, k=k),
                                    iters=3 if rows > MID_ROWS else 10, warmup=1),
               "bound_ms": bound, "bound_by": by,
               "library_ms": _time_ms(lib, iters=iters), "library": lib_kind,
               "library_f32_ms": _time_ms(lambda: torch.topk(torch.matmul(q, gf.T), k),
                                          iters=iters)}
        del gf
        print("K1 time: " + json.dumps(row), flush=True)
        out.append(row)
    return out


K2_CASES = ("random", "zero", "tiny", "clamped", "capped")


def k2_case(case, angles, centers, p):
    """Rotation inputs of one K2 edge case, from drawn angles [N] and
    centres [N, 2]: "random" keeps them; "zero" sets the angles to 0; "tiny"
    to +-1e-7 rad about off-centre centres (lines whose fine base rounds up
    to 8); "clamped" beyond the +-15 degree clamp; "capped" puts the centres
    at and beyond the 0.1*P cap."""
    import torch

    dev = angles.device
    idx = torch.arange(angles.shape[0], device=dev)
    if case == "zero":
        angles = torch.zeros_like(angles)
    elif case == "tiny":
        angles = torch.where(idx % 2 == 0, 1e-7, -1e-7)
        centers = p * torch.tensor([[0.3, 0.62], [0.65, 0.4], [0.45, 0.3]], device=dev)[idx % 3]
    elif case == "clamped":
        angles = torch.tensor([0.27, -0.27, 0.6, -1.2], device=dev)[idx % 4]
    elif case == "capped":
        cp, cap = (p - 1) / 2.0, 0.1 * p
        centers = torch.tensor([[cp + cap, cp - cap], [cp - cap, cp + cap], [0.0, p - 1.0],
                                [p * 1.5, -p * 0.5]], device=dev)[idx % 4]
    elif case != "random":
        raise ValueError(f"no K2 case {case!r}")
    return angles, centers


def _k2_inputs(case, n, p, gen, dev):
    """Patches at 0..255, angles within +-15 degrees about centres near the
    middle (the serve shape's draw), then ``k2_case``."""
    import torch

    patches = (torch.rand(n, p, p, 3, generator=gen, device=dev) * 255).to(torch.bfloat16)
    angles = (torch.rand(n, generator=gen, device=dev) * 2 - 1) * math.radians(15.0)
    centers = p * (0.4 + 0.2 * torch.rand(n, 2, generator=gen, device=dev))
    return (patches, *k2_case(case, angles, centers, p))


def _k2_taps(angles, centers, p, max_angle_deg=15.0):
    from facerec_torch.ops.warp_fast import _shear_params

    max_rad = math.radians(max_angle_deg)
    sy, cy, sx, cx, ky, kx = _shear_params(angles.float().clamp(-max_rad, max_rad),
                                           centers.float(), p, max_rad)
    return (sy, cy, ky), (sx, cx, kx)


def fb8_lines(angles, centers, p) -> int:
    """Lines of both passes whose fine base rounds up to 8."""
    from facerec_torch.ops.warp_fast import COARSE, _shear_lines

    return sum(int((_shear_lines(s, c, p, -k, k)[1] == COARSE).sum().item())
               for s, c, k in _k2_taps(angles, centers, p))


def k2_read_mask(angles, centers, p, e, max_angle_deg=15.0):
    """[N, P, P] bool: the patch values that the centred E x E crop of the
    two-shear rotation reads. Crop row i reads the y pass's columns
    off + ox[i] .. off + E + ox[i]; column x of the y pass reads patch rows
    i + oy[x] and i + oy[x] + 1. Values outside the patch are zeros and read
    nothing."""
    import torch

    from facerec_torch.ops.warp_kernel import line_taps

    (sy, cy, ky), (sx, cx, kx) = _k2_taps(angles, centers, p, max_angle_deg)
    oy = line_taps(sy, cy, p, -ky, ky)[0].long()  # [N, P], by column
    ox = line_taps(sx, cx, p, -kx, kx)[0].long()  # [N, P], by row
    n, off, dev = oy.shape[0], (p - e) // 2, oy.device
    rows = torch.arange(off, off + e, device=dev)  # the crop's patch rows
    x = torch.arange(p, device=dev)
    first = off + ox[:, off:off + e, None]  # [N, E, 1]
    used = (x >= first) & (x <= first + e)  # [N, E, P]: row i's x pass reads column x
    mask = torch.zeros(n * p * p, dtype=torch.bool, device=dev)
    base = (torch.arange(n, device=dev) * p * p)[:, None, None] + x
    for tap in (0, 1):
        r = rows[None, :, None] + oy[:, None, :] + tap  # [N, E, P]
        ok = used & (r >= 0) & (r < p)
        mask[(base + r * p)[ok]] = True
    return mask.view(n, p, p)


def check_k2(dev):
    """Phase 3: K2 bit for bit against ``rotate_patches`` at the serve shape
    and the edge cases. Returns (inputs at the serve shape, max abs error
    over all cases)."""
    import torch

    from facerec_torch.ops.warp_kernel import rotate_patches_kernel
    from facerec_torch.ops.warp_fast import rotate_patches

    g0 = torch.Generator(device=dev).manual_seed(12)
    cases = [("serve", "random", BATCH * FACES, 208, 160), ("angle0", "zero", 64, 208, 160),
             ("angle1e-7", "tiny", 64, 208, 160), ("clamped", "clamped", 64, 208, 160),
             ("capped", "capped", 64, 208, 160), ("E==P", "random", 16, 208, 208),
             ("128to96", "random", 64, 128, 96), ("N1", "random", 1, 208, 160),
             ("N0", "random", 0, 208, 160)]
    serve_in, worst = None, 0.0
    for name, case, n, p, e in cases:
        patches, angles, centers = _k2_inputs(case, n, p, g0, dev)
        before = rotate_patches_kernel.launches
        got = rotate_patches_kernel(patches, angles, centers, e)
        ref = rotate_patches(patches, angles, centers, e)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item() if n else 0.0
        worst = max(worst, err)
        launched = rotate_patches_kernel.launches - before
        fb8 = fb8_lines(angles, centers, p) if n else 0
        ok = (got.shape == (n, e, e, 3) and torch.equal(got, ref) and launched == (1 if n else 0)
              and (case != "tiny" or fb8 > 0))
        print(f"K2 {name}: N={n} P={p} E={e} bit_exact={torch.equal(got, ref)} "
              f"max_abs_err={err:.3g} launches={launched} fb8_lines={fb8}", flush=True)
        if not ok:
            raise AssertionError(f"K2 {name} disagrees with its plain version")
        if name == "serve":
            serve_in = (patches, angles, centers, e)
    return serve_in, worst


def build_pipeline(dev, frame_hw, max_faces, dtype, batch_cfg, precise_align=False,
                   embedder: str = "arcface"):
    """bench.py's pipeline: the committed detector, and a full-width embedder
    from seed 1, the ResNet-18 ArcFace or (``embedder="facenet"``)
    InceptionResnetV1 (repeats 5, 10, 5; the VGGFace2 file is not in the
    repository)."""
    from facerec_torch.config import ServeConfig
    from facerec_torch.detect.mtcnn import MTCNN
    from facerec_torch.detect.weights import load_detector_params
    from facerec_torch.models.arcface import build_embedder
    from facerec_torch.models.facenet import build_facenet_embedder
    from facerec_torch.serve.pipeline import FacePipeline

    cfg = ServeConfig(max_faces=max_faces, detection_threshold=0.0, **batch_cfg)
    det = MTCNN(frame_hw, min_face_size=40, max_faces=max_faces, k_pnet=64, k_rnet=32,
                dtype=dtype, input_range="255", device=dev)
    det.load_jax_params(load_detector_params())
    build = {"arcface": build_embedder, "facenet": build_facenet_embedder}[embedder]
    emb = build(dtype=dtype, seed=1, device=dev)
    return FacePipeline(cfg, frame_hw, det, emb, embed_dim=512, device=dev,
                        precise_align=precise_align)


def small_input_agrees(dev, embedder: str = "arcface") -> None:
    """The port's step on 2 small frames, f32, on the card (kernels) and on
    the CPU (plain versions), with ``embedder``: same valid slots,
    embeddings within cosine 0.999, same top-1 matches."""
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
                              dict(gallery_capacity=16, top_k=3, embed_size=160), embedder=embedder)
        probe = pipe.process(frames).embeddings.reshape(-1, 512).cpu().numpy()
        g = gal.copy()
        g[[1, 5, 2, 6]] = probe + 0.02 * np.random.default_rng(4).normal(size=probe.shape)
        pipe.gallery.add_many(names, g)
        results.append(pipe.process(frames))
    a, b = ([t.cpu() for t in r] for r in results)
    va, vb = a[3], b[3]
    cos = (a[4] * b[4]).sum(-1)[va]
    same_top1 = torch.equal(a[6][..., 0][va], b[6][..., 0][vb])
    print(f"small input card vs cpu ({embedder}): valid {va.sum().item()}/{vb.sum().item()} "
          f"min_cos={cos.min().item():.6f} same_top1={same_top1}", flush=True)
    if not (torch.equal(va, vb) and va.any() and cos.min().item() > 0.999 and same_top1):
        raise AssertionError("the step on the card disagrees with the CPU step on a small input")


def _zero_launches() -> None:
    from facerec_torch.ops.gallery import gallery_topk
    from facerec_torch.ops.warp_kernel import rotate_patches_kernel

    gallery_topk.launches = 0
    rotate_patches_kernel.launches = 0


def _launches() -> dict:
    from facerec_torch.ops.gallery import gallery_topk
    from facerec_torch.ops.warp_kernel import rotate_patches_kernel

    return {"gallery_topk": gallery_topk.launches, "shear_rotate": rotate_patches_kernel.launches}


def hold_path_kernels(path: str, pipe, x, r) -> dict:
    """Each kernel a serve path launched, against its plain version on the
    inputs that path gave it: K1 on the step's embeddings, gallery and count
    (``_k1_case``'s bars); K2 (fast align only) bit for bit on the patches,
    angles and centres that the step's boxes and landmarks give. Returns the
    max abs error of each."""
    import torch

    from facerec_torch.ops.warp_fast import _align_prep, rotate_patches
    from facerec_torch.ops.warp_kernel import rotate_patches_kernel

    cfg = pipe.config
    q = r.embeddings.reshape(-1, r.embeddings.shape[-1]).float()
    err = {"gallery_topk": _k1_case(path, q, pipe.gallery.embeddings, pipe.gallery.count,
                                    cfg.top_k, 2e-3)[0]}
    if not pipe.precise_align:
        lm = torch.where(r.valid[..., None, None], r.landmarks, pipe._default_lmk)
        patches, angle, centers = _align_prep(x.float(), r.boxes, lm, cfg.embed_size, 0.15)
        args = (patches.reshape(-1, *patches.shape[2:]), angle.reshape(-1),
                centers.reshape(-1, 2), cfg.embed_size)
        got, ref = rotate_patches_kernel(*args), rotate_patches(*args)
        exact = torch.equal(got, ref)
        err["shear_rotate"] = (got.float() - ref.float()).abs().max().item()
        print(f"K2 {path}: N={args[0].shape[0]} P={args[0].shape[1]} bit_exact={exact}",
              flush=True)
        if not exact:
            raise AssertionError(f"K2 disagrees with its plain version on the {path} path")
    return err


def precise_agrees(pipe, frames, r) -> dict:
    """The precise step's result ``r`` against the fast path on the same
    frames: the same valid slots, and embedding cosine > ``PRECISE_COS`` for
    the faces whose eye angle lies within +-15 degrees."""
    import torch

    pipe.precise_align = False
    try:
        fast = pipe.process(frames)
    finally:
        pipe.precise_align = True
    lm = r.landmarks.float()
    angle = torch.rad2deg(torch.atan2(lm[..., 1, 1] - lm[..., 0, 1], lm[..., 1, 0] - lm[..., 0, 0]))
    held = r.valid & (angle.abs() <= 15.0)
    cos = (r.embeddings * fast.embeddings).sum(-1)[held]
    out = {"same_valid": bool(torch.equal(r.valid, fast.valid)), "faces_within_15deg": int(held.sum()),
           "faces_valid": int(r.valid.sum()), "min_cos": cos.min().item() if cos.numel() else None,
           "median_cos": cos.median().item() if cos.numel() else None}
    print("serve_precise against fast: " + json.dumps(out), flush=True)
    if not (out["same_valid"] and cos.numel() and out["min_cos"] > PRECISE_COS):
        raise AssertionError(f"the precise step disagrees with the fast path: {out}")
    return out


def serve(dev, frames, capacity: int, enroll, path: str, agree: bool = False,
          precise: bool = False, embedder: str = "arcface"):
    """Phases 4 and 5 (and serve_precise, serve_facenet): the serve step at
    bench.py's configuration with a bf16 gallery of ``capacity`` rows, half
    filled by ``enroll(pipe, n)``. Returns the kernels' launches in one
    step, step stats and the pipeline."""
    import numpy as np
    import torch

    pipe = build_pipeline(dev, FRAME_HW, FACES, torch.bfloat16,
                          dict(gallery_capacity=capacity, top_k=5, embed_size=160),
                          precise_align=precise, embedder=embedder)
    n_ids = capacity // 2
    t0 = time.perf_counter()
    enroll(pipe, n_ids)
    torch.cuda.synchronize()
    print(f"gallery {capacity} rows: enrolled {pipe.gallery.count} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    t0 = time.perf_counter()
    pipe.process(frames)  # first call: cuDNN autotuning, allocator warm-up
    torch.cuda.synchronize()
    print(f"first step {time.perf_counter() - t0:.2f} s", flush=True)

    _zero_launches()
    r = pipe.process(frames)
    torch.cuda.synchronize()
    launches = _launches()
    print(f"launches in one step ({path}, gallery {capacity} rows): {launches}", flush=True)
    # the exact warp takes the place of K2
    want = {"gallery_topk": 1, "shear_rotate": 0 if precise else 1}
    if launches != want:
        raise AssertionError(f"the {path} step launched {launches}, not {want}")

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

    x = pipe.upload(frames)
    held = hold_path_kernels(path, pipe, x, r)
    extra = {"kernels_held": held}
    if precise:
        extra["against_fast"] = precise_agrees(pipe, frames, r)
    if agree:
        small_input_agrees(dev, embedder)

    stats = pipe.benchmark(frames, iters=10, warmup=2)
    stages = stage_breakdown(pipe, x)
    busy = device_busy(lambda: pipe.step(x))
    return launches, dict(stats, embedder=embedder, gallery_rows=capacity,
                          gallery_count=pipe.gallery.count,
                          detected=found, detected_p090=found_090, detected_expected=expected,
                          stages_ms=stages, **busy, **extra), pipe


def enroll_host(rng):
    """Half the gallery from host normals, one upload (bench.py's small
    galleries)."""
    import numpy as np

    def enroll(pipe, n):
        pipe.gallery.add_many([f"id_{i}" for i in range(n)],
                              rng.normal(size=(n, 512)).astype(np.float32))
    return enroll


def enroll_device(seed: int):
    """Half the gallery from seeded normals made on the card and enrolled
    there (bench.py's production scale, ``add_many_device``)."""
    import torch

    def enroll(pipe, n):
        gen = torch.Generator(device=pipe.device).manual_seed(seed)
        pipe.gallery.add_many_device([f"id_{i}" for i in range(n)],
                                     torch.randn(n, 512, generator=gen, device=pipe.device))
    return enroll


def device_busy(step, steps: int = 3) -> dict:
    """Share of the wall time the card spends in kernels and copies over
    ``steps`` calls of ``step`` (torch.profiler; the profiler's own host
    cost lengthens the wall time, so the share is a lower bound), and the
    kernels that take the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # the train step's named parts (record_function) show on both timelines;
    # their spans are not kernel time
    parts = [e for e in prof.key_averages() if e.key.startswith("train_step.")]
    dev_events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not e.key.startswith("train_step.")]
    total_us = sum(e.self_device_time_total for e in dev_events)
    top = sorted(dev_events, key=lambda e: -e.self_device_time_total)[:8]
    out = {"device_busy_share": total_us / wall_us if total_us else None,
           "device_ms_per_step": total_us / steps / 1e3,
           "top_kernels_ms_per_step": {e.key[:80]: e.self_device_time_total / steps / 1e3
                                       for e in top}}
    if parts:  # host time of each part, under the profiler
        out["host_ms_per_step_by_part"] = {
            e.key: e.cpu_time_total / steps / 1e3 for e in parts
            if e.device_type == torch.autograd.DeviceType.CPU}
    print("profile: " + json.dumps(out), flush=True)
    return out


def stage_breakdown(pipe, x) -> dict:
    """CUDA-event time of each stage of the step, run alone on the step's
    own intermediate tensors."""
    import torch

    from facerec_torch.ops.arcface import l2_normalize
    from facerec_torch.ops.gallery import gallery_topk

    cfg = pipe.config
    with torch.no_grad():
        d = pipe.detector.detect(x)
        crops = pipe.align(x, d.boxes, d.landmarks)
        flat = crops.reshape(-1, cfg.embed_size, cfg.embed_size, 3)
        emb = l2_normalize(pipe.embedder.embed(flat).float())
        g, c = pipe.gallery.embeddings, pipe.gallery.count_device
        out = {
            "detect": _time_ms(lambda: pipe.detector.detect(x), iters=5, warmup=1),
            "align": _time_ms(lambda: pipe.align(x, d.boxes, d.landmarks), iters=5, warmup=1),
            "embed": _time_ms(lambda: pipe.embedder.embed(flat), iters=5, warmup=1),
            "match": _time_ms(lambda: gallery_topk(emb, g, c, k=cfg.top_k), iters=20),
        }
    print("stage ms: " + json.dumps(out), flush=True)
    return out


def randomize_batchnorm(model, seed: int) -> None:
    """tests/test_fold.py's statistics on every BatchNorm of ``model``
    (scale U(0.5, 1.5), bias N(0, 0.3), mean N(0, 0.5), var U(0.3, 2.0)),
    drawn on the host from ``seed``: a seeded embedder's BatchNorms are
    identities, which leave a fold nothing to do."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                n = m.num_features
                for t, v in ((m.weight, torch.rand(n, generator=gen) + 0.5),
                             (m.bias, torch.randn(n, generator=gen) * 0.3),
                             (m.running_mean, torch.randn(n, generator=gen) * 0.5),
                             (m.running_var, torch.rand(n, generator=gen) * 1.7 + 0.3)):
                    t.copy_(v)


def fold(pipes, frames, card: str) -> dict:
    """The fold phase: the embed stage alone, every BatchNorm folded into
    its producer (``models.fold.fold_batchnorm``) against unfolded, for the
    ArcFace of ``serve`` and the FaceNet of ``serve_facenet`` on each path's
    own 384 crops, bf16, after ``randomize_batchnorm``: CUDA-event ms in
    turns (unfolded, folded, folded, unfolded), each one's device ms and
    busy share (torch.profiler), and the embeddings' cosine, folded
    against unfolded (> 1 - FOLD_COS). Serving stays unfolded. The crops
    are made first (the serve step's detect and align, which launch K2);
    the launch counts are then set to 0 around the embed work, which must
    launch neither kernel. Returns the measurements and those counts."""
    import copy

    import torch

    from facerec_torch.models.fold import FoldedBias, fold_batchnorm

    paths = ("serve", "serve_facenet")
    crops_of = {}
    with torch.no_grad():
        for path in paths:
            pipe = pipes[path]
            x = pipe.upload(frames)
            d = pipe.detector.detect(x)
            crops_of[path] = pipe.align(x, d.boxes, d.landmarks).reshape(
                -1, pipe.config.embed_size, pipe.config.embed_size, 3)
    out = {}
    _zero_launches()
    for path in paths:
        size, crops = pipes[path].config.embed_size, crops_of.pop(path)
        unfolded = copy.deepcopy(pipes[path].embedder)
        randomize_batchnorm(unfolded, 7)
        folded = fold_batchnorm(unfolded)
        with torch.no_grad():
            cos = (unfolded.embed(crops).float() * folded.embed(crops).float()).sum(-1)
            ms = [_time_ms(lambda m=m: m.embed(crops), iters=10, warmup=2)
                  for m in (unfolded, folded, folded, unfolded)]
            busy = [device_busy(lambda m=m: m.embed(crops)) for m in (unfolded, folded)]
        out[path] = {"embedder": type(unfolded).__name__, "crops": crops.shape[0],
                     "gmac_per_crop": embed_macs(unfolded, size) / 1e9,
                     "batchnorms_folded": sum(isinstance(m, FoldedBias) for m in folded.modules()),
                     "unfolded_ms": [ms[0], ms[3]], "folded_ms": [ms[1], ms[2]],
                     "folded_over_unfolded": (ms[1] + ms[2]) / (ms[0] + ms[3]),
                     "device_ms_unfolded_folded": [b["device_ms_per_step"] for b in busy],
                     "busy_share_unfolded_folded": [b["device_busy_share"] for b in busy],
                     "min_cos": cos.min().item()}
        del unfolded, folded, crops
    launches = _launches()
    print("fold: " + json.dumps(out | {"launches": launches, "card": card}), flush=True)
    for path, r in out.items():
        if not r["min_cos"] > 1.0 - FOLD_COS:
            raise AssertionError(f"the folded {path} embedder disagrees with the unfolded: {r}")
    if any(launches.values()):
        raise AssertionError(f"the fold phase's embed stage launched a serve kernel: {launches}")
    return out, launches


def arcface_synth_config(epochs: int = TRAIN_EPOCHS):
    """The configuration ``outputs/checkpoints/arcface_synth`` was trained
    with, as its ``model_info.json`` records it, for ``epochs`` epochs."""
    from facerec_torch.config import TrainConfig

    info = json.loads((ROOT / "outputs/checkpoints/arcface_synth/model_info.json").read_text())
    return TrainConfig.from_dict(info["config"]).replace(epochs=epochs)


def embed_macs(model, image: int) -> int:
    """Multiply-adds of one image's ``embed`` through ``model``'s
    convolutions and dense layers at ``image`` px, from the layer shapes."""
    import torch
    import torch.nn as nn

    macs = 0

    def count(m, _, out):
        nonlocal macs
        if isinstance(m, nn.Conv2d):
            macs += out.numel() * (m.in_channels // m.groups) * m.kernel_size[0] * m.kernel_size[1]
        else:
            macs += out.numel() * m.in_features

    dev = next(model.parameters()).device
    hooks = [m.register_forward_hook(count) for m in model.modules()
             if isinstance(m, (nn.Conv2d, nn.Linear))]
    try:
        with torch.no_grad():
            model.embed(torch.zeros(1, image, image, 3, device=dev))
    finally:
        for h in hooks:
            h.remove()
    return macs


def train_flops_per_image(model, image: int) -> float:
    """FLOPs of one image's forward and backward through ``model`` at
    ``image`` px: 2 per multiply-add of every convolution, dense layer and
    the class-centre product, from the layer shapes, times 3 for the
    backward pass."""
    model.eval()  # the embeddings, without labels
    return 3.0 * 2 * (embed_macs(model, image) + model.arc_weight.numel())


def _no_dropout_model(model_type: str, num_classes: int = 16):
    """A full-width model of ``model_type`` with every dropout off (the
    rates the JAX models hard-code included)."""
    from facerec_torch.models import get_model
    from facerec_torch.models.arcface import ArcFaceNet

    if model_type == "arcface":
        arc = arcface_synth_config().arcface
        return ArcFaceNet(num_classes=num_classes, dropout_rate=0.0, margin=arc.margin,
                          scale=arc.scale, easy_margin=arc.easy_margin,
                          progressive_margin=arc.progressive_margin,
                          warmup_epochs=arc.warmup_epochs)
    net = get_model(model_type, num_classes=num_classes)
    if model_type == "siamese":
        net.dropout_rates = (0.0, 0.0)
    else:
        net.dropout_rate = 0.0
    if model_type == "hybrid":
        net.transformer.set_dropout(0.0)
    return net


def _step_batch(model_type: str) -> dict:
    """16 seeded faces of 64 px (8 people, 2 each) as a classification
    batch, or as 16 pairs (8 of the same person, 8 of two) for siamese."""
    import numpy as np

    from facerec_torch.data.datasets import _imagenet_normalize
    from facerec_torch.data.synthetic import make_synthetic_arrays

    classes = 8 if model_type == "siamese" else 16
    imgs, labels = make_synthetic_arrays(num_classes=classes, per_class=16 // classes, size=64,
                                         seed=3)
    x = _imagenet_normalize(imgs)
    mask = np.ones(len(labels), np.float32)
    if model_type != "siamese":
        return {"image": x, "label": labels, "mask": mask}
    a = np.argsort(labels, kind="stable")  # person-major
    b = np.concatenate([a[np.arange(8) ^ 1],  # the other face of the same person
                        a[(np.arange(8, 16) + 2) % 16]])  # a face of another person
    return {"image_a": x[a], "image_b": x[b], "mask": mask,
            "pair_label": (labels[a] == labels[b]).astype(np.int32)}


def train_step_agrees(dev, model_type: str = "arcface") -> dict:
    """One train step of ``model_type`` (f32, TF32 off, dropout 0) on the
    card and on the CPU from the same seeded weights and batch: loss and
    grad_norm within ``TRAIN_STEP_RTOL`` relative."""
    import torch

    from facerec_torch.train.state import create_train_state
    from facerec_torch.train.steps import make_train_step

    cfg = arcface_synth_config()
    batch = _step_batch(model_type)
    out = []
    for d in (dev, torch.device("cpu")):
        net = _no_dropout_model(model_type)
        state = create_train_state(net, cfg, model_type, d)
        state.epoch = 2.0
        m = make_train_step(model_type, "float32")(state, {k: torch.from_numpy(v).to(d)
                                                             for k, v in batch.items()})
        out.append({"loss": float(m["loss_sum"] / m["count"]), "grad_norm": float(m["grad_norm"]),
                    "params": [p.detach().cpu() for p in net.parameters()]})
    card, cpu = out
    res = {k: {"card": card[k], "cpu": cpu[k], "rel": abs(card[k] - cpu[k]) / abs(cpu[k])}
           for k in ("loss", "grad_norm")}
    res["max_param_diff"] = max((a - b).abs().max().item()
                                for a, b in zip(card["params"], cpu["params"]))
    print(f"train step card vs cpu ({model_type}): " + json.dumps(res), flush=True)
    if not all(res[k]["rel"] <= TRAIN_STEP_RTOL for k in ("loss", "grad_norm")):
        raise AssertionError(f"the train step on the card disagrees with the CPU step: {res}")
    return res


def time_train_step(state, batches, model_type: str = "arcface", compute_dtype: str = "bfloat16",
                    steps: int = 20, warmup: int = 5) -> dict:
    """The train step on device-resident distinct batches after warm-up:
    ms/step by CUDA events, and the busy share over 3 steps."""
    from facerec_torch.train.steps import make_train_step

    step = make_train_step(model_type, compute_dtype)
    i = 0

    def one():
        nonlocal i
        step(state, batches[i % len(batches)])
        i += 1

    ms = _time_ms(one, iters=steps, warmup=warmup)
    return {"ms_per_step": ms, **device_busy(one)}


def loader_images_per_s(index, cfg) -> dict:
    """One pass of each batcher alone over ``index``, native then PIL, in
    images/s (wall clock; the native one only where its library loaded)."""
    from facerec_torch.data import native_loader
    from facerec_torch.data.datasets import ClassificationBatcher

    kinds = [("pil", ClassificationBatcher)]
    if native_loader.available():
        kinds.insert(0, ("native", native_loader.NativeClassificationBatcher))
    out = {}
    for name, cls in kinds:
        batcher = cls(index, cfg.batch_size, cfg.image_size, seed=cfg.seed)
        t0 = time.perf_counter()
        n = sum(int(b["mask"].sum()) for b in batcher.epoch(0))
        out[name] = n / (time.perf_counter() - t0)
    print("loader alone, images/s: " + json.dumps(out), flush=True)
    return out


def evaluate(dev, root: Path, checkpoints: Path, model_name: str, cfg, out_dir: Path) -> dict:
    """The eval phase: ``evaluate_model`` on the train phase's checkpoint
    and test split, then ``predict_image`` on 8 of its images."""
    import torch

    from facerec_torch.config import EvalConfig
    from facerec_torch.data.datasets import ImageFolderIndex
    from facerec_torch.eval.engine import evaluate_model, predict_image

    ecfg = EvalConfig(model_type="arcface", model_name=model_name, image_size=cfg.image_size)
    _zero_launches()
    t0 = time.perf_counter()
    res = evaluate_model(ecfg, root, checkpoints_root=checkpoints, outputs_root=out_dir,
                         return_predictions=True, device=dev)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    launches = _launches()
    index = ImageFolderIndex.build(root / "test")
    yhat = res["_predictions"]["yhat"]
    picks = list(range(0, len(index), max(len(index) // 8, 1)))[:8]
    pred = [predict_image(index.paths[i], ecfg, index.class_names, checkpoints_root=checkpoints,
                          device=dev)["predicted_class"] for i in picks]
    agree = [p == index.class_names[yhat[i]] for p, i in zip(pred, picks)]
    stats = {"route": "evaluate_model + predict_image", "compute_dtype": ecfg.compute_dtype,
             "batch_size": ecfg.batch_size, "test_images": res["num_test_images"],
             "accuracy": res["accuracy"], "roc_auc": res["roc_auc"], "f1": res["f1"],
             "ms_per_batch": res["avg_inference_time_ms"],
             "images_per_s": res["throughput_imgs_per_sec"], "evaluate_model_s": eval_s,
             "predict_image_agrees": f"{sum(agree)}/{len(agree)}",
             "launches_of_port_kernels": launches}
    if not (res["accuracy"] >= TRAIN_BAR and all(agree) and len(agree) == 8):
        raise AssertionError(f"evaluation failed: accuracy {res['accuracy']} (bar {TRAIN_BAR}), "
                             f"predict_image agreed on {sum(agree)}/{len(agree)}")
    return stats


def train(dev, card: str) -> tuple[dict, dict, dict, dict]:
    """Phase 6: the trainer at the arcface_synth configuration, then the
    eval phase on its checkpoint, then the zoo and tune phases beside it,
    in one temporary directory. Returns (train stats, eval stats, zoo
    stats, tune stats)."""
    import tempfile

    import PIL
    import torch

    from facerec_torch.data.native_loader import NativeClassificationBatcher
    from facerec_torch.data.synthetic import write_synthetic_imagefolder
    from facerec_torch.train.engine import _make_batchers, _run_epoch, train_model
    from facerec_torch.train.steps import make_train_step

    cfg = arcface_synth_config()
    with tempfile.TemporaryDirectory(prefix="facerec_train_") as td:
        t0 = time.perf_counter()
        root = write_synthetic_imagefolder(Path(td) / "ds", num_classes=16, per_class=40,
                                           size=cfg.image_size, seed=0)
        print(f"train: wrote 16 x 40 faces of {cfg.image_size} px in "
              f"{time.perf_counter() - t0:.1f} s (Pillow {PIL.__version__})", flush=True)
        batcher = _make_batchers(root, cfg)[0]["train"]  # the trainer's own choice
        loader = "native" if isinstance(batcher, NativeClassificationBatcher) else "pil"
        print(f"train: the trainer loads with the {loader} batcher", flush=True)
        _zero_launches()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        out = train_model(cfg, root, checkpoints_root=Path(td) / "checkpoints",
                          model_name="arcface_synth_torch", device=dev)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev)
        hist = out["history"]
        launches = _launches()
        print("train: epochs " + json.dumps([{k: r[k] for k in (
            "epoch", "train_loss", "train_acc", "val_loss", "val_acc", "lr", "time_elapsed")}
            for r in hist]), flush=True)
        if not (len(hist) == cfg.epochs and out["best_val_acc"] >= TRAIN_BAR
                and hist[-1]["train_acc"] > hist[0]["train_acc"]
                and all(math.isfinite(r["train_loss"]) for r in hist)):
            raise AssertionError(f"the arcface_synth configuration did not learn: best val acc "
                                 f"{out['best_val_acc']} (bar {TRAIN_BAR}), train acc "
                                 f"{hist[0]['train_acc']} -> {hist[-1]['train_acc']}")

        state = out["state"]
        index = batcher.index
        alone = loader_images_per_s(index, cfg)
        batches = [{k: torch.from_numpy(v).to(dev) for k, v in b.items()}
                   for b in batcher.epoch(0)]
        timed = time_train_step(state, batches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _run_epoch(make_train_step("arcface", cfg.compute_dtype), state, batcher, dev, 0, True,
                   prefetch=cfg.prefetch_depth)
        epoch_s = time.perf_counter() - t0
        del batches
        eval_stats = evaluate(dev, root, Path(td) / "checkpoints", "arcface_synth_torch", cfg,
                              Path(td) / "eval")
        torch.cuda.empty_cache()
        zoo_stats = zoo(dev, root, Path(td) / "checkpoints", Path(td) / "eval", card)
        torch.cuda.empty_cache()
        tune_stats = tune(dev, root, Path(td) / "checkpoints", Path(td), card)
    agree = train_step_agrees(dev)
    flops = train_flops_per_image(state.model, cfg.image_size) * cfg.batch_size
    tflops = flops / (timed["ms_per_step"] * 1e-3) / 1e12
    stats = {
        "route": f"write_synthetic_imagefolder + train_model ({type(batcher).__name__})",
        "loader": loader,
        "epochs": len(hist), "steps": state.step, "best_val_acc": out["best_val_acc"],
        "test_acc": out.get("test_acc"), "train_acc_first_last": [hist[0]["train_acc"],
                                                                  hist[-1]["train_acc"]],
        "train_model_s": train_s, "epoch_s": [r["time_elapsed"] for r in hist],
        "ms_per_step": timed["ms_per_step"],
        "images_per_s": cfg.batch_size / (timed["ms_per_step"] * 1e-3),
        "gflop_per_step": flops / 1e9, "model_tflops": tflops,
        "bf16_peak_share": tflops / (BF16_TC_FLOPS / 1e12),
        "epoch_images_per_s_with_loading": len(index) / epoch_s,
        "loader_alone_images_per_s": alone,
        "device_busy_share": timed["device_busy_share"],
        "device_ms_per_step": timed["device_ms_per_step"],
        "host_ms_per_step_by_part": timed.get("host_ms_per_step_by_part"),
        "top_kernels_ms_per_step": timed["top_kernels_ms_per_step"],
        "peak_memory_gb": peak / 2**30, "launches_of_port_kernels": launches,
        "card_vs_cpu": {k: agree[k]["rel"] for k in ("loss", "grad_norm")},
    }
    return stats, eval_stats, zoo_stats, tune_stats


def zoo_config(model_type: str):
    """The arcface_synth configuration (optimizer, schedule, 160 px, batch
    32, bf16 compute) with ``model_type`` swapped in, for ``ZOO_EPOCHS``."""
    return arcface_synth_config(ZOO_EPOCHS).replace(model_type=model_type)


def zoo_train(dev, model_type: str, root: Path, checkpoints: Path) -> dict:
    """``train_model`` on one zoo type; then its step on device-resident
    batches of the train split (CUDA events), the busy share and the peak
    memory. Raises if a loss is non-finite or the last epoch's train loss
    is not below the first's."""
    import torch

    from facerec_torch.train.engine import _make_batchers, train_model

    cfg = zoo_config(model_type)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    out = train_model(cfg, root, checkpoints_root=checkpoints, model_name=f"{model_type}_zoo",
                      device=dev)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    hist = out["history"]
    keys = ("epoch", "train_loss", "train_acc", "val_loss", "val_acc") + (
        ("same_acc", "diff_acc") if model_type == "siamese" else ())
    epochs = [{k: r[k] for k in keys} for r in hist]
    if not (len(hist) == cfg.epochs and all(math.isfinite(r["train_loss"]) for r in hist)
            and hist[-1]["train_loss"] < hist[0]["train_loss"]):
        raise AssertionError(f"zoo {model_type}: the loss did not fall or is not finite: {epochs}")
    batcher = _make_batchers(root, cfg)[0]["train"]
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in b.items()} for b in batcher.epoch(0)]
    timed = time_train_step(out["state"], batches, model_type, cfg.compute_dtype)
    del batches
    unit = "pairs_per_s" if model_type == "siamese" else "images_per_s"
    return {"model_type": model_type, "image_size": cfg.image_size,
            "batch_size": cfg.batch_size, "epochs": epochs, "best_val_acc": out["best_val_acc"],
            "test_acc": out.get("test_acc"), "train_model_s": train_s,
            "steps": out["state"].step, "ms_per_step": timed["ms_per_step"],
            unit: cfg.batch_size / (timed["ms_per_step"] * 1e-3),
            "device_busy_share": timed["device_busy_share"],
            "device_ms_per_step": timed["device_ms_per_step"],
            "top_kernels_ms_per_step": timed["top_kernels_ms_per_step"],
            "peak_memory_gb": peak / 2**30,
            "parameters": out["summary"]["parameters"]["total"]}


def zoo_evaluate(dev, model_type: str, root: Path, checkpoints: Path, out_dir: Path,
                 model=None) -> dict:
    """``evaluate_model`` on a zoo checkpoint (or on ``model``) and the test
    split, at the default bf16 compute: the classifier branch, or the
    siamese branch on fixed pairs."""
    from facerec_torch.config import EvalConfig
    from facerec_torch.eval.engine import evaluate_model

    ecfg = EvalConfig(model_type=model_type, model_name=f"{model_type}_zoo",
                      image_size=zoo_config(model_type).image_size)
    res = evaluate_model(ecfg, root, checkpoints_root=checkpoints, outputs_root=out_dir,
                         return_predictions=True, device=dev, model=model)
    out = {"eval_accuracy": res["accuracy"], "eval_roc_auc": res["roc_auc"],
           "eval_ms_per_batch": res["avg_inference_time_ms"], "eval_batch": ecfg.batch_size,
           "eval_items": len(res["_predictions"]["y"])}
    if model_type == "siamese":
        out |= {"eval_same_accuracy": res["same_accuracy"],
                "eval_diff_accuracy": res["diff_accuracy"]}
    if not 0.0 <= res["accuracy"] <= 1.0:
        raise AssertionError(f"zoo {model_type}: evaluation failed: {res['accuracy']}")
    return out


def ensemble_agrees(ens, root: Path, dev) -> float:
    """The average ensemble's logits (f32) on one test batch against the
    mean of its members' own logits: the largest difference."""
    import numpy as np
    import torch

    from facerec_torch.data.datasets import ClassificationBatcher, ImageFolderIndex

    cfg = zoo_config("ensemble")
    b = next(iter(ClassificationBatcher(ImageFolderIndex.build(root / "test"), cfg.batch_size,
                                        cfg.image_size, shuffle=False).epoch(0)))
    x = torch.from_numpy(np.ascontiguousarray(b["image"])).to(dev)
    ens = ens.to(dev).eval()
    with torch.no_grad():
        zeros = torch.zeros(len(x), dtype=torch.long, device=dev)
        members = [m(x, labels=zeros) if t == "arcface" else m(x)
                   for m, t in zip(ens.members, ens.member_types)]
        err = (ens(x) - torch.stack(members).float().mean(0)).abs().max().item()
    if not err <= ENSEMBLE_ATOL:
        raise AssertionError(f"the ensemble's logits are not its members' mean: {err}")
    return err


def zoo(dev, root: Path, checkpoints: Path, out_dir: Path, card: str) -> dict:
    """The zoo phase, on the train phase's tree and beside its ArcFace
    checkpoint: train each of ``ZOO_TYPES``, hold one f32 step of each on
    the card against the CPU, evaluate each checkpoint, then the default
    ensemble (cnn + attention + the train phase's ArcFace) built by
    ``create_pretrained_ensemble``. Neither kernel lies on this path: their
    launches are counted over the phase and must be 0."""
    import torch

    from facerec_torch.models.ensemble import create_pretrained_ensemble

    _zero_launches()
    t0 = time.perf_counter()
    rows = {}
    for mt in ZOO_TYPES:
        rows[mt] = zoo_train(dev, mt, root, checkpoints)
        torch.cuda.empty_cache()
    for mt in ZOO_TYPES:
        rows[mt]["card_vs_cpu"] = {k: v["rel"] for k, v in train_step_agrees(dev, mt).items()
                                   if k in ("loss", "grad_norm")}
        rows[mt] |= zoo_evaluate(dev, mt, root, checkpoints, out_dir)
    ens = create_pretrained_ensemble({"cnn": "cnn_zoo", "attention": "attention_zoo",
                                      "arcface": "arcface_synth_torch"}, 16,
                                     checkpoints_root=checkpoints)
    err = ensemble_agrees(ens, root, dev)
    rows["ensemble"] = {"model_type": "ensemble", "members": ens.member_types,
                        "method": ens.ensemble_method, "mean_of_members_max_err": err,
                        **zoo_evaluate(dev, "ensemble", root, checkpoints, out_dir, model=ens)}
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _launches()
    for row in rows.values():
        print("zoo: " + json.dumps(row | {"card": card}), flush=True)
    if any(launches.values()):
        raise AssertionError(f"the zoo path launched a serve kernel: {launches}")
    return {"seconds": seconds, "launches_of_port_kernels": launches, "types": list(rows)}


def sweep_agrees(dev, batcher) -> dict:
    """``SWEEP_STEPS`` steps of the arcface LR sweep (f32, dropout 0) on the
    card and on the CPU from the same seeded weights on the same batches of
    ``batcher``: the same LRs, losses within ``TRAIN_STEP_RTOL`` relative."""
    import itertools

    import torch

    from facerec_torch.train.lr_finder import LearningRateFinder
    from facerec_torch.train.state import create_train_state, set_hyperparam
    from facerec_torch.train.steps import make_train_step

    cfg = arcface_synth_config()
    batches = list(itertools.islice(batcher.epoch(0), SWEEP_STEPS))
    runs = []
    for d in (dev, torch.device("cpu")):
        state = create_train_state(_no_dropout_model("arcface"), cfg, "arcface", d)
        finder = LearningRateFinder("arcface", num_steps=SWEEP_STEPS)
        finder.find(state, make_train_step("arcface", "float32"),
                    ({k: torch.from_numpy(v).to(d) for k, v in b.items()} for b in batches),
                    lambda os, lr: set_hyperparam(os, "learning_rate", lr))
        runs.append(finder)
    card, cpu = runs
    rel = [abs(a - b) / abs(b) for a, b in zip(card.losses, cpu.losses)]
    res = {"lrs": card.lrs, "card_losses": card.losses, "cpu_losses": cpu.losses,
           "max_rel": max(rel) if rel else None}
    print("tune: sweep card vs cpu: " + json.dumps(res), flush=True)
    if not (card.lrs == cpu.lrs and len(rel) == SWEEP_STEPS and max(rel) <= TRAIN_STEP_RTOL):
        raise AssertionError(f"the LR sweep on the card disagrees with the CPU's: {res}")
    return res


def tune_lr_finder(dev, root: Path, checkpoints: Path) -> dict:
    """``train_model`` with the LR-finder pre-pass at the arcface_synth
    configuration for ``TUNE_EPOCHS`` epochs: a valid, finite suggestion at
    most the arcface cap, and the schedule started from it. The pre-pass is
    timed by wrapping the engine's own function."""
    import torch

    from facerec_torch.train import engine
    from facerec_torch.train.schedulers import get_scheduler

    cfg = arcface_synth_config(TUNE_EPOCHS).replace(use_lr_finder=True)
    timed = {}
    prepass = engine._lr_finder_prepass

    def timed_prepass(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return prepass(*args, **kwargs)
        finally:
            torch.cuda.synchronize()
            timed["s"] = time.perf_counter() - t0

    engine._lr_finder_prepass = timed_prepass
    try:
        t0 = time.perf_counter()
        out = engine.train_model(cfg, root, checkpoints_root=checkpoints, model_name="arcface_lrf",
                                 device=dev)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
    finally:
        engine._lr_finder_prepass = prepass
    a = json.loads((checkpoints / "arcface_lrf" / "metrics" / "lr_finder.json").read_text())
    hist = out["history"]
    s = a["suggested_lr"]
    first_lr = get_scheduler(cfg.scheduler, s, cfg.epochs).step()
    stats = {"suggested_lr": s, "max_lr": a["max_lr"], "valid": a["valid"],
             "steps_swept": len(a["lrs"]), "sweep_s": timed["s"],
             "ms_per_sweep_step": timed["s"] * 1e3 / max(len(a["lrs"]), 1),
             "train_losses": [r["train_loss"] for r in hist], "lrs": [r["lr"] for r in hist],
             "val_acc": [r["val_acc"] for r in hist], "train_model_s": train_s}
    print("tune: lr finder " + json.dumps(stats), flush=True)
    if not (a["valid"] and math.isfinite(s) and 0.0 < s <= ARCFACE_LR_CAP
            and hist and hist[0]["lr"] == first_lr
            and all(math.isfinite(r["train_loss"]) for r in hist)):
        raise AssertionError(f"the LR finder did not give a valid suggestion the run started "
                             f"from: {stats} (first lr expected {first_lr})")
    return stats


def tune_cv(dev, root: Path, checkpoints: Path) -> dict:
    """``run_cross_validation`` at the arcface_synth configuration, warm
    started from the train phase's checkpoint: ``TUNE_FOLDS`` folds whose
    validation rows partition the train split, a finite mean and std."""
    import numpy as np

    from facerec_torch.data.datasets import ImageFolderIndex
    from facerec_torch.train.cross_validation import kfold_indices, run_cross_validation

    t0 = time.perf_counter()
    res = run_cross_validation(arcface_synth_config(), root, n_splits=TUNE_FOLDS,
                               epochs_per_fold=TUNE_EPOCHS, warm_start_model="arcface_synth_torch",
                               checkpoints_root=checkpoints, device=dev)
    cv_s = time.perf_counter() - t0
    n = len(ImageFolderIndex.build(root / "train"))
    rows = np.sort(np.concatenate([va for _, va in kfold_indices(n, TUNE_FOLDS, seed=42)]))
    written = json.loads(next(checkpoints.glob("cv_arcface_*/cv_results.json")).read_text())
    stats = {"folds": [{k: f[k] for k in ("fold", "val_acc", "time_sec")}
                       for f in res["fold_results"]],
             "mean_val_acc": written["mean_val_acc"], "std_val_acc": written["std_val_acc"],
             "train_images": n, "cv_s": cv_s}
    print("tune: cv " + json.dumps(stats), flush=True)
    if not (len(res["fold_results"]) == TUNE_FOLDS and np.array_equal(rows, np.arange(n))
            and math.isfinite(written["mean_val_acc"]) and math.isfinite(written["std_val_acc"])):
        raise AssertionError(f"cross-validation failed: {stats}")
    return stats


def tune_hyperopt(dev, root: Path, work: Path) -> dict:
    """``python -m facerec_torch.cli.main hyperopt`` as a user types it, in
    a subprocess with ``FACEREC_ROOT`` set to ``work``, on ``dev``: exit 0,
    every trial COMPLETE or PRUNED (no FAIL), the artifacts written, a valid
    pre-pass, and each trial's parameters those a host replay of the study
    draws."""
    import os

    from facerec_torch.config import TuningConfig
    from facerec_torch.train.tuning import Study

    storage = work / "study.sqlite"
    cmd = [sys.executable, "-m", "facerec_torch.cli.main", "--device", dev.type, "hyperopt",
           "--model-type", "arcface", "--dataset", str(root), "--trials", str(TUNE_TRIALS),
           "--epochs", str(TUNE_TRIAL_EPOCHS), "--lr-finder", "--storage", str(storage)]
    t0, wall0 = time.perf_counter(), time.time()
    proc = subprocess.run(cmd, cwd=ROOT, env=dict(os.environ, FACEREC_ROOT=str(work)),
                          capture_output=True, text=True, timeout=600)
    sub_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"hyperopt exited {proc.returncode}: {proc.stderr[-4000:]}")
    out_dir = next((work / "outputs" / "hyperopt").glob("arcface_*"))
    summary = json.loads((out_dir / "results.json").read_text())
    prepass = json.loads((out_dir / "lr_finder.json").read_text())
    trials = summary["trials"]
    tcfg = TuningConfig(model_type="arcface", study_name="arcface_study")
    replay = Study(tcfg.study_name, None, seed=tcfg.seed)
    center = float(prepass["suggested_lr"]) if prepass.get("valid") else None
    drawn = [replay.suggest("arcface", i, tcfg.use_trial0_baseline, lr_center=center,
                            lr_span=tcfg.lr_finder_span, sampler=tcfg.sampler)
             for i in range(TUNE_TRIALS)]
    stats = {"subprocess_s": sub_s, "split_s": hyperopt_split(proc.stderr, wall0, sub_s),
             "prepass": {k: prepass.get(k) for k in ("valid", "suggested_lr", "max_lr")},
             "trials": trials, "best_value": summary["best_value"],
             "params_equal_replay": [t["params"] == d for t, d in zip(trials, drawn)],
             "summary_written": (out_dir / "study_summary.txt").exists()}
    for t in trials:
        print("tune: trial " + json.dumps(t), flush=True)
    print(f"tune: hyperopt subprocess {sub_s:.1f} s, split {json.dumps(stats['split_s'])}, "
          f"pre-pass {json.dumps(stats['prepass'])}", flush=True)
    if not (len(trials) == TUNE_TRIALS and all(t["state"] != "FAIL" for t in trials)
            and prepass.get("valid") and stats["summary_written"] and storage.exists()
            and all(stats["params_equal_replay"])):
        raise AssertionError(f"hyperopt failed: {json.dumps(stats)}\n{proc.stderr[-4000:]}")
    return stats


def hyperopt_split(log: str, wall0: float, total_s: float) -> dict:
    """Where the hyperopt command's seconds went, from the timestamps of
    its own log lines: start-up with the LR pre-pass (up to the pre-pass's
    line), each trial (up to its result line), and the rest."""
    import datetime

    marks = []
    for line in log.splitlines():
        if "LR finder suggests" in line or " COMPLETE " in line or " PRUNED " in line:
            stamp = datetime.datetime.strptime(line[:23], "%Y-%m-%d %H:%M:%S,%f").timestamp()
            marks.append(stamp - wall0)
    steps = [b - a for a, b in zip([0.0] + marks, marks)]
    return {"startup_and_prepass": steps[0] if steps else None, "trials": steps[1:],
            "after_last_trial": total_s - marks[-1] if marks else None}


def tune_visualize(dev, root: Path, checkpoints: Path, work: Path) -> dict:
    """``generate_visualization_report`` on the train phase's ArcFace
    checkpoint over the test split (224 px, as the command loads them), the
    projection this machine takes, and 32 f32 embeddings on the card
    against the CPU's (cosine); then ``main(["check-gpu"])``."""
    import numpy as np
    import torch

    from facerec_torch.cli.main import main as cli_main
    from facerec_torch.data.datasets import ImageFolderIndex
    from facerec_torch.eval.engine import _load_model_for_eval
    from facerec_torch.eval.visualizer import (
        EmbeddingVisualizer,
        generate_visualization_report,
        projection_kind,
    )

    t0 = time.perf_counter()
    model = _load_model_for_eval("arcface", "arcface_synth_torch", 16, checkpoints, dev)
    res = generate_visualization_report(model, "arcface", root / "test", out_dir=work / "viz",
                                        device=dev)
    viz_s = time.perf_counter() - t0
    index = ImageFolderIndex.build(root / "test")
    embs = []
    for d in (dev, torch.device("cpu")):
        m = _load_model_for_eval("arcface", "arcface_synth_torch", 16, checkpoints, d)
        embs.append(EmbeddingVisualizer(m, "arcface", 224, max_samples=32, compute_dtype="float32",
                                        device=d).extract_embeddings(index)[0])
    a, b = embs
    cos = (a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))
    rc = cli_main(["check-gpu"])
    stats = {"num_embeddings": res["num_embeddings"], "projection": projection_kind(),
             "card_vs_cpu_min_cos": float(cos.min()), "visualize_s": viz_s, "check_gpu_rc": rc,
             "files": sorted(Path(v).name for k, v in res.items()
                             if k.startswith(("tsne", "similarity")))}
    print("tune: visualize " + json.dumps(stats), flush=True)
    if not (res["num_embeddings"] == len(index) and cos.min() > VIZ_COS and rc == 0
            and len(stats["files"]) == 3):
        raise AssertionError(f"the visualizer failed: {stats}")
    return stats


def tune(dev, root: Path, checkpoints: Path, work: Path, card: str) -> dict:
    """The tune phase, on the train phase's tree beside its checkpoints:
    the LR finder through ``train_model`` and 3 of its steps against the
    CPU, cross-validation, the tuner through the command line, the
    visualizer and ``check-gpu``. Neither kernel lies on this path: their
    launches are counted over the phase and must be 0."""
    import torch

    from facerec_torch.data.datasets import ClassificationBatcher, ImageFolderIndex

    _zero_launches()
    t0 = time.perf_counter()
    stats = {"lr_finder": tune_lr_finder(dev, root, checkpoints)}
    cfg = arcface_synth_config()
    batcher = ClassificationBatcher(ImageFolderIndex.build(root / "train"), cfg.batch_size,
                                    cfg.image_size, seed=cfg.seed)
    stats["sweep_card_vs_cpu"] = sweep_agrees(dev, batcher)
    torch.cuda.empty_cache()
    stats["cv"] = tune_cv(dev, root, checkpoints)
    torch.cuda.empty_cache()
    stats["hyperopt"] = tune_hyperopt(dev, root, work)
    stats["visualize"] = tune_visualize(dev, root, checkpoints, work)
    torch.cuda.synchronize()
    stats["seconds"] = time.perf_counter() - t0
    stats["launches_of_port_kernels"] = _launches()
    print("tune: " + json.dumps({k: stats[k] for k in ("seconds", "launches_of_port_kernels")}
                                | {"lr_finder": {k: stats["lr_finder"][k] for k in (
                                       "suggested_lr", "max_lr", "steps_swept",
                                       "ms_per_sweep_step", "sweep_s", "train_model_s")},
                                   "sweep_max_rel": stats["sweep_card_vs_cpu"]["max_rel"],
                                   "cv_s": stats["cv"]["cv_s"],
                                   "cv_mean_val_acc": stats["cv"]["mean_val_acc"],
                                   "hyperopt_s": stats["hyperopt"]["subprocess_s"],
                                   "hyperopt_best": stats["hyperopt"]["best_value"],
                                   "visualize": stats["visualize"], "card": card}), flush=True)
    if any(stats["launches_of_port_kernels"].values()):
        raise AssertionError(f"the tune path launched a serve kernel: "
                             f"{stats['launches_of_port_kernels']}")
    return stats


def _raw_tree(root: Path) -> list:
    """``PREP_PERSONS`` x ``PREP_PER_PERSON`` JPEG photos (quality 95) of one
    rendered face each, ``face_frames`` at 480 x 640 from rng(0), under
    ``root/ds0/person_<p>/``; returns the decoded uint8 photos in file
    order."""
    import numpy as np
    from PIL import Image

    from facerec_torch.data.synthetic import face_frames

    frames = face_frames(PREP_PERSONS * PREP_PER_PERSON, FRAME_HW, 1, np.random.default_rng(0))
    photos = []
    for i, f in enumerate(frames.astype(np.uint8)):
        d = root / "ds0" / f"person_{i // PREP_PER_PERSON:02d}"
        d.mkdir(parents=True, exist_ok=True)
        Image.fromarray(f).save(d / f"img_{i % PREP_PER_PERSON:03d}.jpg", quality=95)
        with Image.open(d / f"img_{i % PREP_PER_PERSON:03d}.jpg") as im:
            photos.append(np.asarray(im.convert("RGB"), np.uint8))
    return photos


def prep_breakdown(pre, photos) -> dict:
    """ms of each stage of ``process_batch`` over ``photos``
    (``utils.profiling.StageTimer``, each stage synchronised on its
    result): the host letterbox, the upload, detect, align and crop, the
    read-back."""
    import torch

    from facerec_torch.utils.profiling import StageTimer

    timer = StageTimer()
    with timer.stage("letterbox"):
        batch = pre.frames(photos)
    for s in range(0, len(batch), pre.batch_size):
        with timer.stage("upload") as box:
            box["result"] = chunk = torch.from_numpy(batch[s:s + pre.batch_size]).to(pre.device)
        with timer.stage("detect") as box:
            box["result"] = det = pre.detector.detect(chunk)
        with timer.stage("align") as box:
            box["result"] = crops = pre.crops(chunk, det)
        with timer.stage("readback"):
            crops.cpu().numpy()
    return {k: v["total_sec"] * 1e3 for k, v in timer.summary().items()}


def prep_agrees(pre, photos) -> dict:
    """The card's ``process_batch`` against the CPU's on ``photos`` (4):
    end to end (uint8 levels), the chosen face's box and landmarks (px,
    and as a share of the box side), and the crops the card makes from the
    CPU's detections against the CPU's crops."""
    import numpy as np
    import torch

    from facerec_torch.data.preprocess import BatchPreprocessor
    from facerec_torch.detect.mtcnn import Detections
    from facerec_torch.detect.weights import load_default_detector

    cfg = pre.config
    cpu = BatchPreprocessor(cfg, load_default_detector(
        pre.detector.image_hw, cfg.min_face_size, cfg.detection_thresholds, device="cpu"),
        batch_size=len(photos), device="cpu")
    x = torch.from_numpy(cpu.frames(photos))
    with torch.no_grad():
        d_cpu = cpu.detector.detect(x)
        d_card = pre.detector.detect(x.to(pre.device))
    ends = [np.stack(b.process_batch(photos)).astype(np.int32) for b in (pre, cpu)]
    same = [pre.crops(x.to(pre.device), Detections(*(t.to(pre.device) for t in d_cpu))).cpu(),
            cpu.crops(x, d_cpu)]
    same = [np.clip(c.numpy(), 0, 255).astype(np.uint8).astype(np.int32) for c in same]

    def best(d):
        i = torch.argmax(torch.where(d.valid, d.probs, -1.0), dim=1).cpu()
        rows = torch.arange(len(i))
        return d.boxes.cpu()[rows, i], d.landmarks.cpu()[rows, i], d.valid.cpu()[rows, i]

    (bc, lc, vc), (bg, lg, vg) = best(d_cpu), best(d_card)
    side = torch.maximum(bc[:, 2] - bc[:, 0], bc[:, 3] - bc[:, 1])
    off = torch.maximum((bg - bc).abs().amax(dim=1), (lg - lc).abs().amax(dim=(1, 2)))
    e2e, sd = np.abs(ends[0] - ends[1]), np.abs(same[0] - same[1])
    return {"end_to_end_levels": {"mean": float(e2e.mean()), "max": int(e2e.max())},
            "same_detections_levels": {"mean": float(sd.mean()), "max": int(sd.max())},
            "detections_valid_equal": bool(torch.equal(vc, vg)),
            "box_landmark_max_px": float(off.max()),
            "box_landmark_max_share_of_side": float((off / side).max())}


def prep(dev, card: str) -> dict:
    """The prep phase: ``process_raw_data`` on the card at the JAX package's
    settings (WORK_SIZE 512, batch 32, 224 px crops, margin 0.4, the
    committed detector weights at their source's thresholds, augmentation
    on) over a raw tree of 6 persons x 12 photos; ``process_batch``'s
    images/s after one warm-up batch and its stages; faces found; the
    card against the CPU on 4 photos; ``apply_augment`` on the card
    against the CPU on the same draws. Neither kernel lies on this path."""
    import tempfile

    import numpy as np
    import torch

    from facerec_torch.config import PreprocessingConfig
    from facerec_torch.data import preprocess as pp
    from facerec_torch.detect.weights import load_default_detector
    from facerec_torch.ops.augment import AugmentParams, apply_augment, draw_augment

    cfg = PreprocessingConfig()
    n = PREP_PERSONS * PREP_PER_PERSON
    with tempfile.TemporaryDirectory(prefix="facerec_prep_") as td:
        t0 = time.perf_counter()
        photos = _raw_tree(Path(td) / "raw")
        render_s = time.perf_counter() - t0
        det = load_default_detector((pp.WORK_SIZE, pp.WORK_SIZE), cfg.min_face_size,
                                    cfg.detection_thresholds, device=dev)
        pre = pp.BatchPreprocessor(cfg, det, batch_size=PREP_BATCH, device=dev)
        _zero_launches()
        t_all = time.perf_counter()
        pre.process_batch(photos[:PREP_BATCH])  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        crops = pre.process_batch(photos)
        batch_s = time.perf_counter() - t0
        stages = prep_breakdown(pre, photos)
        # faces found: the detector's own verdict on the letterboxed frames
        found = 0
        frames = pre.frames(photos)
        for s in range(0, n, PREP_BATCH):
            chunk = torch.from_numpy(frames[s:min(s + PREP_BATCH, n)]).to(dev)
            found += int(det.detect(chunk).valid.any(dim=1).sum())
        t0 = time.perf_counter()
        out = pp.process_raw_data(Path(td) / "raw", Path(td) / "out", cfg, detector=det,
                                  device=dev)
        torch.cuda.synchronize()
        raw_s = time.perf_counter() - t0
        phase_s = time.perf_counter() - t_all
        launches = _launches()
        files = {split: sorted(q.name for q in (out / "ds0" / split).rglob("*.jpg"))
                 for split in ("train", "val", "test")}
        aug = sum("_aug" in f for f in files["train"])
        stats_json = json.loads((out / "preprocess_stats.json").read_text())
    agree = prep_agrees(pre, photos[:4])
    # apply_augment on the card against the CPU on the same draws
    imgs = torch.from_numpy(np.stack(crops[:8]).astype(np.float32) / 255.0)
    strong = AugmentParams(p_geometry=1.0, p_color=1.0)
    draws = draw_augment(torch.Generator().manual_seed(0), 8, strong)
    aug_err = float((apply_augment(imgs.to(dev), draws, strong).cpu()
                     - apply_augment(imgs, draws, strong)).abs().max())
    n_train = max(int(0.7 * PREP_PER_PERSON), 1)
    n_val = max(int(0.15 * PREP_PER_PERSON), 1)
    n_aug = PREP_PERSONS * cfg.low_data_variants * min(n_train, 10)
    expect = {"train": PREP_PERSONS * n_train + n_aug, "val": PREP_PERSONS * n_val,
              "test": PREP_PERSONS * (PREP_PER_PERSON - n_train - n_val)}
    stats = {"route": "BatchPreprocessor.process_batch + process_raw_data",
             "work_size": pp.WORK_SIZE, "batch": PREP_BATCH, "final_size": cfg.final_size[0],
             "photos": n, "render_s": render_s,
             "process_batch_images_per_s": n / batch_s, "process_batch_s": batch_s,
             "process_batch_stages_ms": stages,
             "found": found, "fallbacks": n - found, "process_raw_data_s": raw_s,
             "phase_s": phase_s,
             "files": {k: len(v) for k, v in files.items()}, "augmented": aug,
             "persons": len(stats_json["datasets"]["ds0"]),
             "card_vs_cpu": agree, "augment_card_vs_cpu_max_abs": aug_err,
             "launches_of_port_kernels": launches}
    print("prep: " + json.dumps(stats | {"card": card}), flush=True)
    if not (found >= PREP_MIN_FOUND and stats["files"] == expect and aug == n_aug):
        raise AssertionError(f"the prep phase failed: {stats} (expected files {expect}, "
                             f">= {PREP_MIN_FOUND} faces)")
    if not (agree["detections_valid_equal"] and agree["same_detections_levels"]["mean"] <= 1.0
            and agree["box_landmark_max_share_of_side"] <= PREP_DET_SHARE
            and aug_err <= AUG_ATOL):
        raise AssertionError(f"the prep path on the card disagrees with the CPU: {agree}, "
                             f"augment {aug_err}")
    if any(launches.values()):
        raise AssertionError(f"the prep path launched a serve kernel: {launches}")
    return stats


def _net_agrees(dev, net_cls, size: int, seed: int, lm: bool) -> dict:
    """``DET_AGREE_STEPS`` f32 ``train_net`` steps on the card against the
    CPU, from the same seeded initial weights, samples and indices: the
    per-step losses, and the parameters as one vector (the 2-norm of the
    difference over the 2-norm of the CPU's), within ``DET_RTOL``; the
    worst single tensor is reported beside it."""
    import numpy as np

    from facerec_torch.detect.train import train_net
    from facerec_torch.detect.weights import flatten_tree

    got, ref = {}, {}
    a = flatten_tree(train_net(net_cls(), size, DET_AGREE_SCENES, DET_AGREE_STEPS, seed=seed,
                               with_landmarks=lm, device=dev, stats=got))
    b = flatten_tree(train_net(net_cls(), size, DET_AGREE_SCENES, DET_AGREE_STEPS, seed=seed,
                               with_landmarks=lm, device="cpu", stats=ref))
    va = np.concatenate([a[k].ravel() for k in sorted(b)])
    vb = np.concatenate([b[k].ravel() for k in sorted(b)])
    worst = max(b, key=lambda k: np.linalg.norm(a[k] - b[k]) / np.linalg.norm(b[k]))
    return {"loss_max_rel": max(abs(x - y) / abs(y) for x, y in zip(got["losses"], ref["losses"])),
            "param_rel": float(np.linalg.norm(va - vb) / np.linalg.norm(vb)),
            "worst_tensor": worst,
            "worst_tensor_rel": float(np.linalg.norm(a[worst] - b[worst])
                                      / np.linalg.norm(b[worst]))}


def detector(dev, card: str) -> dict:
    """The detector phase: ``train_net`` for P-, R- and O-Net on the card at
    tests/test_detector.py's configuration (150 scenes, 120 steps, batch
    256, seeds 0/1/2), saved with ``save_detector_params``, loaded back,
    and detecting on 16 ``render_scene(rng(77))`` scenes against the JAX
    test's bars; then 3 f32 steps per net on the card against the CPU.
    Neither kernel lies on this path."""
    import tempfile

    import numpy as np
    import torch

    from facerec_torch.data.synthetic import render_scene
    from facerec_torch.detect.mtcnn import MTCNN, ONet, PNet, RNet
    from facerec_torch.detect.train import _iou, train_net
    from facerec_torch.detect.weights import (
        load_detector_params_with_source, save_detector_params,
    )

    nets = (("pnet", PNet, 12, 0, False), ("rnet", RNet, 24, 1, False),
            ("onet", ONet, 48, 2, True))
    _zero_launches()
    t_all = time.perf_counter()
    params, per_net = {}, {}
    for name, cls, size, seed, lm in nets:
        st = {}
        params[name] = train_net(cls(), size, DET_SCENES, DET_STEPS, batch_size=DET_BATCH,
                                 seed=seed, with_landmarks=lm, device=dev, stats=st)
        per_net[name] = {"mining_s": st["mining_s"], "samples": st["samples"],
                         "step_ms": st["step_ms"], "loss_first_last": [st["losses"][0],
                                                                       st["losses"][-1]]}
    with tempfile.TemporaryDirectory(prefix="facerec_det_") as td:
        d = save_detector_params(params, Path(td) / "detector")
        loaded, source = load_detector_params_with_source(d)
    det = MTCNN((96, 96), min_face_size=24, thresholds=(0.6, 0.7, 0.7), max_faces=4, k_pnet=32,
                k_rnet=16, device=dev).load_jax_params(loaded)
    rng = np.random.default_rng(77)
    scenes, boxes = [], []
    for _ in range(16):
        img, box, _ = render_scene(rng, canvas=96, face_size_range=(32, 72))
        scenes.append(img)
        boxes.append(box)
    out = det.detect(torch.from_numpy(np.stack(scenes)).to(dev).float())
    found, ious = 0, []
    for i in range(16):
        v = out.valid[i].cpu().numpy()
        if not v.any():
            continue
        found += 1
        bi = int(np.argmax(out.probs[i].cpu().numpy() * v))
        ious.append(float(_iou(out.boxes[i, bi].cpu().numpy(), boxes[i])))
    torch.cuda.synchronize()
    phase_s = time.perf_counter() - t_all
    launches = _launches()
    agree = {name: _net_agrees(dev, cls, size, seed, lm) for name, cls, size, seed, lm in nets}
    stats = {"route": "train_net x 3 + save_detector_params + MTCNN.detect",
             "scenes": DET_SCENES, "steps": DET_STEPS, "batch": DET_BATCH, "nets": per_net,
             "source": source, "found": found, "mean_iou": float(np.mean(ious)) if ious else 0.0,
             "ious": ious, "phase_s": phase_s, "card_vs_cpu": agree,
             "launches_of_port_kernels": launches}
    print("detector: " + json.dumps(stats | {"card": card}), flush=True)
    if not (found >= 10 and stats["mean_iou"] > 0.4 and source == "self-trained"):
        raise AssertionError(f"the detector trained on the card found {found}/16 at mean IoU "
                             f"{stats['mean_iou']:.3f} (bars >= 10 and > 0.4)")
    bad = {k: v for k, v in agree.items()
           if max(v["loss_max_rel"], v["param_rel"]) > DET_RTOL}
    if bad:
        raise AssertionError(f"train_net on the card disagrees with the CPU: {bad}")
    if any(launches.values()):
        raise AssertionError(f"the detector path launched a serve kernel: {launches}")
    return stats


def packed_agrees(pipe, frames) -> dict:
    """``process_demo`` + ``faces_from_packed`` against ``identify`` on the
    same frames, with tests/test_subsystems.py's bars; the per-slot
    embedding against the full result's."""
    import numpy as np

    ref = pipe.identify(frames)
    packed, emb = pipe.process_demo(frames)
    got = pipe.faces_from_packed(packed)
    bad = []
    if packed.shape != (len(frames), pipe.config.max_faces, 19):
        bad.append(f"packed shape {packed.shape}")
    if [len(g) for g in got] != [len(r) for r in ref]:
        bad.append(f"faces {[len(g) for g in got]} against {[len(r) for r in ref]}")
    for g, r in ((g, r) for gf, rf in zip(got, ref) for g, r in zip(gf, rf)):
        if not (g["name"] == r["name"]
                and np.allclose(g["box"], r["box"], rtol=0, atol=1e-4)
                and math.isclose(g["prob"], r["prob"], rel_tol=1e-5)
                and math.isclose(g["distance"], r["distance"], rel_tol=1e-4, abs_tol=1e-6)
                and np.allclose(g["landmarks"], r["landmarks"], rtol=0, atol=1e-3)):
            bad.append(f"slot {g['slot']}: {g} against {r}")
    faces = sum(map(len, got))
    if faces:
        slot = got[0][0]["slot"]
        e0 = emb[0, slot].float().cpu().numpy()
        if not np.allclose(e0, ref[0][0]["embedding"], rtol=1e-5, atol=1e-7):
            bad.append("the per-slot embedding differs")
    out = {"frames": len(frames), "faces": faces,
           "named": sum(f["name"] != "Unknown" for fr in got for f in fr), "mismatches": bad}
    print("demo packed against identify: " + json.dumps(out), flush=True)
    if bad or not faces:
        raise AssertionError(f"the packed demo step disagrees with identify: {out}")
    return out


def demo(dev, bench_pipe, frames) -> tuple[dict, dict]:
    """The demo phase. Returns (launches in ``measure_demo_fps``, stats)."""
    import numpy as np
    import torch

    from facerec_torch.serve.app import (build_default_pipeline, measure_demo_fps,
                                         synthetic_frame_source)

    _zero_launches()
    fps = measure_demo_fps(DEMO_FRAMES, device=dev)
    torch.cuda.synchronize()
    launches = _launches()
    print(f"demo: {json.dumps(fps)}; launches {launches}", flush=True)
    if min(launches.values()) < 1:
        raise AssertionError(f"the demo did not go through every kernel: {launches}")

    pipe = build_default_pipeline(FRAME_HW, device=dev)
    src = synthetic_frame_source(FRAME_HW)
    two = np.stack([src(), src()])
    # a half-filled gallery that holds the first frame's face, lightly noised
    probe = pipe.process(two[:1])
    face = probe.embeddings[0][probe.valid[0]].float().cpu().numpy()
    rng = np.random.default_rng(9)
    n = pipe.config.gallery_capacity // 2
    gal = rng.normal(size=(n, 512)).astype(np.float32)
    gal[:len(face)] = face + 0.02 * rng.normal(size=face.shape)
    pipe.gallery.add_many([f"id_{i}" for i in range(n)], gal)
    agree = packed_agrees(pipe, two)
    x = pipe.upload(two[:1])
    held = hold_path_kernels("demo", pipe, x, pipe.step(x))

    bench = bench_pipe.benchmark(frames, iters=6, warmup=1)
    transfer = bench_pipe.benchmark_transfer(frames, iters=6, warmup=1)
    stats = {"route": "build_default_pipeline + FaceDemo (packed step, batch 1)",
             "frame_hw": list(FRAME_HW), "max_faces": pipe.config.max_faces,
             "embedder": "random ArcFace (no port checkpoint of arcface_synth)",
             **fps, "pipelined_gain": fps["demo_fps"] / fps["demo_fps_serial"],
             "packed_against_identify": agree, "kernels_held": held,
             "bench_faces_per_s": bench["faces_per_sec"],
             "bench_sec_per_batch": bench["sec_per_batch"],
             "transfer_faces_per_s": transfer["faces_per_sec"],
             "transfer_sec_per_batch": transfer["sec_per_batch"],
             "transfer_host_sec_per_batch": transfer["host_sec_per_batch"]}
    return launches, stats


def k2_tilings(k2_in, blocks_per_sm=(2, 1), segments=(1, 2, 3, 4)) -> list[dict]:
    """K2's device time at the serve shape with its tiling forced, beside
    the launcher's own choice (``segments`` and ``blocks_per_sm`` 0); each
    result bit for bit against the plain version."""
    import torch

    from facerec_torch.ops.warp_fast import rotate_patches
    from facerec_torch.ops.warp_kernel import rotate_patches_tiled

    patches, angles, centers, e = k2_in
    ref = rotate_patches(patches, angles, centers, e)
    out = []
    for b, g in [(0, 0)] + [(b, g) for b in blocks_per_sm for g in segments]:
        def fn(g=g, b=b):
            return rotate_patches_tiled(patches, angles, centers, e, segments=g, blocks_per_sm=b)
        exact = torch.equal(fn(), ref)
        out.append({"blocks_per_sm": b, "segments": g, "bit_exact": exact,
                    "device_ms": _kernel_device_ms(fn, ("shear_rotate",))})
        print("K2 tiling: " + json.dumps(out[-1]), flush=True)
        if not exact:
            raise AssertionError(f"K2 disagrees with its plain version at tiling {out[-1]}")
    return out


def kernel_rows(k1_err, k1_sizes, k2_in, k2_err, launches, held) -> list[dict]:
    """The kernels line: each kernel's launches on every path, its error at
    the serve shape and on each path's own inputs (``held``), and its
    times."""
    from facerec_torch.ops.warp_kernel import rotate_patches_kernel
    from facerec_torch.ops.warp_fast import rotate_patches

    serve_row = next(r for r in k1_sizes if r["rows"] == SERVE_ROWS)
    patches, angles, centers, e = k2_in
    n, p = patches.shape[0], patches.shape[1]
    c = patches.shape[3]

    def k2():
        return rotate_patches_kernel(patches, angles, centers, e)

    # bytes: the patch values this run's crops read, two slopes and two
    # consts (f32) per patch, the crop; per output element: two y-pass
    # values (2 products + 1 sum each) and the x pass (2 products + 1 sum)
    read = int(k2_read_mask(angles, centers, p, e).sum().item()) * c * 2
    k2_bound, k2_by = _bound_ms(read + n * 4 * 4 + n * e * e * c * 2, 9.0 * n * e * e * c)
    return [
        {"name": "gallery_topk", "route": "cuda", "source": "facerec_torch/csrc/gallery_topk.cu",
         "replaces": "facerec_tpu/ops/gallery.py:70",
         "launches": launches["serve"]["gallery_topk"],
         "launches_by_path": {k: v["gallery_topk"] for k, v in launches.items()},
         "max_abs_err": k1_err,
         "max_abs_err_by_path": {k: v["gallery_topk"] for k, v in held.items()},
         **{key: serve_row[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                            "library_ms", "library_f32_ms")},
         "sizes": k1_sizes},
        {"name": "shear_rotate", "route": "cuda", "source": "facerec_torch/csrc/shear_rotate.cu",
         "replaces": "facerec_tpu/ops/pallas_warp.py:84",
         "launches": launches["serve"]["shear_rotate"],
         "launches_by_path": {k: v["shear_rotate"] for k, v in launches.items()},
         "max_abs_err": k2_err,
         "max_abs_err_by_path": {k: v["shear_rotate"] for k, v in held.items()
                                 if "shear_rotate" in v},
         "ms": _time_ms(k2, iters=20), "host_ms": _host_ms(k2),
         "device_ms": _kernel_device_ms(k2, ("shear_rotate",)),
         "plain_ms": _time_ms(lambda: rotate_patches(patches, angles, centers, e), iters=5),
         "bound_ms": k2_bound, "bound_by": k2_by, "library_ms": None,
         "patch_bytes_read": read, "patch_share_read": read / (n * p * p * c * 2),
         "tilings": k2_tilings(k2_in)},
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

    t_script = time.perf_counter()
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
    try:
        print(f"build: the JPEG loader with g++ in {build.build_loader(force=True):.1f} s",
              flush=True)
    except RuntimeError as e:  # the trainer then loads with PIL, as the JAX one would here
        print(f"build: the JPEG loader did not build; the trainer takes the PIL batcher. {e}",
              flush=True)

    q, galleries, k1_err = check_k1(dev)
    k1_sizes = time_k1(q, galleries)
    del galleries
    torch.cuda.empty_cache()
    k2_in, k2_err = check_k2(dev)

    import numpy as np

    from facerec_torch.data.synthetic import face_frames

    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    frames = face_frames(BATCH, FRAME_HW, FACES, rng)
    print(f"rendered {BATCH} frames in {time.perf_counter() - t0:.1f} s", flush=True)
    launches, pipes, held, served = {}, {}, {}, {}
    for path, capacity, enroll in (("serve", SERVE_ROWS, enroll_host(rng)),
                                   ("serve_1048576", BIG_ROWS, enroll_device(5)),
                                   ("serve_precise", SERVE_ROWS, enroll_host(rng)),
                                   ("serve_facenet", SERVE_ROWS, enroll_host(rng))):
        t0 = time.perf_counter()
        launches[path], stats, pipes[path] = serve(
            dev, frames, capacity, enroll, path, agree=path in ("serve", "serve_facenet"),
            precise=path == "serve_precise",
            embedder="facenet" if path == "serve_facenet" else "arcface")
        served[path] = {"phase_s": time.perf_counter() - t0} | {key: stats[key] for key in (
            "embedder", "gallery_rows", "gallery_count", "faces_per_sec", "sec_per_batch",
            "host_sec_per_batch", "detected", "detected_p090", "detected_expected",
            "stages_ms", "device_busy_share", "kernels_held")}
        print(f"{path}: " + json.dumps(served[path] | {k: stats[k] for k in ("against_fast",)
                                                       if k in stats} | {"card": card}),
              flush=True)
        held[path] = stats["kernels_held"]
        if path not in ("serve", "serve_facenet"):
            del pipes[path]
        torch.cuda.empty_cache()
    print("serve_facenet beside serve: " + json.dumps({p: {k: served[p][k] for k in (
        "embedder", "phase_s", "faces_per_sec", "sec_per_batch", "stages_ms",
        "device_busy_share")}
        for p in ("serve", "serve_facenet")} | {"card": card}), flush=True)
    t0 = time.perf_counter()
    launches["fold"] = fold(pipes, frames, card)[1]
    del pipes["serve_facenet"]
    torch.cuda.empty_cache()
    print(f"fold: phase {time.perf_counter() - t0:.1f} s", flush=True)
    train_stats, eval_stats, zoo_stats, tune_stats = train(dev, card)
    launches["train"] = train_stats["launches_of_port_kernels"]
    launches["eval"] = eval_stats["launches_of_port_kernels"]
    launches["zoo"] = zoo_stats["launches_of_port_kernels"]
    launches["tune"] = tune_stats["launches_of_port_kernels"]
    print("train: " + json.dumps(train_stats | {"card": card}), flush=True)
    print("eval: " + json.dumps(eval_stats | {"card": card}), flush=True)
    print(f"zoo: phase {zoo_stats['seconds']:.1f} s; launches {launches['zoo']}", flush=True)
    print(f"tune: phase {tune_stats['seconds']:.1f} s; launches {launches['tune']}", flush=True)
    if any(launches["eval"].values()):
        raise AssertionError(f"the eval path launched a serve kernel: {launches['eval']}")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    launches["prep"] = prep(dev, card)["launches_of_port_kernels"]
    torch.cuda.empty_cache()
    launches["detector"] = detector(dev, card)["launches_of_port_kernels"]
    print(f"prep + detector: {time.perf_counter() - t0:.1f} s; launches prep {launches['prep']}, "
          f"detector {launches['detector']}", flush=True)
    torch.cuda.empty_cache()
    launches["demo"], demo_stats = demo(dev, pipes.pop("serve"), frames)
    held["demo"] = demo_stats["kernels_held"]
    print("demo: " + json.dumps(demo_stats | {"card": card}), flush=True)
    torch.cuda.empty_cache()
    rows = kernel_rows(k1_err, k1_sizes, k2_in, k2_err, launches, held)
    print(f"script: {time.perf_counter() - t_script:.1f} s", flush=True)
    print(json.dumps({"kernels": rows, "card": card}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
