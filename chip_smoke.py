"""Chip smoke test of the PyTorch/CUDA port (``facerec_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises (and so exits nonzero) on failure:

  1. build    every CUDA source of ``facerec_torch/csrc`` (``build.SOURCES``:
              the kernels of ``ops/kernels.py``'s table, K1, K2, the NMS
              kernel, the crop kernel and the IResNet epilogue, and the
              trace stamp) (one ``nvcc`` per source, all at once), and the
              host JPEG loader
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
     batchnorm  the data-parallel BatchNorm's native function
              (``models.resnet.global_batch_norm``: the fused kernels of
              ``nn.SyncBatchNorm``) on a one-rank data axis against its
              plain version (``global_batch_norm_plain``) at every
              BatchNorm input of ``bench_train``'s ArcFace at 256 images of
              160 px, f32 and bf16: output, input, weight and bias gradients,
              batch mean and variance at the ``BN_*`` bars, each side's
              gradients against f64 printed beside; then the f64
              isolation of the data-parallel step's first-step gap
              (``batchnorm_isolation``: one batch's ArcFace gradients
              through the one-process BatchNorm, the plain and the native
              global ones, each against an f64 copy of the model);
  4. serve    the port's serve step at ``bench.py``'s configuration (48 frames
              of 480 x 640 with 8 rendered faces each, MTCNN with the
              committed detector weights in bf16, a full-width ResNet-18
              ArcFace embedder in bf16 from seed 1, a 1024-row bf16 gallery
              half filled), through the captured step: the first call
              captures the CUDA graph (its time and peak memory printed),
              then one replay with every launch count set to 0 just before:
              what ``multichip.step_launches`` says, K1 and K2 once, the NMS
              kernel 5 times, the crop kernel 3 times and no epilogue pass
              (the profiler's kernel names on one replay must say the
              same), at least 0.95 x
              384 faces found at p >= 0.6, and every field ``torch.equal``
              to the eager ``step`` on the same frames; the NMS kernel
              bit for bit (keep and rounds) against its plain version
              (overlap matrix, score order, fixed point) on each of its five
              calls' own boxes, scores and validity (every serve path, the
              demo and the mesh ranks too), the rounds each took, and its
              ms, device ms and bound on each; the crop kernel bit for bit
              against the matmul route on each of its three calls' own
              frames and boxes (R-Net, O-Net, align; two on the precise
              path; every serve path, the demo and the mesh ranks too), and
              its ms, device ms, host ms, bound and the matmul route's ms on
              each; ``dispatch_demo`` on the 48
              frames must return before an
              event recorded right after it is done (host ms beside device
              ms); the embed stage alone, eager against one graph (serve and
              serve_facenet); then the same step on a small input, on the
              card and on the CPU, must agree; then faces/s captured and
              eager in turns, timed with CUDA events, the busy share of
              each, and a per-stage breakdown;
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
              plain version on the inputs that path gave it
              (``multichip.hold_kernels``: K1 within 1e-5 of the rounded
              queries, within 2e-3 of f32 queries on a bf16 gallery, near
              ties at most 0.1% of the slots; the others bit for bit);
     serve_trained  the trained ArcFace the repository commits
              (``outputs/checkpoints/arcface_synth/best``, an orbax tree)
              read by the port's own reader (``facerec_torch.train.orbax``,
              no JAX: ``jax`` must not be in ``sys.modules``), every one of
              its 106 arrays held against a pinned SHA-256 digest (dtype,
              shape, bytes) taken from the JAX package's restore; then the
              1,024-row serve step with that embedder loaded as
              ``build_default_pipeline`` loads it (bf16): fill >= 0.95 x 384,
              K1 and K2 once each, K1 within 6.0e-7 of its plain version and
              K2 bit for bit on the path's own inputs, faces/s and stage ms
              beside serve's; then closed-set identification of the 16
              identities of ``make_synthetic_arrays(16, 24, 160, seed 0)``:
              one fresh render per identity enrolled in a ``GalleryStore``
              on the card, the 384 renders queried through K1 (ImageNet-
              normalised, as the model was trained): the f32 embedder's
              correct answers >= JAX's on the CPU (343) less one, and above
              the random-init embedder's on the same renders;
     serve_iresnet100  the 1,024-row step (half filled) with IResNet-100 at
              112 px (the arcface_ir100 cell's embedder): one replay from 0
              launches 99 epilogue passes beside the other kernels, by count
              and by the profiler's kernel names, and no bf16 BatchNorm;
              every kernel held on the path's own inputs, each pass within
              one bf16 ulp of its plain route; each kind of pass timed;
     bench    ``python -m facerec_torch.cli.main bench`` (``facerec_torch.bench``,
              the counterpart of ``bench.py``) in a subprocess, at the
              defaults and with ``BENCH_TRANSFER=1``: exit code 0, its last
              line with ``bench.py``'s keys less ``vs_baseline`` (and the
              transfer-inclusive rate), ``detected_ok`` and
              ``detected_p090_ok`` true, its ``#`` line, and no JAX module
              imported (``-X importtime``); then the bench's ``prepare`` and
              ``measure`` in this process with the counts from 0 (every
              kernel of the step launched and no other; one replay K1 1, K2
              1, NMS 5, crop 3, no epilogue pass by the profiler's kernel
              names) and each kernel held on the bench's
              own inputs; its faces/s beside the serve phase's captured
              figure;
     mesh     the mesh path (``facerec_torch/parallel``): at world size 1
              over NCCL, the serve step through ``FacePipeline(mesh=(1, 1))``,
              captured and replayed (the replay ``torch.equal`` to the eager
              mesh step; K1 1, K2 1, NMS 5, crop 3 and no epilogue pass per
              replay, by count and by the profiler's kernel names), and one
              f32 ArcFace train step
              through the mesh path, each ``torch.equal`` to the plain one;
              then two
              ranks that time-share the card over gloo (spawned; a rank that
              fails fails the phase): (data 1, model 2) serve on a
              1,048,576-row bf16 gallery with 786,431 rows enrolled on the
              card (shard 1 holds 262,143), its merged matches against one
              process's (indices equal but for near-ties as in phase 2,
              scores within 1e-5, valid slots equal) before and after a
              remove that moves row 524,288 across the boundary; (data 2,
              model 1) serve on the 1,024-row gallery, 24 frames a rank, its
              valid slots and indices equal to one process's step on the
              same 24 frames and its embeddings within cosine 0.999 (the
              agreement with the 48-frame step printed beside: bf16
              convolutions round per batch size); (data 2, model 1) three f32
              ArcFace steps at the arcface_synth configuration, global batch
              32 with dropout and BatchNorm over the global batch, each
              within 1e-3 of one process's step from the same state on
              loss, grad_norm and parameters (the free runs' drift from one
              process, and one process's from itself, printed). Counts
              from 0 per layout and rank (a serve step's, 0 in training),
              each kernel held on the rank's own inputs, faces/s
              and step ms per rank (two ranks on one card: no multi-card
              speed);
     multichip  where the machine has four cards: ``python -m
              facerec_torch.multichip`` (the mesh path at full width, one rank
              a card over NCCL; it fails on any failed hold), its launches and
              kernel errors by layout and rank added to the kernels line; on
              fewer cards one line says that it needs four cards;
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
              The trainer replays its step as a CUDA graph: the step's ms
              and busy share captured against eager, in turns; three
              captured steps against three eager ones from copies of one
              state (dropout on), at f32 and bf16, bit for bit with
              deterministic cuDNN (where the eager step equals itself; else
              within twice its spread), and the drift with cuDNN's default
              algorithms reported beside.
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
     bench_train  ``python -m facerec_torch.bench_train`` (the counterpart of
              ``tools/bench_train.py``) in a subprocess for arcface, siamese
              and baseline at batch 256, 160 px: exit code 0, the JAX tool's
              keys, no JAX module imported, and ``train_step_ms`` within 1.3x
              of the profiler's device ms per step of the same step;
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
              K1 and K2 must launch 0 times, the NMS kernel (MTCNN) at
              least once;
     detector ``train_net`` for P-, R- and O-Net on the card at
              tests/test_detector.py's configuration (150 scenes, 120 steps,
              batch 256, seeds 0/1/2): mining s and ms per step (CUDA
              events); saved with ``save_detector_params``, loaded back and
              detecting on 16 ``render_scene(rng(77))`` scenes: >= 10 found
              at mean IoU > 0.4 (the JAX test's bars); 3 f32 steps per net
              on the card against the CPU (1e-4 relative). K1 and K2 must
              launch 0 times, the NMS kernel at least once;
     demo    ``measure_demo_fps(40)`` through ``build_default_pipeline`` on
              480 x 640 synthetic camera frames (the committed detector
              weights, batch-1 packed steps replayed from their CUDA graph):
              pipelined and serial fps, frame ms; ``process_demo`` +
              ``faces_from_packed`` against ``identify`` on two frames; the
              replayed packed step against the eager one, ``torch.equal``;
              every kernel held on the demo's inputs; and ``benchmark_transfer`` (a fresh uint8 upload per
              step) beside ``benchmark`` at bench.py's configuration;
  7. summary  one JSON line of kernels (time by CUDA events, the kernel's
              own device time and the wrapper's host time, plain version's
              time, library call's time, bound from this run's inputs,
              launches, error; K1 at three gallery sizes; K2 at forced
              tilings, each bit for bit; the NMS kernel at each of the serve
              step's five calls, with the rounds per path and the device ms
              of the whole ``nms`` call around it), the card's name and
              power limit, and the result line.

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

# the H100 SXM's published peaks: HBM bytes/s, f32 FLOP/s on the CUDA cores
# (K2 and K1's f32 path), dense bf16 FLOP/s on the tensor cores (K1's bf16 path)
from perfbench.flops import PEAK_BF16_FLOPS, PEAK_F32_FLOPS, PEAK_HBM_BYTES

ROOT = Path(__file__).resolve().parent

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
SMALL_INPUT_COS = 0.999  # card against CPU on a small input; the (2, 1) mesh layout's bar
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
BENCH_KEYS = ("metric", "value", "unit", "detected", "detected_expected", "detected_ok",
              "detected_p090", "detected_p090_ok")  # bench.py's line less vs_baseline
BENCH_TRAIN_MODELS = ("arcface", "siamese", "baseline")
BENCH_TRAIN_KEYS = ("model", "batch", "image", "train_step_ms", "train_imgs_per_sec",
                    "eval_step_ms", "eval_imgs_per_sec", "backend", "devices", "compile_s")
BENCH_TRAIN_DEVICE_RATIO = 1.3  # train_step_ms against the profiler's device ms per step
JAX_MODULES = frozenset({"jax", "jaxlib", "flax", "optax", "facerec_tpu"})
CAPTURE_STEPS = 3  # captured train steps held against eager ones from one state
CAPTURE_SPREAD = 2.0  # x the eager-against-eager spread, where deterministic cuDNN is not
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
TRAINED_CHECKPOINT = "arcface_synth"  # the committed orbax tree, under outputs/checkpoints
PATH_EMBEDDERS = {"serve_facenet": "facenet", "serve_trained": "trained"}  # else "arcface"
# the data-parallel BatchNorm: every BatchNorm input of bench_train's ArcFace
# at 160 px and 256 images a rank (the trunk's channels_last maps, the head's
# [N, 512]); the native global function against its plain version on them,
# the bars by dtype: f32 output within BN_Y_RTOL of its largest value,
# gradients and statistics within the relative L2 given; bf16 output within
# that and one bf16 ulp elementwise (both round an f32 value to bf16), its
# input gradient (bf16) within BN_BF16_DX_L2
BN_SHAPES = ((256, 64, 80, 80), (256, 64, 40, 40), (256, 128, 20, 20), (256, 256, 10, 10),
             (256, 512, 5, 5), (256, 512))
BN_Y_RTOL = 1e-5
BN_GRAD_L2 = 1e-4
BN_STATS_RTOL = 1e-5
BN_BF16_DX_L2 = 1e-2
BN_ISOLATION_BATCH = 256
# the five NMS calls of a serve step, in call order (detect/mtcnn.py)
NMS_SITES = ("per_scale", "cross_scale", "rnet", "large_face", "final")
# f32 operations of one pair's overlap and its test against the threshold, in
# overlap_matrix's order: the intersection 9 (4 max/min, 2 subtractions, 2
# clamps, a product), then union 5 (add, subtract, clamp, divide, compare),
# min 4 (min, clamp, divide, compare), dupmin 11
NMS_PAIR_OPS = {"union": 14, "min": 13, "dupmin": 20}
# the crop kernel's calls in a serve step, in call order (detect/mtcnn.py's
# R-Net and O-Net crops, ops/warp_fast.py::_align_prep); the precise align
# takes none
CROP_SITES = ("rnet", "onet", "align")
# f32 operations of one crop output value: two row-pass sums and the column
# pass, each two products and two sums from a +0 start
CROP_VALUE_OPS = 12
IRESNET_CROP = 112  # the arcface_ir100 cell's crop
# f32 operations an output value at most: two BatchNorms (3 each) and the
# PReLU (2), or the add with its shortcut's BatchNorm (4)
EPILOGUE_VALUE_OPS = 10
BF16_BATCH_NORM = "batch_norm_transform_input_channels_last_kernel<c10::BFloat16"
K1_TRAINED_TOL = 6.0e-7  # K1 against its plain version on serve_trained's inputs
ID_CLASSES, ID_RENDERS, ID_SIZE = 16, 24, 160  # the arcface_synth dataset's shape (synth16)
# No seed 0-9 of the synthetic generator rebuilds the dataset the checkpoint
# was trained on (JAX's restored model scores near chance on each): seed 0
ID_SEED = 0
ID_ENROLL_SEED = 1_000_000  # the fresh render of identity c draws from this + c
# JAX's f32 embedder on the CPU, the same renders: correct answers of 384
JAX_ID_CORRECT = 343
# SHA-256 of each array of the committed tree (dtype string, shape, C-order
# bytes), as the JAX package's load_checkpoint restores it
TRAINED_DIGESTS = {
    "batch_stats.backbone.bn1.mean":
        "a3266723a0c8d9d9f697ed394be09c41336e4c0ba2c66caf85048c326c9ea54c",
    "batch_stats.backbone.bn1.var":
        "3ed48c41f579bc4b3efa1eefad73625402dfa4abe163b599e423b494b15478be",
    "batch_stats.backbone.layer1_0.bn1.mean":
        "936c0ec601ba98182153e5fdb54f1de3b4f53576e124c159388fc7377657b51d",
    "batch_stats.backbone.layer1_0.bn1.var":
        "966e3c635fa4e1cf00346c760083959f80362d8fe3fa44ac1c440a1bf57eb71f",
    "batch_stats.backbone.layer1_0.bn2.mean":
        "2d6440efec6ac09ab34774bf2f217d5d6e19459a5dbb48a1e398444a737a7dde",
    "batch_stats.backbone.layer1_0.bn2.var":
        "86956e3016b6dd632a78ed6f464d7f284cc1e4442f0e8c34a506c3d70340a206",
    "batch_stats.backbone.layer1_1.bn1.mean":
        "26bdb1f3494988cb45dd0be7416691efb534f1e06662f4bfab05763730cb43f2",
    "batch_stats.backbone.layer1_1.bn1.var":
        "b1140f34c3a2b1fbd8b25a302e8631e440bd1b1497ddac4fa78ee5a71f7cee59",
    "batch_stats.backbone.layer1_1.bn2.mean":
        "671b3a1087d5be19b24d8191737669129e2f630c8c62efd07acc4a5245260df3",
    "batch_stats.backbone.layer1_1.bn2.var":
        "635cd28722aafded063c2c2c8be977cd95386243a1624913af057214e1dc8004",
    "batch_stats.backbone.layer2_0.bn1.mean":
        "e34f1eb7a2dcee2bc526e3580235976f9f11c3fdc0352d716a092076dcf4a776",
    "batch_stats.backbone.layer2_0.bn1.var":
        "08bfeebe9ce85cb049e6c8b9787823c3ab83b4065e726d1442aa9c1cc26cd9dc",
    "batch_stats.backbone.layer2_0.bn2.mean":
        "d16da040577145be9175cfd9960cbfd7c6eb25a636cef645429d18484d511128",
    "batch_stats.backbone.layer2_0.bn2.var":
        "77c5a8e72aa5f85ed43cf150fc2371323def3ab352c7f4bc8dc534b7cdf5e938",
    "batch_stats.backbone.layer2_0.downsample_bn.mean":
        "254324f63e13ed469b672845b8dfce9e88c404ed409f5672aacd01b72209e09a",
    "batch_stats.backbone.layer2_0.downsample_bn.var":
        "1ae7144805083c60f7cb1bcc90b4a796f1aac19022f23a47e57b9fa4e9f67ba3",
    "batch_stats.backbone.layer2_1.bn1.mean":
        "5c70e6f9da81b46cdfe501e2d46d8a37346cf897a580665bb498bca1a55ac499",
    "batch_stats.backbone.layer2_1.bn1.var":
        "7f29123b88beb1c34d8eaec5e19f86e3ac906f6e71192212d9883bd4c07895b9",
    "batch_stats.backbone.layer2_1.bn2.mean":
        "17017d26acaac4c63d3eab48520c17c1fa1d6880831261eb11f5c038793afb7b",
    "batch_stats.backbone.layer2_1.bn2.var":
        "fd98afa594915dd5cf6bedbe0e0c2193ea5c4525366f4a318e7e4c937a3ccc0c",
    "batch_stats.backbone.layer3_0.bn1.mean":
        "fbbe18a3c96264eb2328ab102b6ff705f63564b07881e2759584de64dc11893d",
    "batch_stats.backbone.layer3_0.bn1.var":
        "679a3698b7fbb595f431ec800662093de4a4ac73a9837814fa9c7c7dc2198dba",
    "batch_stats.backbone.layer3_0.bn2.mean":
        "6ee19179a127dbc8a9e0ee8a894b1dd41ef682522de3051bc43fe4538ff65615",
    "batch_stats.backbone.layer3_0.bn2.var":
        "bbd624bf74ccf3f3ec6eb14161e6cd6d46c0ea32d42e3138e05ca98b7d872a2b",
    "batch_stats.backbone.layer3_0.downsample_bn.mean":
        "214a76256461e69b00c92f20bb6e038dd4b0dd4faa811d34d39f011e665649c8",
    "batch_stats.backbone.layer3_0.downsample_bn.var":
        "7b4a3245078eb1865fc2375b09a18d3d03489c10826c795c9247b80a273ab9ae",
    "batch_stats.backbone.layer3_1.bn1.mean":
        "2155836ddd27c2c300b73f8d2e0aaafde880f6fdaf4281182f8753fa137dc9e3",
    "batch_stats.backbone.layer3_1.bn1.var":
        "5db52d687b693f3f88810cf8f3d0c27ad76b99b8e3502ef189fcc39aa97dcb95",
    "batch_stats.backbone.layer3_1.bn2.mean":
        "5b957582ff7fc4b530fc02d6d8aa49de32666e8a37d0f411cd916d7805664b10",
    "batch_stats.backbone.layer3_1.bn2.var":
        "f8ec29922b45d6ba0a8da0c12a4207dc62cf568cad5b72af2efb14f6cf9421b3",
    "batch_stats.backbone.layer4_0.bn1.mean":
        "67186ad662f2802bf795d28a2dd8a4cff2989af6d18ab5327653260c7485868b",
    "batch_stats.backbone.layer4_0.bn1.var":
        "df7c8965ec2ed78b0a9f4699aab18f461154f595f10e8418db95b3787d74ed45",
    "batch_stats.backbone.layer4_0.bn2.mean":
        "97f19c29dbe6114acfd881bb51ab8b38980e93eb45fade9b9b4ba1e26c2d6f45",
    "batch_stats.backbone.layer4_0.bn2.var":
        "4ac9794c737ffcbb5cdab1cd8ed4ac85b7a7c1039bb56400d90e92876a83bb67",
    "batch_stats.backbone.layer4_0.downsample_bn.mean":
        "32b4e03b3938d16de7341ffcd5df761efe202e1fa5b784bc009144c02b36d593",
    "batch_stats.backbone.layer4_0.downsample_bn.var":
        "9e702354511cdbbf735b4c52e944fb8fad4ed2b1a366da8e19cc6a41c08dc8c8",
    "batch_stats.backbone.layer4_1.bn1.mean":
        "f0698334d4f026bd6063bd078a89feafe57fc46888dd9424e49591a2bdb6b174",
    "batch_stats.backbone.layer4_1.bn1.var":
        "42b72b5b21ccb4fcc83fbac7359ab37fa6c65fe75478b87a0ddc4f2b2a687041",
    "batch_stats.backbone.layer4_1.bn2.mean":
        "68adf5a8b1160e3c885d404d2a67af0015ddc7cefbb12eaab82b151ba7f5fef8",
    "batch_stats.backbone.layer4_1.bn2.var":
        "65d5ac809794088d72b735aa567fea5ee44eba1b70c5330c52be724e5338a079",
    "batch_stats.bn.mean":
        "7d699aadbebc1693e531cc26dd5f6cd6ee0bea89c09aa8b657fd60a2be276436",
    "batch_stats.bn.var":
        "98d0ca26850c2dca1798bce9c7467e762b7ed2a5e5eda42166141c92032bfe1b",
    "params.arc_weight":
        "807a70ea506188996cd0b29ebe0295c5b18d5b67129acf7bb2368180bf979e1c",
    "params.backbone.bn1.bias":
        "3623c03596c7b08013551f74516d9c5a76db869cf7925c1ae1fc8109e464c280",
    "params.backbone.bn1.scale":
        "c28241190bf76881bea719a8885d1c34bbb1b0bbf78219a3ee5946db0d6864b7",
    "params.backbone.conv1.kernel":
        "e311a57d715419cad2ab1dc2568f6236723754f63a15933ca5133c05c6ad32ea",
    "params.backbone.layer1_0.bn1.bias":
        "6ad71e0a362666d601cfac4541e75806036cc6b28e55a6c633d1693c643022ef",
    "params.backbone.layer1_0.bn1.scale":
        "a9ab0f30730c9730b39e5a8e7a5f5aa0940c5c90257c49990367ec21e75cf4bc",
    "params.backbone.layer1_0.bn2.bias":
        "67fa725d560b06f9e3c97f614d1f10eef1258b9b8ba017a3a1bbbaddae530dd2",
    "params.backbone.layer1_0.bn2.scale":
        "0d40e025e785ba8a203f07868a80300f7224391f5f1b25ed41bd012abe0a373a",
    "params.backbone.layer1_0.conv1.kernel":
        "4e56e90799213dfe705f2b4f9698424dfc59b240d1261bd231cc4ea2427d08b0",
    "params.backbone.layer1_0.conv2.kernel":
        "58a837ccebd0b12579cc0055eb3c7e871b5d1a18a4e4c7d3e8b6f563e617a201",
    "params.backbone.layer1_1.bn1.bias":
        "ba922e005fd8bf1f1227e2eab4d57407438d2cb06661b23ca857138144cac11b",
    "params.backbone.layer1_1.bn1.scale":
        "b9becc684ecba9f7f7fb775dd097cdaa04104a685ed477de92f0d9141898548f",
    "params.backbone.layer1_1.bn2.bias":
        "ac8addafc56701e6f12c2c5ba91423fdd9a35c49d40e9b4e8ce35df665db7713",
    "params.backbone.layer1_1.bn2.scale":
        "de3bfbd150890de79eadae956397ff63736c91b10aa50ba2357ecf1004fcc855",
    "params.backbone.layer1_1.conv1.kernel":
        "39665690242418afb14fa6a6f33bc8947c862e36ddd9cc3a51ad9e520ab47d9f",
    "params.backbone.layer1_1.conv2.kernel":
        "bd4320c8f5af21e9e2ee94e80e87942754ceabd2d3e13274fb8e2cc7748cd1ee",
    "params.backbone.layer2_0.bn1.bias":
        "0a90a8ca1abb321727bc303adb0e6e6ea9ab878ac36ec27a0e8ceed80323eb07",
    "params.backbone.layer2_0.bn1.scale":
        "47adf77ad6a3a935e4b4d713998181f802568f58011ec1ab5adb16ea0314d21d",
    "params.backbone.layer2_0.bn2.bias":
        "3d2402caee8532ff3a9551719e5999d5dedeeb28de86f2ce28e07a7695c1aa84",
    "params.backbone.layer2_0.bn2.scale":
        "abedfa4f46b1371bb7110493d11f7e3dff4f3744abe8eca5e412ef9ffef57e3f",
    "params.backbone.layer2_0.conv1.kernel":
        "ad23e137dd77966be4ae8cf8fad4894812b4321fd7b4ef607cad5ba2f8ac1f92",
    "params.backbone.layer2_0.conv2.kernel":
        "021e4130a72bbdb7bcfc867aae2de01bc6e40a79cb2445f4de459ca5895df308",
    "params.backbone.layer2_0.downsample_bn.bias":
        "3d2402caee8532ff3a9551719e5999d5dedeeb28de86f2ce28e07a7695c1aa84",
    "params.backbone.layer2_0.downsample_bn.scale":
        "1545c5ae489fd3387e2bafa204fcd2e4cd96121a307fd80d4598ca8b9326a76d",
    "params.backbone.layer2_0.downsample_conv.kernel":
        "02e228375bddfd87039e90a5531f4907db661164f503b27098a1d91da7327aa3",
    "params.backbone.layer2_1.bn1.bias":
        "4f0ef6e172d68012dff950f87ab2d2910a3517b701026b055d6b418fcc3d93ad",
    "params.backbone.layer2_1.bn1.scale":
        "a40e0dc10fef2e02254e8a10d506c1a693be2dea24551a17e1754b52c28deb62",
    "params.backbone.layer2_1.bn2.bias":
        "10d1345839b7198ab29fe656d30a21dbbb65589f8a7f4362a53f1729b47815ab",
    "params.backbone.layer2_1.bn2.scale":
        "97ed7483cc5f3aeb69567062c36dfbd6d8ed664665e61c63a077050d7a8adf49",
    "params.backbone.layer2_1.conv1.kernel":
        "6f5c03f7a28db541f55d0add80e82ef1d60adac8bf13cb9adcd7435bd4e04311",
    "params.backbone.layer2_1.conv2.kernel":
        "d39c711817b706ec54e1461dcf6f15ceaa41c634a075ff3113fb67a1ee8ca892",
    "params.backbone.layer3_0.bn1.bias":
        "343e21b6ecf35a1aa232dcd03507cf7e318adfccb57056a1683e17b45ce75745",
    "params.backbone.layer3_0.bn1.scale":
        "5208301f00b595aeac107c2f33ebb88eae0571729dfd7e69ff41a36c0c4089ed",
    "params.backbone.layer3_0.bn2.bias":
        "8104d4f656f9e6946dea520c92114dd4be48307c4c12c21b6a6eabbe75cabccc",
    "params.backbone.layer3_0.bn2.scale":
        "8f0c1db8b62aabaf052235b163be19626a2dc6674f9aedbc168cd570190cbe50",
    "params.backbone.layer3_0.conv1.kernel":
        "e2e6513d6bbc2589332a130bca772cbcc7d0c0f29291c1ae3fec8f1b3861baaf",
    "params.backbone.layer3_0.conv2.kernel":
        "43c84a85ecf1b9b46cafd5fbf7a2207e5777fce1402d6f58667c66dfbeda921a",
    "params.backbone.layer3_0.downsample_bn.bias":
        "8104d4f656f9e6946dea520c92114dd4be48307c4c12c21b6a6eabbe75cabccc",
    "params.backbone.layer3_0.downsample_bn.scale":
        "6c61c7c8508a5aee0e1ce7ca256e4d0b22e91a8137b0929fe234d8d1e962bf2e",
    "params.backbone.layer3_0.downsample_conv.kernel":
        "2274ad897420b2b8d7c7a5894607b8f75451ae71a2568b1c8f0c2fc6cb582e4c",
    "params.backbone.layer3_1.bn1.bias":
        "b8d1ff4670672b57767fc738b6367b0ba6bc56c32e2df545c08658f9465b7d48",
    "params.backbone.layer3_1.bn1.scale":
        "5d52bd16f3834fba41b0c9b177a8333056d0aa786902bd54473694571d5d66cf",
    "params.backbone.layer3_1.bn2.bias":
        "f6398d81696c1feb0bc8bd8febac0a3d08574140a7639fb7e27e28921a01bf41",
    "params.backbone.layer3_1.bn2.scale":
        "ab879f5d8570c2b1c3b9c2c13cf6d4eaf6bc64fbad9601c4a02cf2f4a3844fd3",
    "params.backbone.layer3_1.conv1.kernel":
        "41ee804bbd819a852fd6e340fe2cc294b07537835d23e169a65c2f8ffde0d290",
    "params.backbone.layer3_1.conv2.kernel":
        "d4e80c3f1a75fb975312012b6cd3180285c7400d9a4f7129585527778e47221c",
    "params.backbone.layer4_0.bn1.bias":
        "3260a3af3afe10b9c4bd281a99e54ec871133912b352446af5f1a81dd1a4f6ba",
    "params.backbone.layer4_0.bn1.scale":
        "c4baa5f27ecd666c2e4686af28e541fc79b31d682b9d6c69123981aa145c2649",
    "params.backbone.layer4_0.bn2.bias":
        "de07557d28a77380d51e1e2ddade7e9a171f4e88a0888a7c09cdd632d9f83ab4",
    "params.backbone.layer4_0.bn2.scale":
        "74aaae8f38a15f2c5edbbe9cdff5c5738597efddd50e8afaf0b42a8b48e1ef96",
    "params.backbone.layer4_0.conv1.kernel":
        "e35b7ff94f85a3a355a4d6bbb5402f937b064360a77e230a06a04abf019b3ef6",
    "params.backbone.layer4_0.conv2.kernel":
        "7dbf604196c2ebdf35f2b876a2f944ebbd14ce5a468b3b6c932998d3325ca868",
    "params.backbone.layer4_0.downsample_bn.bias":
        "de07557d28a77380d51e1e2ddade7e9a171f4e88a0888a7c09cdd632d9f83ab4",
    "params.backbone.layer4_0.downsample_bn.scale":
        "40e2ef313ec373aac43ec2d6d8b0463cdf82969be6b30791b6deb396967598f4",
    "params.backbone.layer4_0.downsample_conv.kernel":
        "c1cd3eda0d0103b53dc7dc01804c180c1681db687a66622bd4c8e12e52370d00",
    "params.backbone.layer4_1.bn1.bias":
        "f18e3731d667ef97c28cd3e025df7779030fb40a62c1a744e242602597ad3fde",
    "params.backbone.layer4_1.bn1.scale":
        "b3b27998011faa6b7e9bc415709a90c0278db0c567387f3a4189ebff432fe150",
    "params.backbone.layer4_1.bn2.bias":
        "5b33a232acc91a270f13447a86794ebc1c6f5108380e22cc21b557159f8bb176",
    "params.backbone.layer4_1.bn2.scale":
        "4908ddf6aedecb3d4d5d6b6d7a82f5b83e38356f262fe30162e37d2e855a05ea",
    "params.backbone.layer4_1.conv1.kernel":
        "669e4f32bfd7beb1e5411d678b9fbe61a06e894eb892e16d3f94d2314df436ca",
    "params.backbone.layer4_1.conv2.kernel":
        "7a2ba87877a46a9d93feebe125de1dd399c0c0c9184391eba20aa5d4bddf108a",
    "params.bn.bias":
        "f7ce61a443486937a1dd2b7577fc1184e3adae60121af0d238bc90f291c19eb8",
    "params.bn.scale":
        "05712f4107b4bc53c7b6647366355d90ff986edf11f3120866df97d62850e539",
    "params.embedding.kernel":
        "1f9e7e228e0f4f6d83621585ca4bf12589426903731ccc95320c3b3a9987d490",
}


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


def _bound_ms(nbytes: float, flops: float, peak: float = PEAK_F32_FLOPS) -> tuple[float, str]:
    tb, tf = nbytes / PEAK_HBM_BYTES * 1e3, flops / peak * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def _unit(gen, rows, dim, dev):
    import torch

    x = torch.randn(rows, dim, generator=gen, device=dev)
    return x / x.norm(dim=1, keepdim=True)


def _k1_case(name, q, g, count, k, tol):
    """One K1 comparison (``multichip.k1_case``), printed; raises outside its
    bars. Returns (max abs error against the rounded-query plain version,
    near-tie slots, valid slots)."""
    from facerec_torch.multichip import k1_case

    c = k1_case(q, g, count, k, tol)
    print(f"K1 {name}: B={q.shape[0]} G={g.shape[0]} {str(g.dtype)[6:]} count={count} k={k} "
          f"near_tie_slots={c['near_tie_slots']}/{c['slots']} (gap {c['near_tie_gap']:.3g}) "
          f"masked_slots_exact={c['masked_equal']} max_abs_err={c['max_abs_err']:.3g} "
          f"(tol 1e-5) vs_f32_queries={c['f32_err']:.3g} (tol {tol})", flush=True)
    if not c["within"]:
        raise AssertionError(f"K1 {name} disagrees with its plain version (rows "
                             f"{c['rows_differing']})")
    return c["max_abs_err"], c["near_tie_slots"], c["slots"]


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


def _kernels_per_call(fn, iters: int = 20) -> list:
    """(name, device ms, launches) per call of each CUDA kernel that
    ``fn`` launches, from torch.profiler over ``iters`` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from facerec_torch.utils.profiling import device_ops

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return [(e.key, e.self_device_time_total / iters / 1e3, e.count / iters)
            for e in device_ops(prof)]


def _kernel_device_ms(fn, names: tuple[str, ...], iters: int = 20) -> float:
    """Device time per call of the CUDA kernels whose names contain one of
    ``names``, from torch.profiler over ``iters`` calls."""
    return sum(ms for key, ms, _ in _kernels_per_call(fn, iters)
               if any(n in key for n in names))


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
                              PEAK_BF16_FLOPS)
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

    from facerec_torch.ops import kernels
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
        before = kernels.launches()["shear_rotate"]
        got = rotate_patches_kernel(patches, angles, centers, e)
        ref = rotate_patches(patches, angles, centers, e)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item() if n else 0.0
        worst = max(worst, err)
        launched = kernels.launches()["shear_rotate"] - before
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


def batchnorm_case(dev, shape, dtype, seed: int = 0) -> dict:
    """The native global BatchNorm (``models.resnet.global_batch_norm`` on a
    one-rank data axis: its kernels, no collective) against its plain
    version on the same inputs: output, input gradient, weight and bias
    gradients, batch mean and biased variance, at the ``BN_*`` bars.
    Returns the errors and ``ok``."""
    import torch

    from facerec_torch.config import MeshConfig
    from facerec_torch.models.resnet import global_batch_norm, global_batch_norm_plain
    from facerec_torch.parallel.mesh import build_mesh

    mesh = build_mesh(MeshConfig(data_parallel=1), world_size=1, rank=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    c = shape[1]
    x = torch.randn(shape, generator=gen, device=dev) * 2.0 + 0.5
    if x.ndim == 4:
        x = x.contiguous(memory_format=torch.channels_last)
    x = x.to(dtype)
    w = torch.rand(c, generator=gen, device=dev) + 0.5
    b = torch.rand(c, generator=gen, device=dev) - 0.5
    dy = torch.randn(shape, generator=gen, device=dev).to(dtype)
    outs = []
    for fn in (global_batch_norm, global_batch_norm_plain):
        xs, ws, bs = (t.detach().clone().requires_grad_(True) for t in (x, w, b))
        y, mean, var = fn(xs, ws, bs, 1e-5, mesh)
        y.backward(dy)
        outs.append([y.detach(), xs.grad, ws.grad, bs.grad, mean.detach(), var.detach()])
    (y1, dx1, dw1, db1, m1, v1), (y0, dx0, dw0, db0, m0, v0) = outs

    def l2(a, r):
        return ((a.double() - r.double()).norm() / r.double().norm()).item()

    # both against f64 on the same (rounded) inputs, printed beside the bars
    x64, w64, b64 = (t.detach().double().requires_grad_(True) for t in (x, w, b))
    dims = [0, *range(2, x.ndim)]
    view = [1, -1] + [1] * (x.ndim - 2)
    mu = x64.mean(dims, keepdim=True)
    y64 = (x64 - mu) / torch.sqrt(((x64 - mu) ** 2).mean(dims, keepdim=True) + 1e-5) \
        * w64.view(view) + b64.view(view)
    y64.backward(dy.double())
    truth = {"dx": x64.grad, "dw": w64.grad, "db": b64.grad}
    against_f64 = {side: {k: l2(g, truth[k]) for k, g in zip(("dx", "dw", "db"), got)}
                   for side, got in (("native", (dx1, dw1, db1)), ("plain", (dx0, dw0, db0)))}
    del x64, w64, b64, y64, truth

    err = {"shape": list(shape), "dtype": str(dtype).split(".")[-1],
           "y_max_abs": (y1.float() - y0.float()).abs().max().item(),
           "y_max_abs_ref": y0.float().abs().max().item(),
           "dx_l2": l2(dx1, dx0), "dw_l2": l2(dw1, dw0), "db_l2": l2(db1, db0),
           "mean_rel": ((m1 - m0).abs().max() / m0.abs().max()).item(),
           "var_rel": ((v1 - v0).abs().max() / v0.abs().max()).item(),
           "dtypes": [str(t.dtype).split(".")[-1] for t in (y1, dx1, dw1, db1)],
           "against_f64_l2": against_f64}
    ok = (y1.dtype == y0.dtype == dtype and dx1.dtype == dx0.dtype
          and err["dw_l2"] <= BN_GRAD_L2 and err["db_l2"] <= BN_GRAD_L2
          and err["mean_rel"] <= BN_STATS_RTOL and err["var_rel"] <= BN_STATS_RTOL)
    if dtype == torch.float32:
        ok = ok and err["y_max_abs"] <= BN_Y_RTOL * err["y_max_abs_ref"] and \
            err["dx_l2"] <= BN_GRAD_L2
    else:  # the f32 bar, plus one ulp of the bf16 value (2^-7 of its magnitude)
        ulp = torch.exp2(torch.floor(torch.log2(y0.float().abs().clamp_min(1e-30))) - 7)
        bar = ulp + BN_Y_RTOL * err["y_max_abs_ref"]
        err["y_beyond_one_ulp"] = int(((y1.float() - y0.float()).abs() > bar).sum())
        ok = ok and err["y_beyond_one_ulp"] == 0 and err["dx_l2"] <= BN_BF16_DX_L2
    err["ok"] = bool(ok)
    return err


def _grads(model, batch, dev, generator_seed: int = 0) -> list:
    """The ArcFace loss's gradient of every parameter of ``model`` (train
    mode, one step's forward at epoch 0, dropout from a seeded generator,
    the same mask for every dtype)."""
    import torch

    from facerec_torch.models import get_criterion
    from facerec_torch.train.steps import _forward

    model.train()
    gen = torch.Generator(device=dev).manual_seed(generator_seed)
    params = [p for p in model.parameters()]
    loss = get_criterion("arcface")(_forward(model, "arcface", batch, 0.0, gen), batch)
    return [g.detach() for g in torch.autograd.grad(loss, params)]


def batchnorm_isolation(dev) -> dict:
    """Where the data-parallel step's first-step gradient gap comes from, on
    one card in f32: one batch of ``bench_train``'s ArcFace (256 images of
    160 px from ``make_batches``, the state from seed 0) through (a) the
    one-process BatchNorm (``torch.native_batch_norm``), (b) the plain
    global function ``global_batch_norm_plain`` on a one-rank data mesh,
    (d) the native global function on the same mesh, and (c) an f64 copy of
    the model as the truth (f64 throughout: the model and its loss compute
    in ``at_least_f32`` of their inputs). For each of (a), (b), (d) against (c): the relative
    L2 of the whole gradient and of each convolution's weight gradient, and
    the elements whose sign differs from f64. Deterministic cuDNN."""
    import copy

    import torch

    from facerec_torch.bench_train import NUM_CLASSES, make_batches
    from facerec_torch.config import MeshConfig, TrainConfig
    from facerec_torch.models import get_model, resnet
    from facerec_torch.parallel.mesh import build_mesh
    from facerec_torch.train.state import create_train_state

    cfg = TrainConfig(model_type="arcface", batch_size=BN_ISOLATION_BATCH,
                      num_classes=NUM_CLASSES, seed=0)
    model = create_train_state(get_model("arcface", num_classes=NUM_CLASSES), cfg, "arcface",
                               dev).model
    batch = make_batches("arcface", BN_ISOLATION_BATCH, 160, 1, dev)[0]
    names = [n for n, _ in model.named_parameters()]
    mesh = build_mesh(MeshConfig(data_parallel=1), world_size=1, rank=0, device=dev)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    real_mesh, real_global = resnet.sharded_data_mesh, resnet.global_batch_norm
    grads = {}
    try:
        grads["a_one_process"] = _grads(copy.deepcopy(model), batch, dev)
        resnet.sharded_data_mesh = lambda: mesh
        resnet.global_batch_norm = resnet.global_batch_norm_plain
        grads["b_plain_global"] = _grads(copy.deepcopy(model), batch, dev)
        resnet.global_batch_norm = real_global
        grads["d_native_global"] = _grads(copy.deepcopy(model), batch, dev)
        resnet.sharded_data_mesh = real_mesh
        batch64 = {k: v.double() if v.is_floating_point() else v for k, v in batch.items()}
        grads["c_f64"] = _grads(copy.deepcopy(model).double(), batch64, dev)
    finally:
        resnet.sharded_data_mesh, resnet.global_batch_norm = real_mesh, real_global
        torch.backends.cudnn.deterministic = deterministic
    truth = [g for g in grads["c_f64"]]
    flat_truth = torch.cat([g.reshape(-1) for g in truth])
    convs = [i for i, n in enumerate(names) if truth[i].ndim == 4]
    out = {"batch": BN_ISOLATION_BATCH, "params": len(names), "convolutions": len(convs)}
    for key in ("a_one_process", "b_plain_global", "d_native_global"):
        g = [t.double() for t in grads[key]]
        flat = torch.cat([t.reshape(-1) for t in g])
        per_conv = {names[i]: ((g[i] - truth[i]).norm() / truth[i].norm()).item() for i in convs}
        out[key] = {"grad_l2": ((flat - flat_truth).norm() / flat_truth.norm()).item(),
                    "conv_l2_max": max(per_conv.values()),
                    "conv_l2_median": sorted(per_conv.values())[len(convs) // 2],
                    "sign_differs": int((torch.sign(flat) != torch.sign(flat_truth)).sum()),
                    "conv_l2": per_conv}
    a, b = (torch.cat([t.reshape(-1).double() for t in grads[k]])
            for k in ("a_one_process", "b_plain_global"))
    out["a_against_b_l2"] = ((a - b).norm() / b.norm()).item()
    out["elements"] = int(flat_truth.numel())
    return out


def batchnorm(dev, card: str) -> dict:
    """The data-parallel BatchNorm on the card: the native global function
    against its plain version at every BatchNorm input of ``bench_train``'s
    ArcFace, f32 and bf16 (``batchnorm_case``), then the f64 isolation of
    the first-step gap (``batchnorm_isolation``). Raises where a case misses
    its bars."""
    import torch

    t0 = time.perf_counter()
    cases = [batchnorm_case(dev, shape, dtype, seed=i)
             for i, shape in enumerate(BN_SHAPES) for dtype in (torch.float32, torch.bfloat16)]
    for case in cases:
        print("batchnorm native against plain: " + json.dumps(case), flush=True)
    torch.cuda.empty_cache()
    iso = batchnorm_isolation(dev)
    torch.cuda.empty_cache()
    print("batchnorm isolation (f32 against f64): " + json.dumps(
        {k: ({kk: vv for kk, vv in v.items() if kk != "conv_l2"} if isinstance(v, dict) else v)
         for k, v in iso.items()} | {"card": card}), flush=True)
    print("batchnorm isolation, each convolution's weight gradient against f64: " + json.dumps(
        {k: iso[k]["conv_l2"] for k in ("a_one_process", "b_plain_global", "d_native_global")}),
        flush=True)
    bad = [c for c in cases if not c["ok"]]
    if bad:
        raise AssertionError(f"the native global BatchNorm misses its bars: {bad}")
    return {"cases": cases, "isolation": iso, "phase_s": time.perf_counter() - t0}


def build_pipeline(dev, frame_hw, max_faces, dtype, batch_cfg, precise_align=False,
                   embedder: str = "arcface", mesh=None):
    """bench.py's pipeline: the committed detector, and a full-width embedder
    from seed 1, the ResNet-18 ArcFace or (``embedder="facenet"``)
    InceptionResnetV1 (repeats 5, 10, 5; the VGGFace2 file is not in the
    repository), or (``embedder="iresnet"``) IResNet-100 (112 px crops), or
    (``embedder="trained"``) the committed trained ArcFace; over ``mesh``
    when one is given."""
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
    if embedder == "trained":  # build_default_pipeline's loading path
        from facerec_torch.config import CHECKPOINTS_DIR
        from facerec_torch.serve.app import _embedder_checkpoint

        ck = _embedder_checkpoint(CHECKPOINTS_DIR / TRAINED_CHECKPOINT)
        emb = build_embedder(checkpoint=ck, dtype=dtype, device=dev)
    else:
        from facerec_torch.models.iresnet import build_iresnet_embedder

        build = {"arcface": build_embedder, "facenet": build_facenet_embedder,
                 "iresnet": build_iresnet_embedder}[embedder]
        emb = build(dtype=dtype, seed=1, device=dev)
    return FacePipeline(cfg, frame_hw, det, emb, embed_dim=512, device=dev,
                        precise_align=precise_align, mesh=mesh)


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
    if not (torch.equal(va, vb) and va.any() and cos.min().item() > SMALL_INPUT_COS
            and same_top1):
        raise AssertionError("the step on the card disagrees with the CPU step on a small input")


def nms_adversarial_rows():
    """[4, 12] rows of pairs that sit on the edges of the test: in row 0 a
    pair whose IoU is exactly 0.5 (inter 50 over union 100; min
    overlap 1) and one whose min overlap is exactly 0.5 (inter 50 over
    the smaller area 100; IoU 1/3; equal areas, so dupmin takes min), each
    pair's scores tied; in row 1 zero-area boxes (a line, a point, a line
    crossing a box, two equal lines) among tied scores; row 2 all invalid;
    row 3 four equal boxes: an invalid one with the top score, then three
    with equal scores (the lowest index of those survives). Threshold 0.5;
    numpy arrays (boxes f32, scores f32, valid bool)."""
    import numpy as np

    n = 12
    boxes = np.zeros((4, n, 4), np.float32)
    boxes[0, :4] = [[0, 0, 10, 10], [0, 0, 10, 5], [20, 0, 30, 10], [25, 0, 35, 10]]
    boxes[1, :5] = [[40, 40, 40, 50], [40, 40, 40, 50], [45, 45, 45, 45], [0, 5, 10, 5],
                    [0, 0, 10, 10]]
    boxes[2, :3] = [[0, 0, 10, 10], [1, 1, 11, 11], [2, 2, 12, 12]]
    boxes[3, :4] = [[5, 5, 15, 15], [5, 5, 15, 15], [5, 5, 15, 15], [5, 5, 15, 15]]
    r = np.arange(n, dtype=np.float32)
    far = np.stack([100 + 20 * r, 0 * r + 100, 110 + 20 * r, 0 * r + 110], 1)
    for row, used in ((0, 4), (1, 5), (2, 3), (3, 4)):
        boxes[row, used:] = far[used:]
    scores = np.full((4, n), 0.5, np.float32)
    scores[:, 8:] = np.linspace(0.1, 0.4, 4, dtype=np.float32)
    scores[3, 0] = 0.9
    valid = np.ones((4, n), bool)
    valid[2] = False
    valid[3, 0] = False
    return boxes, scores, valid


def time_nms(pipe, x) -> list[dict]:
    """The NMS kernel at each of the five calls of one eager detect of
    ``x``: CUDA-event ms over back-to-back calls, its device ms (profiler)
    and host ms, the plain version's ms (overlap matrix, score order and
    fixed point as PyTorch ops), and the bound: the larger of the boxes,
    scores and valid read and the keep and rounds written over the HBM
    peak, and N^2 overlaps a row of ``NMS_PAIR_OPS[mode]`` f32 operations
    over the CUDA-core f32 rate. Beside it, the whole ``nms`` call at the
    same site (the masked scores, the kernel, the top-k and gathers after
    it): its device ms and kernels a call, from the profiler over 10
    calls."""
    import torch

    from facerec_torch.detect import mtcnn
    from facerec_torch.ops import kernels
    from facerec_torch.ops.nms import nms_suppress, nms_suppress_plain

    whole, real = [], mtcnn.nms

    def recording(*args, **kwargs):
        whole.append((tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args),
                      kwargs))
        return real(*args, **kwargs)

    mtcnn.nms = recording
    try:
        with kernels.recording("nms_suppress") as calls, torch.no_grad():
            pipe.detector.detect(x)
    finally:
        mtcnn.nms = real
    if len(whole) != len(NMS_SITES):
        raise AssertionError(f"the detect made {len(whole)} nms calls, not {len(NMS_SITES)}")
    rows = []
    for site, (args, _), (call_args, call_kwargs) in zip(NMS_SITES, calls, whole):
        m, n = args[1].shape
        mode = args[4]
        bound, by = _bound_ms(m * n * (16 + 4 + 1) + m * n + 4 * m,
                              NMS_PAIR_OPS[mode] * m * n * n)

        def fn(args=args):
            return nms_suppress(*args)

        call = _kernels_per_call(lambda a=call_args, k=call_kwargs: real(*a, **k), iters=10)
        rows.append({"site": site, "rows": m, "boxes": n, "mode": mode,
                     "ms": _time_ms(fn, iters=50), "device_ms": _kernel_device_ms(
                         fn, ("nms_suppress",)), "host_ms": _host_ms(fn),
                     "plain_ms": _time_ms(lambda args=args: nms_suppress_plain(*args), iters=5,
                                          warmup=1),
                     "bound_ms": bound, "bound_by": by, "library_ms": None,
                     "call_device_ms": sum(ms for _, ms, _ in call),
                     "call_kernels": sum(c for _, _, c in call)})
        print("NMS time: " + json.dumps(rows[-1]), flush=True)
    return rows


def crop_read_bytes(images, boxes, out: int) -> int:
    """Bytes a crop call reads: the source pixels its crops' taps reach,
    each once a frame, and 16 bytes of box a crop."""
    import numpy as np
    import torch

    from facerec_torch.ops.crop_kernel import crop_taps

    b, h, w, c = images.shape
    x1, y1, x2, y2 = boxes.float().cpu().unbind(-1)
    iy = crop_taps(y1, torch.clamp(y2 - y1, min=1.0) / out, out, h)[0].numpy()
    ix = crop_taps(x1, torch.clamp(x2 - x1, min=1.0) / out, out, w)[0].numpy()
    reached = np.zeros((b, h, w), bool)
    for f in range(b):
        for n in range(boxes.shape[1]):
            reached[f][np.ix_(np.unique(iy[f, n]), np.unique(ix[f, n]))] = True
    return int(reached.sum()) * c * images.element_size() + boxes.numel() * 4


def time_crops(pipe, x, r) -> list[dict]:
    """The crop kernel at each of its three calls in one serve step, on the
    step's own inputs (``multichip.record_step``): CUDA-event ms over
    back-to-back calls, its device ms (profiler) and host ms, the matmul
    route's ms, and the bound: the output written and the bytes read
    (``crop_read_bytes``) over the HBM peak, or ``CROP_VALUE_OPS`` f32
    operations an output value over the CUDA-core f32 rate."""
    from facerec_torch.multichip import record_step
    from facerec_torch.ops.crop_kernel import crop_resize_kernel
    from facerec_torch.ops.warp_fast import crop_resize_matmul_batched

    calls = record_step(pipe, x, r, ("crop_resize",))["crop_resize"]
    rows = []
    for site, (args, _) in zip(CROP_SITES, calls):
        images, boxes, out, out_dtype = args
        values = boxes.shape[0] * boxes.shape[1] * out * out * images.shape[-1]
        written, read = values * out_dtype.itemsize, crop_read_bytes(images, boxes, out)
        bound, by = _bound_ms(written + read, CROP_VALUE_OPS * values)

        def fn(args=args):
            return crop_resize_kernel(*args)

        row = {"site": site, "frames": boxes.shape[0], "crops": boxes.shape[1], "out": out,
               "source": [images.shape[1], images.shape[2], str(images.dtype)[6:]],
               "out_dtype": str(out_dtype)[6:], "ms": _time_ms(fn, iters=50),
               "device_ms": _kernel_device_ms(fn, ("crop_resize",)), "host_ms": _host_ms(fn),
               "plain_ms": _time_ms(lambda args=args: crop_resize_matmul_batched(*args),
                                    iters=10, warmup=2),
               "bound_ms": bound, "bound_by": by, "written_mb": written / 1e6,
               "read_mb": read / 1e6, "library_ms": None}
        row["bound_share_of_device_ms"] = row["bound_ms"] / row["device_ms"]
        rows.append(row)
        print("crop time: " + json.dumps(row), flush=True)
    if [row["site"] for row in rows] != list(CROP_SITES):
        raise AssertionError(f"the step made crop calls {[row['site'] for row in rows]}")
    return rows


def time_epilogues(pipe, x, r) -> dict:
    """IResNet-100's epilogue passes on a serve step's own 112 px crops: each
    kind and shape of pass (``multichip.record_epilogues``: its calls and
    its gap to the plain route in bf16 ulps), timed: CUDA-event ms over
    back-to-back calls, device ms (profiler) and host ms per launch, the
    plain route's ms, and the bound: the maps read and written over the HBM
    peak, or ``EPILOGUE_VALUE_OPS`` f32 operations a value over the
    CUDA-core rate; an embed's sums over its passes."""
    import torch

    from facerec_torch.multichip import record_epilogues
    from facerec_torch.ops.iresnet_epilogue import iresnet_epilogue, iresnet_epilogue_plain

    s = pipe.config.embed_size
    with torch.no_grad():
        lm = torch.where(r.valid[..., None, None], r.landmarks, pipe._default_lmk)
        crops = pipe.align(x, r.boxes, lm).reshape(-1, s, s, 3)
    groups = record_epilogues(pipe, crops)
    rows = []
    for (kind, shape), g in groups.items():
        a, bn, kw = g.pop("args")
        maps = 1 + (kw.get("shortcut") is not None) + kw.get("keep", True) + \
            (kw.get("next_bn") is not None)
        nbytes = maps * a.numel() * a.element_size()
        bound, by = _bound_ms(nbytes, EPILOGUE_VALUE_OPS * a.numel())

        def fn(a=a, bn=bn, kw=kw):
            with torch.no_grad():
                return iresnet_epilogue(a, bn, **kw)

        def plain(a=a, bn=bn, kw=kw):
            with torch.no_grad():
                return iresnet_epilogue_plain(a, bn, **kw)

        row = {"kind": kind, "shape": list(shape), "calls": g["calls"], "maps": maps,
               "mb": nbytes / 1e6, "max_ulp": g["max_ulp"],
               "differ_share": g["differ"] / g["values"], "ms": _time_ms(fn, iters=20),
               "device_ms": _kernel_device_ms(fn, ("iresnet_epilogue",)),
               "host_ms": _host_ms(fn), "plain_ms": _time_ms(plain, iters=10, warmup=2),
               "bound_ms": bound, "bound_by": by, "library_ms": None}
        row["bound_share_of_device_ms"] = row["bound_ms"] / row["device_ms"]
        rows.append(row)
        print("epilogue time: " + json.dumps(row), flush=True)
        del a, kw
    calls = sum(r_["calls"] for r_ in rows)
    worst = max(r_["max_ulp"] for r_ in rows)
    per_embed = {k: sum(r_[k] * r_["calls"] for r_ in rows)
                 for k in ("ms", "device_ms", "host_ms", "plain_ms", "bound_ms", "mb")}
    return {"rows": rows, "per_embed": per_embed, "max_ulp": worst,
            "differ_share": sum(r_["differ_share"] * r_["calls"] for r_ in rows) / calls}


def iresnet_epilogues(dev, frames, card: str) -> dict:
    """IResNet-100 served at 112 px (the arcface_ir100 cell's embedder) with
    a bf16 gallery of ``SERVE_ROWS`` rows, half enrolled from seeded host
    normals (``enroll_host``): one replay with the counts from 0 launches
    what ``multichip.step_launches`` says (99 epilogue passes), by the
    counts and by the profiler's kernel names, and no bf16 BatchNorm
    (the head's f32 ``features`` keeps PyTorch's); every kernel held on the
    step's own inputs (``multichip.hold_kernels``: each pass within one
    bf16 ulp); each kind of pass timed (``time_epilogues``)."""
    import numpy as np
    import torch

    from facerec_torch.multichip import hold_kernels, step_launches
    from facerec_torch.ops import kernels

    t0 = time.perf_counter()
    pipe = build_pipeline(dev, FRAME_HW, FACES, torch.bfloat16,
                          dict(gallery_capacity=SERVE_ROWS, top_k=5, embed_size=IRESNET_CROP),
                          embedder="iresnet")
    enroll_host(np.random.default_rng(7))(pipe, SERVE_ROWS // 2)
    x = pipe.upload(frames)
    pipe.run_step(x)  # the warm-ups, the capture, one replay
    torch.cuda.synchronize()
    kernels.zero()
    r = pipe.run_step(x)
    torch.cuda.synchronize()
    launches, want = kernels.launches(), step_launches(pipe)
    print(f"launches in one replay (serve_iresnet100): {launches}", flush=True)
    if launches != want:
        raise AssertionError(f"one IResNet-100 replay launched {launches}, not {want}")
    replay = replay_launches("serve_iresnet100", pipe, x, want, absent=(BF16_BATCH_NORM,))
    held = hold_kernels(pipe, x, r)
    print("serve_iresnet100: kernels held: " + json.dumps(held), flush=True)
    timed = time_epilogues(pipe, x, r)
    out = {"launches": launches, "replay_launches": replay, "held": held,
           "phase_s": time.perf_counter() - t0} | timed
    print("iresnet epilogue: " + json.dumps({k: v for k, v in out.items() if k != "rows"}
                                            | {"card": card}), flush=True)
    return out


def replay_launches(path: str, pipe, x, want: dict, absent: tuple[str, ...] = ()) -> dict:
    """Launches of each port kernel in one replay of the captured step, by
    the kernel names torch.profiler reports (``ops.kernels.TABLE``), which
    must be ``want``, and of the kernels whose names hold one of ``absent``,
    which must be none; where the profiler reports no kernel under replay,
    counted on the eager step instead, and said so."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from facerec_torch.ops.kernels import TABLE
    from facerec_torch.utils.profiling import device_ops

    names = {k: t.profiler_name for k, t in TABLE.items()} | {n: n for n in absent}

    def count(fn):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kernels = device_ops(prof)
        return ({k: sum(e.count for e in kernels if n in e.key) for k, n in names.items()},
                sum(e.count for e in kernels))

    got, total = count(lambda: pipe.run_step(x))
    source = "one replay"
    if total == 0:
        got, total = count(lambda: pipe.step(x))
        source = "the eager step: the profiler reported no kernel under replay"
    out = {"by_kernel_name": got, "kernels_traced": total, "source": source}
    print(f"{path}: launches per replay: " + json.dumps(out), flush=True)
    if got != want | dict.fromkeys(absent, 0):
        raise AssertionError(f"one {path} replay launched {got} by kernel name, not {want}")
    return out


def graph_agrees(path: str, pipe, x, r) -> dict:
    """The captured step's result ``r`` against the eager ``step`` on the
    same frames: every field ``torch.equal``."""
    import torch

    eager = pipe.step(x)
    same = {f: bool(torch.equal(a, b)) for f, a, b in zip(r._fields, r, eager)}
    print(f"{path}: captured step against eager: " + json.dumps(same), flush=True)
    if not all(same.values()):
        raise AssertionError(f"the captured {path} step differs from the eager step: {same}")
    return same


def dispatch_returns_early(pipe, frames) -> dict:
    """``dispatch_demo`` on the whole batch (its packed graph captured
    first): an event recorded right after it returns must not be done yet.
    The host ms to return beside the device ms of the upload and step; the
    packed result against the eager step's, ``torch.equal``."""
    import torch

    pipe.dispatch_demo(frames)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    packed, emb = pipe.dispatch_demo(frames)
    host_ms = (time.perf_counter() - t0) * 1e3
    end.record()
    pending = not end.query()
    torch.cuda.synchronize()
    r = pipe.step(pipe.upload(frames))
    out = {"frames": len(frames), "host_ms_to_return": host_ms,
           "device_ms_upload_and_step": start.elapsed_time(end),
           "event_pending_after_return": pending,
           "packed_equal_to_eager": bool(torch.equal(packed, pipe.pack(r))
                                         and torch.equal(emb, r.embeddings))}
    print("dispatch_demo: " + json.dumps(out), flush=True)
    if not (pending and out["packed_equal_to_eager"]):
        raise AssertionError(f"dispatch_demo waited for the card or differs from eager: {out}")
    return out


def embed_captured(pipe, x) -> dict:
    """The embed stage alone on the step's own crops, eager against one CUDA
    graph of it (a measurement: the pipeline captures the whole step): ms
    (CUDA events), device ms (profiler) and whether the graph's embeddings
    equal the eager ones."""
    import torch

    s = pipe.config.embed_size
    with torch.no_grad():
        d = pipe.detector.detect(x)
        crops = pipe.align(x, d.boxes, d.landmarks).reshape(-1, s, s, 3)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(2):
                pipe.embedder.embed(crops)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = pipe.embedder.embed(crops)
        graph.replay()
        same = bool(torch.equal(out, pipe.embedder.embed(crops)))
        res = {"crops": crops.shape[0], "equal": same,
               "eager_ms": _time_ms(lambda: pipe.embedder.embed(crops), iters=10, warmup=2),
               "graph_ms": _time_ms(graph.replay, iters=10, warmup=2),
               "eager_device_ms": device_busy(
                   lambda: pipe.embedder.embed(crops))["device_ms_per_step"],
               "graph_device_ms": device_busy(graph.replay)["device_ms_per_step"]}
    del graph, out
    print("embed alone, eager against one graph: " + json.dumps(res), flush=True)
    return res


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
    """Phases 4 and 5 (and serve_precise, serve_facenet, serve_trained): the
    serve step at bench.py's configuration with a bf16 gallery of
    ``capacity`` rows, half filled by ``enroll(pipe, n)``, through the
    captured step (``process``): the first call captures it (its peak
    memory is printed); one replay with the counts from 0 launches what
    ``multichip.step_launches`` says (K1 once, K2 once (0 precise), the NMS
    kernel 5 times, the crop kernel 3 times (2 precise), no epilogue pass),
    which the profiler's kernel names confirm; the replay's result equals
    the eager step's; every kernel held on the path's own inputs
    (``multichip.hold_kernels``). Then faces/s and the busy share captured
    and eager, in turns. Returns the kernels' launches in one replay, step
    stats and the pipeline."""
    import numpy as np
    import torch

    from facerec_torch.multichip import hold_kernels, step_launches
    from facerec_torch.ops import kernels

    pipe = build_pipeline(dev, FRAME_HW, FACES, torch.bfloat16,
                          dict(gallery_capacity=capacity, top_k=5, embed_size=160),
                          precise_align=precise, embedder=embedder)
    n_ids = capacity // 2
    t0 = time.perf_counter()
    enroll(pipe, n_ids)
    torch.cuda.synchronize()
    print(f"gallery {capacity} rows: enrolled {pipe.gallery.count} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pipe.process(frames)  # first call: the eager warm-up runs, the capture, one replay
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    memory = {"max_allocated_gb": torch.cuda.max_memory_allocated() / 2**30,
              "reserved_gb": torch.cuda.memory_reserved() / 2**30}
    print(f"first step (warm-up, capture, replay) {capture_s:.2f} s; memory "
          f"{json.dumps(memory)}", flush=True)

    kernels.zero()
    r = pipe.process(frames)
    torch.cuda.synchronize()
    launches = kernels.launches()
    print(f"launches in one replay ({path}, gallery {capacity} rows): {launches}", flush=True)
    want = step_launches(pipe)
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
    extra = {"graph_equal": graph_agrees(path, pipe, x, r),
             "replay_launches": replay_launches(path, pipe, x, want),
             "capture_s": capture_s, "memory": memory}
    held = hold_kernels(pipe, x, r)
    print(f"{path}: kernels held: " + json.dumps(held), flush=True)
    extra["kernels_held"] = held
    if path == "serve":
        extra["nms_time"] = time_nms(pipe, x)
        extra["crop_time"] = time_crops(pipe, x, r)
        extra["dispatch_demo"] = dispatch_returns_early(pipe, frames)
    if path in ("serve", "serve_facenet"):
        extra["embed_alone"] = embed_captured(pipe, x)
    if precise:
        extra["against_fast"] = precise_agrees(pipe, frames, r)
    if agree:
        small_input_agrees(dev, embedder)

    # captured and eager in turns: captured, eager, eager, captured
    runs = [pipe.benchmark(frames, iters=10, warmup=2) if graph else
            pipe._timed(lambda: pipe.step(x), BATCH, 10, 2) for graph in (1, 0, 0, 1)]
    stats = {k: (runs[0][k] + runs[3][k]) / 2 for k in runs[0]}
    stats.update({f"{k}_eager": (runs[1][k] + runs[2][k]) / 2 for k in runs[0]})
    stats["faces_per_sec_turns"] = [run["faces_per_sec"] for run in runs]
    stages = stage_breakdown(pipe, x)
    busy = device_busy(lambda: pipe.run_step(x))
    busy_eager = device_busy(lambda: pipe.step(x))
    stats.update({f"{k}_eager": busy_eager[k] for k in ("device_busy_share",
                                                         "device_ms_per_step")})
    return launches, dict(stats, embedder=embedder, gallery_rows=capacity,
                          gallery_count=pipe.gallery.count,
                          detected=found, detected_p090=found_090, detected_expected=expected,
                          stages_ms=stages, **busy, **extra), pipe


def _run_module(args: list[str], env: dict | None = None, timeout: float = 600) -> tuple:
    """``python -X importtime -m <args>`` from the checkout: (return code,
    stdout, stderr without the import lines, seconds, the top-level modules
    the process imported)."""
    import os

    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-X", "importtime", "-m", *args], cwd=ROOT,
                       env={**os.environ, **(env or {})}, capture_output=True, text=True,
                       timeout=timeout)
    seconds = time.perf_counter() - t0
    imported, err = set(), []
    for line in r.stderr.splitlines():
        if line.startswith("import time:"):
            imported.add(line.rsplit("|", 1)[-1].strip().split(".")[0])
        else:
            err.append(line)
    return r.returncode, r.stdout, "\n".join(err), seconds, imported


def _no_jax(what: str, imported: set) -> None:
    found = sorted(imported & JAX_MODULES)
    if found:
        raise AssertionError(f"{what} imported {found}")


def bench_cli(card: str) -> dict:
    """``python -m facerec_torch.cli.main bench`` in a subprocess, at the
    defaults and with ``BENCH_TRANSFER=1``: return code 0, the last stdout
    line with ``bench.py``'s keys less ``vs_baseline`` (and the
    transfer-inclusive rate when asked), both fill flags true, the ``#``
    line on stderr, and no JAX module imported (``-X importtime``)."""
    rows = {}
    for name, env in (("defaults", {}), ("transfer", {"BENCH_TRANSFER": "1"})):
        rc, out, err, seconds, imported = _run_module(["facerec_torch.cli.main", "bench"], env)
        if rc != 0:
            raise AssertionError(f"bench ({name}) exited {rc}: {err[-3000:]}")
        line = json.loads(out.strip().splitlines()[-1])
        keys = BENCH_KEYS + (("transfer_inclusive_faces_per_sec",) if env else ())
        note = next(x for x in err.splitlines() if x.startswith("# frames/sec="))
        fields, label = note[2:].split(" card=", 1)
        rows[name] = line | {"note": dict(f.split("=", 1) for f in fields.split()),
                             "note_card": label, "seconds": seconds}
        print(f"bench ({name}): " + json.dumps(rows[name] | {"card": card}), flush=True)
        _no_jax(f"bench ({name})", imported)
        if not (tuple(line) == keys and line["detected_ok"] and line["detected_p090_ok"]):
            raise AssertionError(f"bench ({name}) printed {line}")
    return rows


def _went_through(what: str, launches: dict, pipe) -> None:
    """Over some steps of ``pipe``: every kernel that its step launches
    (``multichip.step_launches``) was launched, and no other."""
    from facerec_torch.multichip import step_launches

    if {k: bool(n) for k, n in launches.items()} != {k: bool(n) for k, n in
                                                      step_launches(pipe).items()}:
        raise AssertionError(f"the {what} launched {launches}")


def bench_in_process(dev) -> tuple[dict, dict, dict]:
    """``facerec_torch.bench``'s ``prepare`` and ``measure`` in this process,
    with every launch count set to 0 just before: each kernel of the step
    launched and no other; the profiler's kernel names on one replay give
    K1 1, K2 1, NMS 5, the crop kernel 3 and no epilogue pass; each kernel
    held against its plain version on the bench's own inputs
    (``multichip.hold_kernels``). Returns (launches over ``measure``, held
    errors, its result)."""
    import torch

    from facerec_torch import bench
    from facerec_torch.multichip import hold_kernels, step_launches
    from facerec_torch.ops import kernels

    pipe, frames = bench.prepare(device=dev)
    kernels.zero()
    out, note = bench.measure(pipe, frames)
    torch.cuda.synchronize()
    launches = kernels.launches()
    _went_through("bench path", launches, pipe)
    x = pipe.upload(frames)
    r = pipe.process(frames)
    replay = replay_launches("bench", pipe, x, step_launches(pipe))
    held = hold_kernels(pipe, x, r)
    print("bench: kernels held: " + json.dumps(held), flush=True)
    return launches, held, {"line": out, "note": note, "replay_launches": replay}


def bench_train_cli(card: str) -> dict:
    """``python -m facerec_torch.bench_train`` in a subprocess for each of
    ``BENCH_TRAIN_MODELS`` at the default batch (256): return code 0, the
    last stdout line with the JAX tool's keys, no JAX module imported, and
    ``train_step_ms`` (CUDA events over the captured replays) within
    ``BENCH_TRAIN_DEVICE_RATIO`` of the device ms per step that
    torch.profiler reads on the same step (the ``#`` line): the number is
    the card's, not the host's."""
    rows = {}
    for mt in BENCH_TRAIN_MODELS:
        rc, out, err, seconds, imported = _run_module(["facerec_torch.bench_train"],
                                                      {"BENCH_TRAIN_MODEL": mt})
        if rc != 0:
            raise AssertionError(f"bench_train ({mt}) exited {rc}: {err[-3000:]}")
        line = json.loads(out.strip().splitlines()[-1])
        note = json.loads(next(x for x in err.splitlines() if x.startswith("# {"))[2:])
        ratio = line["train_step_ms"] / note["captured_device_ms_per_step"]
        rows[mt] = line | note | {"events_over_device_ms": ratio, "seconds": seconds}
        print("bench_train: " + json.dumps(rows[mt] | {"card": card}), flush=True)
        _no_jax(f"bench_train ({mt})", imported)
        if not (tuple(line) == BENCH_TRAIN_KEYS and line["backend"] == "cuda"
                and 1 / BENCH_TRAIN_DEVICE_RATIO <= ratio <= BENCH_TRAIN_DEVICE_RATIO):
            raise AssertionError(f"bench_train ({mt}) printed {line}; events / device ms {ratio}")
    return rows


def enroll_host(rng):
    """Half the gallery from host normals, one upload (bench.py's small
    galleries). The last rows enrolled stay in ``enroll.rows``."""
    import numpy as np

    def enroll(pipe, n):
        enroll.rows = rng.normal(size=(n, 512)).astype(np.float32)
        pipe.gallery.add_many([f"id_{i}" for i in range(n)], enroll.rows)
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


def _digest(a) -> str:
    import hashlib

    import numpy as np

    a = np.ascontiguousarray(a)
    return hashlib.sha256(f"{a.dtype.str}{a.shape}".encode() + a.tobytes()).hexdigest()


def read_trained() -> dict:
    """The committed orbax tree through the port's reader, each array held
    against its pinned digest; then the conversion ``load_checkpoint``
    makes. Fails if JAX was imported."""
    from facerec_torch.config import CHECKPOINTS_DIR
    from facerec_torch.train.checkpoints import load_checkpoint
    from facerec_torch.train.orbax import read_orbax_tree

    t0 = time.perf_counter()
    tree = read_orbax_tree(CHECKPOINTS_DIR / TRAINED_CHECKPOINT / "best")
    read_s = time.perf_counter() - t0

    def flat(d, prefix=""):
        for k, v in d.items():
            yield from (flat(v, f"{prefix}{k}.") if isinstance(v, dict) else [(prefix + k, v)])

    arrays = dict(flat(tree))
    if arrays.keys() != TRAINED_DIGESTS.keys():
        raise AssertionError(f"the tree's arrays differ from the pinned ones: "
                             f"{sorted(arrays.keys() ^ TRAINED_DIGESTS.keys())[:5]}")
    bad = [k for k, a in arrays.items() if _digest(a) != TRAINED_DIGESTS[k]]
    if bad:
        raise AssertionError(f"{len(bad)} arrays differ from their pinned digests: {bad[:5]}")
    t0 = time.perf_counter()
    state = load_checkpoint(CHECKPOINTS_DIR / TRAINED_CHECKPOINT)["model"]
    load_s = time.perf_counter() - t0
    out = {"arrays": len(arrays), "bytes": sum(a.nbytes for a in arrays.values()),
           "read_s": read_s, "load_checkpoint_s": load_s, "digests_match": True,
           "classes": int(state["arc_weight"].shape[0]), "jax_imported": "jax" in sys.modules}
    print("serve_trained read: " + json.dumps(out), flush=True)
    if out["jax_imported"]:
        raise AssertionError("reading the orbax tree imported jax")
    return out


def identify_trained(dev, pipe, card: str) -> dict:
    """Closed-set identification over the checkpoint's 16 identities: one
    fresh render each enrolled in a ``GalleryStore`` on the card, the
    ``ID_CLASSES x ID_RENDERS`` renders of ``make_synthetic_arrays`` queried
    through K1 (top 5, the first counted), every image ImageNet-normalised as
    the model was trained. The trained embedder in f32 (the bar), the served
    bf16 one (``pipe``'s) and a random-init one (seed 1, f32)."""
    import numpy as np
    import torch

    from facerec_torch.config import CHECKPOINTS_DIR
    from facerec_torch.data.datasets import _imagenet_normalize
    from facerec_torch.data.synthetic import _identity_params, make_synthetic_arrays, render_face
    from facerec_torch.models.arcface import build_embedder
    from facerec_torch.multichip import K1_F32_TOL
    from facerec_torch.ops import kernels
    from facerec_torch.ops.gallery import gallery_topk
    from facerec_torch.serve.app import _embedder_checkpoint
    from facerec_torch.serve.gallery import GalleryStore

    t0 = time.perf_counter()
    renders, labels = make_synthetic_arrays(ID_CLASSES, ID_RENDERS, ID_SIZE, ID_SEED)
    rng = np.random.default_rng(ID_SEED)  # make_synthetic_arrays's identities
    ids = [_identity_params(rng, skin_lum_range=(0.25, 1.0)) for _ in range(ID_CLASSES)]
    fresh = np.stack([render_face(p, ID_SIZE, np.random.default_rng(ID_ENROLL_SEED + c))
                      for c, p in enumerate(ids)])
    xq = torch.from_numpy(_imagenet_normalize(renders)).to(dev)
    xg = torch.from_numpy(_imagenet_normalize(fresh)).to(dev)
    names = [f"person_{c:03d}" for c in range(ID_CLASSES)]
    ck = _embedder_checkpoint(CHECKPOINTS_DIR / TRAINED_CHECKPOINT)

    def correct(embedder, dtype) -> tuple[int, dict]:
        with torch.no_grad():
            eq, eg = embedder.embed(xq), embedder.embed(xg)
        store = GalleryStore(capacity=SERVE_ROWS, dtype=dtype, device=dev)
        store.add_many_device(names, eg)
        kernels.zero()
        _, idx = gallery_topk(eq, store.embeddings, store.count_device, k=5)
        torch.cuda.synchronize()
        launches = kernels.launches()
        if launches != dict.fromkeys(launches, 0) | {"gallery_topk": 1}:
            raise AssertionError(f"identification did not go through K1 alone, once: "
                                 f"{launches}")
        err = _k1_case(f"identify {str(dtype)[6:]}", eq, store.embeddings, store.count, 5,
                       K1_F32_TOL[dtype])[0]
        return int((idx[:, 0].cpu().numpy() == labels).sum()), {"k1_max_abs_err": err}

    trained, held = correct(build_embedder(checkpoint=ck, dtype=torch.float32, device=dev),
                            torch.float32)
    served, _ = correct(pipe.embedder, pipe.gallery.dtype)
    random_init, _ = correct(build_embedder(dtype=torch.float32, seed=1, device=dev),
                             torch.float32)
    n = len(labels)
    out = {"queries": n, "identities": ID_CLASSES, "seed": ID_SEED,
           "correct_f32": trained, "accuracy_f32": trained / n,
           "correct_served_bf16": served, "accuracy_served_bf16": served / n,
           "correct_random_init": random_init, "accuracy_random_init": random_init / n,
           "jax_cpu_correct": JAX_ID_CORRECT, "jax_cpu_accuracy": JAX_ID_CORRECT / n,
           "bar_correct": JAX_ID_CORRECT - 1, **held,
           "phase_s": time.perf_counter() - t0, "card": card}
    print("serve_trained identify: " + json.dumps(out), flush=True)
    if not (trained >= JAX_ID_CORRECT - 1 and trained > random_init and served > random_init):
        raise AssertionError(f"the trained embedder does not identify as it should: {out}")
    return out


def device_busy(step, steps: int = 3) -> dict:
    """Share of the wall time the card spends in kernels and copies over
    ``steps`` calls of ``step`` (torch.profiler; the profiler's own host
    cost lengthens the wall time, so the share is a lower bound), and the
    kernels that take the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from facerec_torch.utils.profiling import device_ops

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
    dev_events = device_ops(prof)
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
    from facerec_torch.ops import kernels

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
    kernels.zero()
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
    launches = kernels.launches()
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
    """The train step on device-resident distinct batches after warm-up,
    captured (the replay ``train_model`` runs) and eager, in turns
    (captured, eager, eager, captured): ms/step of each by CUDA events, and
    the busy share and device ms of each over 3 steps."""
    from facerec_torch.train.steps import make_train_step

    step = make_train_step(model_type, compute_dtype)
    i = 0

    def calling(fn):
        def one():
            nonlocal i
            fn(state, batches[i % len(batches)])
            i += 1
        return one

    captured, eager = calling(step), calling(step.eager)
    turns = [_time_ms(captured if graph else eager, iters=steps, warmup=warmup)
             for graph in (1, 0, 0, 1)]
    busy_eager = device_busy(eager)
    return {"ms_per_step": (turns[0] + turns[3]) / 2, "ms_per_step_eager": (turns[1] + turns[2]) / 2,
            "ms_turns": turns, **device_busy(captured),
            "device_busy_share_eager": busy_eager["device_busy_share"],
            "device_ms_per_step_eager": busy_eager["device_ms_per_step"]}


def train_capture_agrees(dev) -> dict:
    """``CAPTURE_STEPS`` captured train steps against as many eager steps
    from copies of one state (the arcface_synth model with its dropout of
    0.2 on, epoch 2, 32 faces of 160 px), compared per step on loss_sum,
    grad_norm and every parameter (max abs difference), at f32 and bf16
    compute. With deterministic cuDNN the eager steps run twice: where they
    equal themselves bit for bit, the captured steps must equal them bit
    for bit; where they do not, the captured steps' distance from the first
    eager run must lie within ``CAPTURE_SPREAD`` times the largest
    eager-against-eager distance of the same quantity over the steps. With
    cuDNN's default algorithms (some gradients summed with atomics, so every
    run draws its own rounding) the same distances are reported beside."""
    import copy

    import torch

    from facerec_torch.train.steps import make_train_step

    batch = {k: torch.from_numpy(v).to(dev) for k, v in _mesh_train_batch().items()}
    base = _mesh_train_state(dev)

    def run(compute_dtype: str, graph: bool) -> list[list[torch.Tensor]]:
        state = copy.deepcopy(base)
        step = make_train_step("arcface", compute_dtype)
        out = []
        for _ in range(CAPTURE_STEPS):
            m = (step if graph else step.eager)(state, batch)
            out.append([m["loss_sum"].float(), m["grad_norm"].float(),
                        torch.cat([p.detach().float().reshape(-1)
                                   for p in state.model.parameters()])])
        return out

    def dist(a, b) -> list[list[float]]:  # [step][loss_sum, grad_norm, params]
        return [[(x - y).abs().max().item() for x, y in zip(sa, sb)] for sa, sb in zip(a, b)]

    res = {}
    t0 = time.perf_counter()
    deterministic = torch.backends.cudnn.deterministic
    try:
        for det in (True, False):
            torch.backends.cudnn.deterministic = det
            for compute_dtype in ("float32", "bfloat16"):
                eager = [run(compute_dtype, False) for _ in range(2)]
                got = dist(run(compute_dtype, True), eager[0])
                spread = dist(eager[1], eager[0])
                row = {"captured_vs_eager": got, "eager_vs_eager": spread}
                if det:
                    tol = [CAPTURE_SPREAD * max(st[q] for st in spread) for q in range(3)]
                    exact = not any(tol)
                    row["held"] = "bit for bit" if exact else f"within {tol}"
                    row["ok"] = all(g <= t for st in got for g, t in zip(st, tol))
                res[f"{'deterministic' if det else 'default'}_{compute_dtype}"] = row
    finally:
        torch.backends.cudnn.deterministic = deterministic
    print(f"train step captured against eager ({time.perf_counter() - t0:.1f} s; per step: "
          "loss_sum, grad_norm, params max abs): " + json.dumps(res), flush=True)
    if not all(v.get("ok", True) for v in res.values()):
        raise AssertionError(f"the captured train step differs from the eager one: {res}")
    return res


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
    from facerec_torch.ops import kernels

    ecfg = EvalConfig(model_type="arcface", model_name=model_name, image_size=cfg.image_size)
    kernels.zero()
    t0 = time.perf_counter()
    res = evaluate_model(ecfg, root, checkpoints_root=checkpoints, outputs_root=out_dir,
                         return_predictions=True, device=dev)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    launches = kernels.launches()
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
    from facerec_torch.ops import kernels
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
        kernels.zero()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        out = train_model(cfg, root, checkpoints_root=Path(td) / "checkpoints",
                          model_name="arcface_synth_torch", device=dev)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev)
        hist = out["history"]
        launches = kernels.launches()
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
    capture = train_capture_agrees(dev)
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
        "ms_per_step_eager": timed["ms_per_step_eager"], "ms_turns": timed["ms_turns"],
        "device_busy_share_eager": timed["device_busy_share_eager"],
        "device_ms_per_step_eager": timed["device_ms_per_step_eager"],
        "gflop_per_step": flops / 1e9, "model_tflops": tflops,
        "bf16_peak_share": tflops / (PEAK_BF16_FLOPS / 1e12),
        "epoch_images_per_s_with_loading": len(index) / epoch_s,
        "loader_alone_images_per_s": alone,
        "device_busy_share": timed["device_busy_share"],
        "device_ms_per_step": timed["device_ms_per_step"],
        "host_ms_per_step_by_part": timed.get("host_ms_per_step_by_part"),
        "top_kernels_ms_per_step": timed["top_kernels_ms_per_step"],
        "peak_memory_gb": peak / 2**30, "launches_of_port_kernels": launches,
        "card_vs_cpu": {k: agree[k]["rel"] for k in ("loss", "grad_norm")},
        "captured_vs_eager": {k: v["held"] for k, v in capture.items() if "held" in v},
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
            "ms_per_step_eager": timed["ms_per_step_eager"],
            "device_busy_share": timed["device_busy_share"],
            "device_ms_per_step": timed["device_ms_per_step"],
            "device_busy_share_eager": timed["device_busy_share_eager"],
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
    from facerec_torch.ops import kernels

    kernels.zero()
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
    launches = kernels.launches()
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
    from facerec_torch.ops import kernels

    kernels.zero()
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
    stats["launches_of_port_kernels"] = kernels.launches()
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
    from facerec_torch.ops import kernels
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
        kernels.zero()
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
        launches = kernels.launches()
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
    if (launches["gallery_topk"] or launches["shear_rotate"] or launches["iresnet_epilogue"]
            or not launches["nms_suppress"]):
        raise AssertionError(f"the prep path launched K1, K2 or an epilogue pass, or detected "
                             f"without the NMS kernel: {launches}")
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
    from facerec_torch.ops import kernels

    nets = (("pnet", PNet, 12, 0, False), ("rnet", RNet, 24, 1, False),
            ("onet", ONet, 48, 2, True))
    kernels.zero()
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
    launches = kernels.launches()
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
    if (launches["gallery_topk"] or launches["shear_rotate"] or launches["iresnet_epilogue"]
            or not launches["nms_suppress"]):
        raise AssertionError(f"the detector path launched K1, K2 or an epilogue pass, or "
                             f"detected without the NMS kernel: {launches}")
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

    from facerec_torch.multichip import hold_kernels
    from facerec_torch.ops import kernels
    from facerec_torch.serve.app import (build_default_pipeline, measure_demo_fps,
                                         synthetic_frame_source)

    kernels.zero()
    fps = measure_demo_fps(DEMO_FRAMES, device=dev)
    torch.cuda.synchronize()
    launches = kernels.launches()
    print(f"demo: {json.dumps(fps)}; launches {launches}", flush=True)
    pipe = build_default_pipeline(FRAME_HW, device=dev)
    _went_through("demo", launches, pipe)
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
    r = pipe.step(x)
    packed, emb = pipe.packed_step(x)
    packed_equal = bool(torch.equal(packed, pipe.pack(r)) and torch.equal(emb, r.embeddings))
    print(f"demo: replayed packed step against eager: equal={packed_equal}", flush=True)
    if not packed_equal:
        raise AssertionError("the demo's replayed packed step differs from the eager step")
    held = hold_kernels(pipe, x, r)
    print("demo: kernels held: " + json.dumps(held), flush=True)

    bench = bench_pipe.benchmark(frames, iters=6, warmup=1)
    transfer = bench_pipe.benchmark_transfer(frames, iters=6, warmup=1)
    stats = {"route": "build_default_pipeline + FaceDemo (packed step, batch 1)",
             "frame_hw": list(FRAME_HW), "max_faces": pipe.config.max_faces,
             "embedder": "the trained arcface_synth (orbax best, bf16)",
             **fps, "pipelined_gain": fps["demo_fps"] / fps["demo_fps_serial"],
             "packed_against_identify": agree, "packed_graph_equal": packed_equal,
             "kernels_held": held,
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


def kernel_rows(k1_err, k1_sizes, k2_in, k2_err, launches, held, nms_time,
                crop_time, epilogues) -> list[dict]:
    """The kernels line: each kernel's launches on every path, its error at
    the serve shape and on each path's own inputs (``held``), and its
    times (the NMS kernel's on each of the serve path's five calls,
    ``nms_time``, its headline at the cross-scale call, the largest; the
    crop kernel's on each of its three, ``crop_time``, its headline at the
    align call, the largest; the IResNet epilogue's, ``epilogues``, on an
    IResNet-100 embed of the serve batch, its headline the sum over the
    embed's passes)."""
    from facerec_torch.ops.warp_kernel import rotate_patches_kernel
    from facerec_torch.ops.warp_fast import rotate_patches

    serve_row = next(r for r in k1_sizes if r["rows"] == SERVE_ROWS)
    cross = next(r for r in nms_time if r["site"] == "cross_scale")
    align = next(r for r in crop_time if r["site"] == "align")
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
        {"name": "nms_suppress", "route": "cuda",
         "source": "facerec_torch/csrc/nms_fixed_point.cu",
         "replaces": "facerec_tpu/ops/nms.py:115",
         "launches": launches["serve"]["nms_suppress"],
         "launches_by_path": {k: v["nms_suppress"] for k, v in launches.items()},
         "max_abs_err": held["serve"]["nms_suppress"],
         "max_abs_err_by_path": {k: v["nms_suppress"] for k, v in held.items()},
         "rounds_by_path": {k: v["nms_rounds"] for k, v in held.items()},
         "shape": f"{cross['rows']} rows x {cross['boxes']} boxes (the cross-scale call)",
         **{key: cross[key] for key in ("ms", "device_ms", "host_ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms")},
         "per_step": {key: sum(r[key] for r in nms_time)
                      for key in ("ms", "device_ms", "host_ms", "plain_ms", "bound_ms",
                                  "call_device_ms", "call_kernels")},
         "sites": nms_time},
        {"name": "crop_resize", "route": "cuda", "source": "facerec_torch/csrc/crop_resize.cu",
         "replaces": "facerec_tpu/ops/warp_fast.py:53",
         "launches": launches["serve"]["crop_resize"],
         "launches_by_path": {k: v["crop_resize"] for k, v in launches.items()},
         "max_abs_err": held["serve"]["crop_resize"],
         "max_abs_err_by_path": {k: v["crop_resize"] for k, v in held.items()
                                 if "crop_resize" in v},
         "shape": f"{align['frames']} x {align['crops']} crops of {align['out']} px "
                  "(the align call)",
         **{key: align[key] for key in ("ms", "device_ms", "host_ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms")},
         "per_step": {key: sum(r[key] for r in crop_time)
                      for key in ("ms", "device_ms", "host_ms", "plain_ms", "bound_ms")},
         "sites": crop_time},
        {"name": "iresnet_epilogue", "route": "cuda",
         "source": "facerec_torch/csrc/iresnet_epilogue.cu", "replaces": None,
         "launches": launches["serve_iresnet100"]["iresnet_epilogue"],
         "launches_by_path": {k: v["iresnet_epilogue"] for k, v in launches.items()},
         "max_ulp": epilogues["max_ulp"], "differ_share": epilogues["differ_share"],
         "shape": f"an IResNet-100 embed of {BATCH * FACES} crops of {IRESNET_CROP} px "
                  f"({launches['serve_iresnet100']['iresnet_epilogue']} passes)",
         **{key: epilogues["per_embed"][key] for key in ("ms", "device_ms", "host_ms",
                                                         "plain_ms", "bound_ms")},
         "bound_by": "bytes", "library_ms": None, "passes": epilogues["rows"]},
    ]


MESH_ENROLLED = 786_431  # of BIG_ROWS over 2 model ranks: shard 0 full, shard 1 262,143
MESH_REMOVED = "id_1000"  # a row of shard 0: row 524,288 then slides across the boundary
MESH_TRAIN_STEPS = 3
MESH_TIMEOUT_S = 300


def _mesh_train_batch():
    """32 seeded faces of 160 px, 16 people (the arcface_synth classes), as
    one global batch."""
    import numpy as np

    from facerec_torch.data.datasets import _imagenet_normalize
    from facerec_torch.data.synthetic import make_synthetic_arrays

    imgs, labels = make_synthetic_arrays(num_classes=16, per_class=2, size=160, seed=3)
    return {"image": _imagenet_normalize(imgs), "label": labels.astype(np.int32),
            "mask": np.ones(len(labels), np.float32)}


def _mesh_train_state(dev, mesh=None):
    """The arcface_synth model (dropout on) and optimizer from the config's
    seed, replicated over ``mesh``."""
    from facerec_torch.models import get_model
    from facerec_torch.parallel.mesh import shard_params
    from facerec_torch.train.state import create_train_state

    cfg = arcface_synth_config()
    arc = cfg.arcface
    net = get_model("arcface", num_classes=16, param_dtype=cfg.param_dtype,
                    dropout_rate=cfg.dropout_rate,
                    arcface_kwargs=dict(margin=arc.margin, scale=arc.scale,
                                        easy_margin=arc.easy_margin,
                                        progressive_margin=arc.progressive_margin,
                                        warmup_epochs=arc.warmup_epochs))
    state = create_train_state(net, cfg, "arcface", dev)
    if mesh is not None:
        shard_params(net, mesh)
    state.epoch = 2.0
    return state


def _mesh_train_steps(state, batch, mesh=None) -> dict:
    """``MESH_TRAIN_STEPS`` f32 steps; loss and grad_norm of each, and the
    CUDA-event ms of the steps after the first."""
    import torch

    from facerec_torch.train.steps import make_train_step

    step = make_train_step("arcface", "float32", mesh)
    out, ms = [], []
    for i in range(MESH_TRAIN_STEPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        m = step(state, batch)
        end.record()
        torch.cuda.synchronize()
        out.append({"loss": float(m["loss_sum"] / m["count"]), "grad_norm": float(m["grad_norm"])})
        if i:
            ms.append(start.elapsed_time(end))
    return {"steps": out, "ms_per_step": sum(ms) / len(ms)}


def _mesh_train_per_step(state, batch, mesh) -> tuple[list[dict], list[dict]]:
    """``MESH_TRAIN_STEPS`` data-parallel steps, each held against one
    process's step from the same state on the global batch (rank 0 takes
    it on a copy of the state). Returns (rank 0's relative differences of
    loss, grad_norm and the parameters after the step (one vector, L2);
    the data-parallel steps' loss and grad_norm)."""
    import copy

    import torch

    from facerec_torch.parallel.mesh import shard_batch
    from facerec_torch.train.steps import make_train_step

    dp_step = make_train_step("arcface", "float32", mesh)
    one_step = make_train_step("arcface", "float32")
    local = shard_batch(batch, mesh)
    whole = {k: torch.from_numpy(v).to(mesh.device) for k, v in batch.items()}

    def params(st):
        return torch.cat([p.detach().float().reshape(-1) for p in st.model.parameters()])

    out, free = [], []
    for _ in range(MESH_TRAIN_STEPS):
        twin = copy.deepcopy(state) if mesh.is_primary else None
        m = dp_step(state, local)
        free.append({"loss": float(m["loss_sum"] / m["count"]), "grad_norm": float(m["grad_norm"])})
        if twin is not None:
            m1 = one_step(twin, whole)
            a, b = params(state), params(twin)
            out.append({k: abs(float(m[k]) - float(m1[k])) / abs(float(m1[k]))
                        for k in ("loss_sum", "grad_norm")}
                       | {"params_l2": ((a - b).norm() / b.norm()).item()})
    return out, free


def mesh_one_rank(dev, serve_pipe, frames, rows) -> tuple[dict, object]:
    """The mesh path at world size 1 over NCCL: the serve step through
    ``FacePipeline(mesh=(1, 1))``, captured (its first call) and replayed:
    one replay against the plain pipeline with the same detector, embedder
    and gallery, ``torch.equal`` on every field, and against the eager mesh
    step, ``torch.equal`` too; one replay launches what
    ``multichip.step_launches`` says, by the counts and by the profiler's
    kernel names;
    one f32 ArcFace train step through the mesh path against the plain
    step, ``torch.equal`` on loss, grad_norm and every parameter (cuDNN set
    deterministic for the two, so that its backward sums in one order).
    Returns (launches, the plain step's result)."""
    import tempfile

    import torch
    import torch.distributed as dist

    from facerec_torch.config import MeshConfig
    from facerec_torch.multichip import step_launches
    from facerec_torch.ops import kernels
    from facerec_torch.parallel.mesh import build_mesh
    from facerec_torch.serve.pipeline import FacePipeline

    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/rendezvous", world_size=1,
                                rank=0, device_id=torch.device("cuda",
                                                               torch.cuda.current_device()))
        try:
            mesh = build_mesh(MeshConfig(), device=dev)
            pipe = FacePipeline(serve_pipe.config, FRAME_HW, serve_pipe.detector,
                                serve_pipe.embedder, embed_dim=512, mesh=mesh)
            pipe.gallery.add_many([f"id_{i}" for i in range(len(rows))], rows)
            plain = serve_pipe.process(frames)
            pipe.process(frames)  # the warm-ups, the capture, one replay
            torch.cuda.synchronize()
            if not pipe._graphs:
                raise AssertionError("the (1, 1) mesh step was not captured")
            kernels.zero()
            r = pipe.process(frames)
            torch.cuda.synchronize()
            launches = kernels.launches()
            same = {f: torch.equal(a, b) for f, a, b in zip(r._fields, r, plain)}
            x = pipe.upload(frames)
            graph_agrees("mesh_1x1", pipe, x, r)
            replay_launches("mesh_1x1", pipe, x, step_launches(pipe))
            deterministic = torch.backends.cudnn.deterministic
            torch.backends.cudnn.deterministic = True
            try:
                batch = {k: torch.from_numpy(v).to(dev) for k, v in _step_batch("arcface").items()}
                states = [_mesh_train_state(dev, m) for m in (None, mesh)]
                from facerec_torch.train.steps import make_train_step

                ms = [make_train_step("arcface", "float32", m)(st, batch)
                      for m, st in zip((None, mesh), states)]
            finally:
                torch.backends.cudnn.deterministic = deterministic
            train_same = {k: torch.equal(ms[0][k], ms[1][k]) for k in ("loss_sum", "grad_norm")}
            train_same["params"] = all(torch.equal(a, b) for a, b in zip(
                states[0].model.state_dict().values(), states[1].model.state_dict().values()))
        finally:
            dist.destroy_process_group()
    out = {"serve_equal": same, "train_equal": train_same, "launches": launches,
           "replayed": True}
    print("mesh 1x1 (nccl): " + json.dumps(out), flush=True)
    if not (all(same.values()) and all(train_same.values())):
        raise AssertionError(f"the mesh path at world size 1 differs from the plain path: {out}")
    if launches != step_launches(serve_pipe):
        raise AssertionError(f"the (1, 1) mesh step launched {launches}")
    return launches, plain


def _mesh_rows(dev):
    """The (1, 2) layout's ``MESH_ENROLLED`` gallery rows, seeded on the card."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(11)
    return torch.randn(MESH_ENROLLED, 512, generator=gen, device=dev)


def _mesh_serve(pipe, frames, path: str) -> tuple:
    """Warm-up, then one step with the counts from 0, the kernels held on
    this rank's inputs, and faces/s (CUDA events, all ranks stepping
    together on one card)."""
    import torch

    from facerec_torch.multichip import hold_kernels
    from facerec_torch.ops import kernels

    x = pipe.upload(frames)
    pipe.step(x)
    torch.cuda.synchronize()
    pipe.mesh.barrier()
    kernels.zero()
    r = pipe.step(x)
    torch.cuda.synchronize()
    launches = kernels.launches()
    held = hold_kernels(pipe, x, r)
    print(f"{path}: kernels held: " + json.dumps(held), flush=True)
    pipe.mesh.barrier()
    stats = pipe.benchmark(frames, iters=5, warmup=1)
    return r, launches, held, stats


def mesh_rank(rank: int, world: int, tmp: str) -> None:
    """One of two ranks that share the card over gloo (NCCL refuses two
    ranks on one card): the (1, 2) serve layout on the 1,048,576-row
    gallery, before and after ``MESH_REMOVED``; the (2, 1) serve layout on
    the 1,024-row gallery; and the (2, 1) train steps. Writes
    ``rank<r>.pt``; raises, and so exits nonzero, on any fault."""
    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    from facerec_torch.config import MeshConfig
    from facerec_torch.ops import kernels
    from facerec_torch.parallel.mesh import build_mesh, shard_batch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous", world_size=world,
                            rank=rank)
    frames = np.load(f"{tmp}/frames.npy")
    out = {}
    mesh = build_mesh(MeshConfig(data_parallel=1, model_parallel=2), device="cuda")
    pipe = build_pipeline(mesh.device, FRAME_HW, FACES, torch.bfloat16,
                          dict(gallery_capacity=BIG_ROWS, top_k=5, embed_size=160), mesh=mesh)
    pipe.gallery.add_many_device([f"id_{i}" for i in range(MESH_ENROLLED)],
                                 _mesh_rows(mesh.device))
    torch.cuda.empty_cache()
    r, launches, held, stats = _mesh_serve(pipe, frames, f"mesh_1x2_rank{rank}")
    local_count = pipe.gallery.local_count
    pipe.gallery.remove(MESH_REMOVED)
    r2 = pipe.step(pipe.upload(frames))
    out["1x2"] = {"launches": launches, "held": held, "local_count": local_count,
                  "faces_per_sec": stats["faces_per_sec"], "sec_per_batch": stats["sec_per_batch"],
                  "valid": r.valid.cpu(), "idx": r.match_indices.cpu(),
                  "scores": r.match_scores.cpu(), "idx_after": r2.match_indices.cpu(),
                  "scores_after": r2.match_scores.cpu()}
    del pipe, r, r2
    torch.cuda.empty_cache()

    mesh = build_mesh(MeshConfig(data_parallel=2), device="cuda")
    pipe = build_pipeline(mesh.device, FRAME_HW, FACES, torch.bfloat16,
                          dict(gallery_capacity=SERVE_ROWS, top_k=5, embed_size=160), mesh=mesh)
    rows = np.load(f"{tmp}/serve_rows.npy")
    pipe.gallery.add_many([f"id_{i}" for i in range(len(rows))], rows)
    r, launches, held, stats = _mesh_serve(pipe, frames, f"mesh_2x1_rank{rank}")
    out["2x1"] = {"launches": launches, "held": held, "data_index": mesh.coords[0],
                  "frames": int(r.valid.shape[0]), "faces_per_sec": stats["faces_per_sec"],
                  "sec_per_batch": stats["sec_per_batch"], "valid": r.valid.cpu(),
                  "idx": r.match_indices.cpu(), "embeddings": r.embeddings.float().cpu()}
    del pipe, r
    torch.cuda.empty_cache()

    # deterministic cuDNN, as for the one-process references: a rerun then
    # gives the same numbers (default cuDNN sums some gradients with atomics)
    torch.backends.cudnn.deterministic = True
    kernels.zero()
    state = _mesh_train_state(mesh.device, mesh)
    batch = _mesh_train_batch()
    per_step, free = _mesh_train_per_step(state, batch, mesh)
    timed = _mesh_train_steps(state, shard_batch(batch, mesh), mesh)  # 3 more steps
    res = {"per_step": per_step, "steps": free, "ms_per_step": timed["ms_per_step"],
           "launches": kernels.launches()}
    out["2x1_train"] = res
    torch.save(out, f"{tmp}/rank{rank}.pt")
    dist.destroy_process_group()


def _spawn_mesh_ranks(tmp: str, world: int = 2) -> list[dict]:
    """``mesh_rank`` in ``world`` spawned processes (the parent's CUDA
    context forbids fork), joined within ``MESH_TIMEOUT_S``; any rank that
    fails or outlasts it fails the phase, and every rank still running is
    killed."""
    import multiprocessing

    import torch

    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=mesh_rank, args=(r, world, tmp)) for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + MESH_TIMEOUT_S
    while time.monotonic() < deadline and any(p.exitcode is None for p in procs):
        if any(p.exitcode not in (None, 0) for p in procs):
            break
        time.sleep(0.2)
    for p in procs:
        if p.is_alive():
            p.kill()
        p.join(30)
    codes = [p.exitcode for p in procs]
    if codes != [0] * world:
        raise AssertionError(f"mesh ranks exited {codes} (a rank failed, or the phase "
                             f"outlasted {MESH_TIMEOUT_S} s)")
    return [torch.load(f"{tmp}/rank{r}.pt") for r in range(world)]


def _agreement(got: dict, plain, data_index: int) -> dict:
    """A (2, 1) rank's results against the one-process 48-frame step's rows
    of its frames: the same valid slots, the share of slots with the same
    top-5, the smallest embedding cosine over the valid slots."""
    import torch

    per = BATCH // 2
    sl = slice(data_index * per, (data_index + 1) * per)
    valid = plain.valid[sl].cpu()
    cos = (got["embeddings"] * plain.embeddings[sl].float().cpu()).sum(-1)[valid]
    same = (got["idx"] == plain.match_indices[sl].cpu()).all(-1)
    return {"same_valid": bool(torch.equal(got["valid"], valid)),
            "same_top5_share": same.float().mean().item(),
            "min_cos": cos.min().item() if cos.numel() else None}


def mesh(dev, frames, serve_pipe, rows, card) -> tuple[dict, dict, dict]:
    """The mesh phase: world size 1 over NCCL (``mesh_one_rank``), then two
    ranks time-sharing the card over gloo (``mesh_rank``) against one
    process's results: the (1, 2) serve layout's merged matches (indices
    equal but for near-ties, as in phase 2; scores within 1e-5; valid slots
    equal; again after a remove that moves a row across the shard
    boundary), the (2, 1) layout's valid slots and indices (equal) and
    embeddings (cosine > ``SMALL_INPUT_COS``) against one process on the
    rank's 24 frames (and, reported, on all 48), and the (2, 1) train steps
    (each step's loss, grad_norm and parameters within ``TRAIN_STEP_RTOL``
    of one process's step from the same state). Returns
    (launches by layout and rank, kernel errors by path, stats)."""
    import dataclasses
    import tempfile

    import numpy as np
    import torch

    from facerec_torch.multichip import near_ties, step_launches
    from facerec_torch.serve.pipeline import FacePipeline

    t0 = time.perf_counter()
    launches, plain = {}, None
    launches["mesh_1x1"], plain = mesh_one_rank(dev, serve_pipe, frames, rows)
    stats = {}
    with tempfile.TemporaryDirectory() as tmp:
        np.save(f"{tmp}/frames.npy", frames)
        np.save(f"{tmp}/serve_rows.npy", rows)
        # one process's results: the (1, 2) layout's gallery whole, the train steps
        big = FacePipeline(dataclasses.replace(serve_pipe.config, gallery_capacity=BIG_ROWS),
                           FRAME_HW, serve_pipe.detector, serve_pipe.embedder, 512, device=dev)
        big.gallery.add_many_device([f"id_{i}" for i in range(MESH_ENROLLED)], _mesh_rows(dev))
        ref = big.process(frames)
        big.gallery.remove(MESH_REMOVED)
        ref_after = big.process(frames)
        # the (2, 1) layout's rank d runs frames [24 d, 24 d + 24): one
        # process's step on the same 24 frames (at 48, bf16 convolutions
        # pick other algorithms and round elsewhere; reported beside)
        halves = [serve_pipe.process(frames[d * (BATCH // 2):(d + 1) * (BATCH // 2)])
                  for d in range(2)]
        whole = {k: torch.from_numpy(v).to(dev) for k, v in _mesh_train_batch().items()}
        # one process's three steps, with deterministic cuDNN as the ranks
        # take them, and with the default: how far the run drifts from itself
        deterministic = torch.backends.cudnn.deterministic
        train_ref = []
        for det in (True, False):
            torch.backends.cudnn.deterministic = det
            train_ref.append(_mesh_train_steps(_mesh_train_state(dev), whole))
        torch.backends.cudnn.deterministic = deterministic
        torch.cuda.empty_cache()
        ranks = _spawn_mesh_ranks(tmp)

    q = ref.embeddings.reshape(-1, 512).float()
    one_big = {}
    for rank, got in enumerate(ranks):
        g = got["1x2"]
        launches[f"mesh_1x2_rank{rank}"] = g["launches"]
        ties, gap = near_ties(q, big.gallery.embeddings, ref.match_indices.reshape(-1, 5),
                               g["idx"].to(dev).reshape(-1, 5))
        ties2, gap2 = near_ties(q, big.gallery.embeddings,
                                 ref_after.match_indices.reshape(-1, 5),
                                 g["idx_after"].to(dev).reshape(-1, 5))
        err = max((g["scores"].to(dev) - ref.match_scores).abs().max().item(),
                  (g["scores_after"].to(dev) - ref_after.match_scores).abs().max().item())
        one_big[rank] = {"local_count": g["local_count"], "near_tie_slots": [ties, ties2],
                         "near_tie_gap": max(gap, gap2), "max_score_err": err,
                         "same_valid": bool(torch.equal(g["valid"].to(dev), ref.valid))}
        slots = ref.match_indices.numel()
        if not (one_big[rank]["same_valid"] and err <= 1e-5 and max(gap, gap2) <= 1e-5
                and max(ties, ties2) <= MAX_NEAR_TIE_SHARE * slots):
            raise AssertionError(f"the (1, 2) mesh step disagrees with one process: "
                                 f"{one_big[rank]}")
    del big
    stats["1x2"] = {"faces_per_sec_by_rank": [g["1x2"]["faces_per_sec"] for g in ranks],
                    "sec_per_batch_by_rank": [g["1x2"]["sec_per_batch"] for g in ranks],
                    "against_one_process": one_big, "gallery_rows": BIG_ROWS,
                    "enrolled": MESH_ENROLLED}
    print("mesh 1x2 serve (gloo, 2 ranks on one card): " + json.dumps(
        stats["1x2"] | {"launches": [g["1x2"]["launches"] for g in ranks], "card": card}),
        flush=True)

    two = {}
    for rank, got in enumerate(ranks):
        g = got["2x1"]
        launches[f"mesh_2x1_rank{rank}"] = g["launches"]
        ref = halves[g["data_index"]]
        valid = ref.valid.cpu()
        cos = (g["embeddings"] * ref.embeddings.float().cpu()).sum(-1)[valid]
        whole = _agreement(g, plain, g["data_index"])
        two[rank] = {"frames": g["frames"], "same_valid": bool(torch.equal(g["valid"], valid)),
                     "same_idx": bool(torch.equal(g["idx"], ref.match_indices.cpu())),
                     "min_cos": cos.min().item() if cos.numel() else None,
                     "against_the_48_frame_step": whole,
                     "one_process_24_against_48_frames": _agreement(
                         {"valid": valid, "idx": ref.match_indices.cpu(),
                          "embeddings": ref.embeddings.float().cpu()}, plain, g["data_index"])}
        if not (g["frames"] == BATCH // 2 and two[rank]["same_valid"] and two[rank]["same_idx"]
                and cos.numel() and two[rank]["min_cos"] > SMALL_INPUT_COS):
            raise AssertionError(f"the (2, 1) mesh step disagrees with one process: {two[rank]}")
    stats["2x1"] = {"faces_per_sec_by_rank": [g["2x1"]["faces_per_sec"] for g in ranks],
                    "sec_per_batch_by_rank": [g["2x1"]["sec_per_batch"] for g in ranks],
                    "against_one_process": two, "gallery_rows": SERVE_ROWS}
    print("mesh 2x1 serve (gloo, 2 ranks on one card): " + json.dumps(
        stats["2x1"] | {"launches": [g["2x1"]["launches"] for g in ranks], "card": card}),
        flush=True)

    # Each data-parallel step is held against one process's step from the
    # same state (rank 0, on a copy). Three free-running AdamW steps are
    # not: AdamW moves every parameter by about the LR whatever its
    # gradient's size, so gradients within rounding of 0 step either way,
    # and one process drifts from itself about as far (deterministic
    # against default cuDNN, printed beside the free runs' drift).
    t = ranks[0]["2x1_train"]
    launches.update({f"mesh_2x1_train_rank{r}": got["2x1_train"]["launches"]
                     for r, got in enumerate(ranks)})

    def drift(a, b):
        return [{k: abs(x[k] - y[k]) / abs(y[k]) for k in ("loss", "grad_norm")}
                for x, y in zip(a["steps"], b["steps"])]

    stats["2x1_train"] = {"ms_per_step_by_rank": [g["2x1_train"]["ms_per_step"] for g in ranks],
                          "one_process_ms_per_step": train_ref[0]["ms_per_step"],
                          "per_step_against_one_process": t["per_step"],
                          "free_run_against_one_process": drift(t, train_ref[0]),
                          "one_process_default_against_deterministic_cudnn":
                              drift(train_ref[1], train_ref[0]),
                          "global_batch": 32, "steps": MESH_TRAIN_STEPS}
    print("mesh 2x1 train (gloo, 2 ranks on one card): " + json.dumps(
        stats["2x1_train"] | {"card": card}), flush=True)
    if any(v > TRAIN_STEP_RTOL for s in t["per_step"] for v in s.values()):
        raise AssertionError(f"the (2, 1) train steps disagree with one process: "
                             f"{stats['2x1_train']}")
    for key, got in launches.items():
        if got != step_launches(serve_pipe, steps=0 if "train" in key else 1):
            raise AssertionError(f"the {key} layout launched {got}")
    held = {f"mesh_{lay}_rank{r}": got[lay]["held"] for r, got in enumerate(ranks)
            for lay in ("1x2", "2x1")}
    stats["phase_s"] = time.perf_counter() - t0
    return launches, held, stats


MULTICHIP_CARDS = 4
MULTICHIP_TIMEOUT_S = 900


def multichip(card: str) -> tuple[dict, dict] | None:
    """Where the machine has ``MULTICHIP_CARDS`` cards: ``python -m
    facerec_torch.multichip`` (the mesh path at full width, one rank per
    card over NCCL; it fails on any failed hold), whose summary gives each
    layout's and rank's launches and kernel errors. Returns (launches,
    held), or None on a machine with fewer cards, which it says."""
    import tempfile

    import torch

    n = torch.cuda.device_count()
    if n < MULTICHIP_CARDS:
        print(f"multichip: the four-card phases need {MULTICHIP_CARDS} cards; "
              f"this machine has {n}", flush=True)
        return None
    with tempfile.TemporaryDirectory(prefix="facerec_multichip_") as tmp:
        out = Path(tmp) / "multichip.json"
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "-m", "facerec_torch.multichip", "--out", str(out)],
                             cwd=ROOT, capture_output=True, text=True,
                             timeout=MULTICHIP_TIMEOUT_S + 300)
        for line in res.stdout.splitlines():
            if line.startswith(("multichip serve", "multichip train", "multichip command",
                                "bench_train on one card", "card ")):
                print(line[:600], flush=True)
        if res.returncode != 0:
            raise AssertionError(f"python -m facerec_torch.multichip exited {res.returncode}:\n"
                                 f"{res.stdout[-3000:]}\n{res.stderr[-6000:]}")
        summary = json.loads(out.read_text())
    print("multichip: " + json.dumps({
        "phase_s": time.perf_counter() - t0,
        "faces_per_sec": {k: summary[k]["aggregate_faces_per_sec"] for k in ("4x1", "1x4", "2x2")},
        "train_images_per_sec": summary["train"]["images_per_sec"],
        "train_scaling": summary["train"]["scaling"], "card": card}), flush=True)
    return summary["launches"], summary["held"]


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
    bn = batchnorm(dev, card)
    print(f"batchnorm: phase {bn['phase_s']:.1f} s", flush=True)

    import numpy as np

    from facerec_torch.data.synthetic import face_frames

    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    frames = face_frames(BATCH, FRAME_HW, FACES, rng)
    print(f"rendered {BATCH} frames in {time.perf_counter() - t0:.1f} s", flush=True)
    launches, pipes, held, served = {}, {}, {}, {}
    serve_enroll = enroll_host(rng)
    for path, capacity, enroll in (("serve", SERVE_ROWS, serve_enroll),
                                   ("serve_1048576", BIG_ROWS, enroll_device(5)),
                                   ("serve_precise", SERVE_ROWS, enroll_host(rng)),
                                   ("serve_facenet", SERVE_ROWS, enroll_host(rng)),
                                   ("serve_trained", SERVE_ROWS, enroll_host(rng))):
        t0 = time.perf_counter()
        if path == "serve_trained":
            trained_read = read_trained()
        launches[path], stats, pipes[path] = serve(
            dev, frames, capacity, enroll, path, agree=path in ("serve", "serve_facenet"),
            precise=path == "serve_precise", embedder=PATH_EMBEDDERS.get(path, "arcface"))
        served[path] = {"phase_s": time.perf_counter() - t0} | {key: stats[key] for key in (
            "embedder", "gallery_rows", "gallery_count", "faces_per_sec", "sec_per_batch",
            "host_sec_per_batch", "faces_per_sec_eager", "sec_per_batch_eager",
            "host_sec_per_batch_eager", "faces_per_sec_turns", "detected", "detected_p090",
            "detected_expected", "stages_ms", "device_busy_share", "device_ms_per_step",
            "device_busy_share_eager", "device_ms_per_step_eager", "capture_s", "memory",
            "kernels_held")}
        if path == "serve":
            nms_time, crop_time = stats["nms_time"], stats["crop_time"]
            served[path]["dispatch_demo"] = stats["dispatch_demo"]
        if "embed_alone" in stats:
            served[path]["embed_alone"] = stats["embed_alone"]
        print(f"{path}: " + json.dumps(served[path] | {k: stats[k] for k in ("against_fast",)
                                                       if k in stats} | {"card": card}),
              flush=True)
        held[path] = stats["kernels_held"]
        if path == "serve_trained" and held[path]["gallery_topk"] > K1_TRAINED_TOL:
            raise AssertionError(f"K1 on serve_trained's inputs: max abs error "
                                 f"{held[path]['gallery_topk']} > {K1_TRAINED_TOL}")
        if path not in ("serve", "serve_facenet", "serve_trained"):
            del pipes[path]
        torch.cuda.empty_cache()
    print("captured against eager: " + json.dumps({p: {k: v[k] for k in (
        "faces_per_sec", "faces_per_sec_eager", "device_busy_share", "device_busy_share_eager",
        "device_ms_per_step", "device_ms_per_step_eager", "capture_s", "memory")}
        for p, v in served.items()} | {"card": card}), flush=True)
    print("serve_facenet beside serve: " + json.dumps({p: {k: served[p][k] for k in (
        "embedder", "phase_s", "faces_per_sec", "sec_per_batch", "faces_per_sec_eager",
        "sec_per_batch_eager", "stages_ms", "device_busy_share", "embed_alone")}
        for p in ("serve", "serve_facenet")} | {"card": card}), flush=True)
    identified = identify_trained(dev, pipes.pop("serve_trained"), card)
    print("serve_trained beside serve: " + json.dumps({p: {k: served[p][k] for k in (
        "embedder", "phase_s", "faces_per_sec", "sec_per_batch", "stages_ms", "detected",
        "device_busy_share")} for p in ("serve", "serve_trained")}
        | {k: trained_read[k] for k in ("read_s", "load_checkpoint_s")}
        | {"accuracy_f32": identified["accuracy_f32"], "card": card}), flush=True)
    torch.cuda.empty_cache()
    epilogues = iresnet_epilogues(dev, frames, card)
    launches["serve_iresnet100"] = epilogues["launches"]
    held["serve_iresnet100"] = epilogues["held"]
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    bench_rows = bench_cli(card)
    bench_cli_s = time.perf_counter() - t0
    launches["bench"], held["bench"], bench_stats = bench_in_process(dev)
    torch.cuda.empty_cache()
    print("bench beside serve: " + json.dumps({
        "bench_faces_per_sec": {k: v["value"] for k, v in bench_rows.items()},
        "bench_transfer_inclusive_faces_per_sec":
            bench_rows["transfer"]["transfer_inclusive_faces_per_sec"],
        "bench_in_process_faces_per_sec": bench_stats["line"]["value"],
        "bench_detected": bench_stats["line"]["detected"],
        "serve_captured_faces_per_sec": served["serve"]["faces_per_sec"],
        "phase_s": time.perf_counter() - t0, "subprocesses_s": bench_cli_s, "card": card}),
        flush=True)
    mesh_launches, mesh_held, mesh_stats = mesh(dev, frames, pipes["serve"], serve_enroll.rows,
                                                card)
    launches.update(mesh_launches)
    held.update(mesh_held)
    torch.cuda.empty_cache()
    print(f"mesh: phase {mesh_stats['phase_s']:.1f} s; launches {mesh_launches}", flush=True)
    four = multichip(card)
    if four is not None:
        launches.update(four[0])
        held.update(four[1])
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
    bench_train_cli(card)
    print(f"bench_train: phase {time.perf_counter() - t0:.1f} s", flush=True)
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
    rows = kernel_rows(k1_err, k1_sizes, k2_in, k2_err, launches, held, nms_time, crop_time,
                       epilogues)
    if "jax" in sys.modules:
        raise AssertionError("the run imported jax")
    print(f"script: {time.perf_counter() - t_script:.1f} s", flush=True)
    print(json.dumps({"kernels": rows, "card": card}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
