"""Several cards, one rank each (counterpart of the repository's root
``__graft_entry__.py``).

    python -m facerec_torch.multichip [--timeout SECONDS] [--out FILE]

``entry()`` is the single-card forward of the flagship model: the ArcFace
embeddings of ``get_model("arcface", num_classes=18)`` under bf16 autocast
on an [8, 112, 112, 3] batch. ``dryrun_multichip(n)`` runs JAX's tiny train
step and serve step over an n-rank ``(data, model)`` mesh, ``model`` 2
where n is even and at least 4 (``__graft_entry__.py``'s choice): inside a
process group of n ranks it is this rank's part; without one it spawns n
ranks over NCCL, one per card, and returns their results.

The module's run is the mesh path at full width on four cards of one host
over NCCL. It spawns one rank per card (``spawn_ranks``: every rank has a
time limit; a rank that fails or outlasts it fails the run, and the others
are stopped), and each rank runs, in one order:

  * the dry run on the (2, 2) mesh;
  * ``bench.py``'s serve configuration on the (4, 1), (1, 4) and (2, 2)
    layouts (``LAYOUTS``): 48 frames of 480 x 640 a data index with 8 faces
    each, the committed MTCNN weights in bf16, a full-width ResNet-18
    ArcFace at 160 px in bf16 from seed 1, top 5. Each layout's step is
    captured and replayed; the replay must equal the eager mesh step, one
    replay must launch what ``step_launches`` says (K1 once, K2 once, the
    NMS kernel five times, the crop kernel three times, no epilogue pass)
    by the counts and by the profiler's kernel names, and each kernel must
    hold against its plain version on the rank's own inputs
    (``hold_kernels``). The results must agree with one
    process on one card: (4, 1) each rank's valid slots and indices equal to
    one process's captured step on its 48 frames, embeddings within cosine
    ``COS_BAR``; (1, 4) and (2, 2) the merged top 5 equal to one process's
    K1 over the whole gallery but for near-ties, scores within
    ``SCORE_ATOL``, before and after a remove that moves rows across the
    shard boundaries;
  * the (4, 1) train step of ``bench_train``'s ArcFace at 256 images a rank
    (18 classes, 160 px, bf16, Adam, state from seed 0): under
    deterministic cuDNN three captured steps against the eager mesh steps
    (bit for bit where the eager step equals itself, else both drifts
    printed); three f32 captured steps, each within ``TRAIN_RTOL`` of one
    process's step on the global batch of 1,024 from the same state in
    loss and grad_norm, and in the parameters after every step but the
    first. Adam's first step from zero moments moves each parameter by the
    learning rate times the sign of its gradient, so where a gradient
    cancels to near 0 (BatchNorm's backward subtracts its mean) any two f32
    roundings of the step can pick either sign: on one card, one batch's
    f32 gradient lies 3.9e-3 to 4.4e-3 in L2 from f64 through each of the
    one-process, the plain global and the native global BatchNorm
    (``chip_smoke.batchnorm_isolation``), so the first step's parameters
    and every step's gradients are printed, not held. The same three steps
    with the plain global BatchNorm (``plain_batch_norm``) are printed
    beside, and the bf16 steps' differences. Then the bf16 step's time with the
    native global BatchNorm and with its plain version, in turns;
  * the NCCL all-reduce of the gradient's own size, as bus GB/s.

Then ``train_model`` over four ranks through the command line under
``torchrun`` (the ``arcface_synth`` flags, 2 epochs), its checkpoint loaded
in one process, and ``evaluate_model`` over four ranks through the command
line against one process's. ``bench_train`` on one card runs in the same
call for the scaling. Nothing falls back: a layout without its cards raises, and so does any
failed check, collective or capture. The last line of stdout is a JSON
summary (``chip_smoke.py`` reads its launches).
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import os
import pickle
import socket
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
CARDS = 4
FRAME_HW = (480, 640)
FACES = 8
PER_RANK = 48  # frames a data index runs (bench.py's batch)
# (data, model) -> (gallery rows, enrolled): (1, 4) leaves its last shard
# empty and the third short by a row; (2, 2) its second shard half full
LAYOUTS = {(4, 1): (1024, 512), (1, 4): (4 << 20, (3 << 20) - 1),
           (2, 2): (2 << 20, (3 << 19) - 1)}
REMOVED = "id_1000"  # a row of shard 0: the rows after it move across every boundary
CHUNK = 1 << 20  # device enrolment in chunks of this many rows, each from its own seed
HOST_ROWS_MAX = 8192  # enrolments up to this many rows go through the host
COS_BAR = 0.999
SCORE_ATOL = 1e-5
MAX_NEAR_TIE_SHARE = 1e-3
TRAIN_PER_RANK = 256
TRAIN_CLASSES = 18
TRAIN_IMAGE = 160
TRAIN_DTYPE = "bfloat16"  # bench_train's (TrainConfig's default)
TRAIN_STEPS = 3
TRAIN_RTOL = 1e-3
TIMED_STEPS = 20
POOL = 3  # distinct train batches
RANK_TIMEOUT_S = 900
K1_F32_TOL = {torch.bfloat16: 2e-3, torch.float32: 1e-4}  # K1 against f32 queries, by gallery
NMS_SITES = ("per_scale", "cross_scale", "rnet", "large_face", "final")  # the detect's calls
CROP_SITES = ("rnet", "onet", "align")  # the step's crop calls (the precise align takes none)
# arcface_synth's configuration (outputs/checkpoints/arcface_synth) in the
# command line's flags; the flags have no knob for its scheduler's 2 warm-up
# epochs
CLI_IMAGE = 160
CLI_TRAIN_FLAGS = ["--model-type", "arcface", "--batch-size", "32", "--lr", "5e-4", "--seed", "0", "--arcface-margin", "0.3", "--arcface-scale",
                   "16", "--arcface-easy-margin", "--arcface-warmup", "5",
                   "--arcface-no-two-phase"]
CLI_EPOCHS = 2
CLI_TIMEOUT_S = 900


# -- the forward and the dry run (``__graft_entry__.py``'s) ------------------------------------


def entry(device: str | torch.device | None = None, weights: dict | None = None):
    """(forward, example args): the eval embeddings [8, 512] of the ArcFace
    of 18 classes, bf16 compute on f32 parameters, on a zero batch of
    [8, 112, 112, 3]. ``weights``: a state dict to load in place of the
    seeded initialisation (seed 0)."""
    from facerec_torch import resolve_device
    from facerec_torch.models import get_model
    from facerec_torch.models.arcface import init_like_flax

    dev = resolve_device(device)
    model = get_model("arcface", num_classes=18)
    init_like_flax(model, torch.Generator().manual_seed(0))
    if weights is not None:
        model.load_state_dict(weights)
    model.to(dev).eval()

    @torch.no_grad()
    def forward(image: torch.Tensor) -> torch.Tensor:
        with torch.autocast(dev.type, dtype=torch.bfloat16):
            return model(image.to(dev))

    return forward, (torch.zeros(8, 112, 112, 3, device=dev),)


class _F32Embedder(torch.nn.Module):
    """A net whose ``embed`` takes the serve step's bf16 crops as f32, as
    Flax promotes bf16 input against f32 parameters."""

    def __init__(self, net: torch.nn.Module):
        super().__init__()
        self.net = net

    def embed(self, x: torch.Tensor) -> torch.Tensor:
        return self.net.embed(x.float())


def dryrun_multichip(n_devices: int, model_parallel: int | None = None,
                     device: str | torch.device | None = None, init: dict | None = None,
                     dropout_rate: float = 0.2):
    """``__graft_entry__.dryrun_multichip``: one f32 ArcFace train step
    (batch ``2 n`` of 64 px, 4 classes, AdamW with AMSGrad at 1e-3) and one
    serve step (MTCNN on 64 x 64 frames, a baseline embedder, 5 gallery
    rows sharded over ``model``) on an ``(n / mp, mp)`` mesh, ``mp`` 2 where
    ``n`` is even and at least 4 unless ``model_parallel`` says. Inside a
    process group of ``n`` ranks: this rank's result (its coordinates, the
    metrics, the parameters after the step, the serve result). Without one:
    ``n`` ranks spawned over NCCL, one per card (raises where the machine
    has fewer), and their results. ``init`` maps "arcface", "detector" (a
    JAX parameter tree) and "embedder" to weights that replace the seeded
    ones; ``dropout_rate`` is the ArcFace head's."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        if dist.get_world_size() != n_devices:
            raise ValueError(f"dryrun_multichip({n_devices}) in a process group of "
                             f"{dist.get_world_size()} ranks")
        return _dryrun(n_devices, model_parallel, device, init, dropout_rate)
    require_cards(n_devices)
    return spawn_ranks(_dryrun_rank, n_devices, model_parallel, init, dropout_rate)


def _dryrun_rank(rank: int, world: int, model_parallel, init, dropout_rate) -> dict:
    return _dryrun(world, model_parallel, None, init, dropout_rate)


def _dryrun(n: int, model_parallel: int | None, device, init: dict | None,
            dropout_rate: float) -> dict:
    from facerec_torch.config import MeshConfig, OptimizerConfig, ServeConfig, TrainConfig
    from facerec_torch.detect.mtcnn import MTCNN
    from facerec_torch.detect.mtcnn import init_like_flax as init_detector
    from facerec_torch.models.arcface import ArcFaceNet, init_like_flax
    from facerec_torch.models.baseline import BaselineNet
    from facerec_torch.parallel.mesh import build_mesh, shard_batch, shard_params
    from facerec_torch.serve.pipeline import FacePipeline
    from facerec_torch.train.state import create_train_state
    from facerec_torch.train.steps import make_train_step

    init = init or {}
    mp = model_parallel or (2 if n % 2 == 0 and n >= 4 else 1)
    mesh = build_mesh(MeshConfig(data_parallel=n // mp, model_parallel=mp), device=device)
    dev = mesh.device
    batch = {"image": np.random.default_rng(0).normal(size=(n * 2, 64, 64, 3)).astype(np.float32),
             "label": np.arange(n * 2, dtype=np.int32) % 4,
             "mask": np.ones(n * 2, np.float32)}
    config = TrainConfig(model_type="arcface", batch_size=n * 2, image_size=64, num_classes=4,
                         optimizer=OptimizerConfig(name="adamw", amsgrad=True,
                                                   learning_rate=1e-3),
                         mesh=MeshConfig(data_parallel=n // mp, model_parallel=mp),
                         compute_dtype="float32")
    net = ArcFaceNet(num_classes=4, dropout_rate=dropout_rate)
    state = create_train_state(net, config, "arcface", dev)
    if "arcface" in init:
        net.load_state_dict(init["arcface"])
    shard_params(net, mesh)
    metrics = make_train_step("arcface", "float32", mesh)(state, shard_batch(batch, mesh))
    metrics = {k: float(v) for k, v in metrics.items()}
    loss = metrics["loss_sum"] / metrics["count"]
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite loss {loss}")

    scfg = ServeConfig(max_faces=2, gallery_capacity=32 * mp, top_k=3, embed_size=32,
                       detection_threshold=0.0, recognition_threshold=10.0)
    det = MTCNN((64, 64), min_face_size=24, max_faces=2, k_pnet=8, k_rnet=4, device="cpu")
    if "detector" in init:
        det.load_jax_params(init["detector"])
    else:
        gen = torch.Generator().manual_seed(0)
        for sub in (det.pnet, det.rnet, det.onet):
            init_detector(sub, gen)
    det.device = dev
    det.to(dev)
    emb = BaselineNet(num_classes=4)
    if "embedder" in init:
        emb.load_state_dict(init["embedder"])
    else:
        init_like_flax(emb, torch.Generator().manual_seed(1))
    pipe = FacePipeline(scfg, (64, 64), det, _F32Embedder(emb.to(dev).eval()), embed_dim=512,
                        mesh=mesh)
    rng = np.random.default_rng(0)
    for i in range(5):
        pipe.gallery.add(f"id_{i}", rng.normal(size=512))
    frames = rng.uniform(0, 255, (n // mp, 64, 64, 3)).astype(np.float32)
    r = pipe.process(frames)
    idx = r.match_indices.cpu().numpy()
    if idx.max() >= 5:
        raise AssertionError(f"the serve step matched row {idx.max()}, past the 5 enrolled")
    print(f"dryrun_multichip({n}) rank {mesh.rank}: ok, loss={loss:.4f}, serve step ok "
          f"(mesh {mesh.shape})", flush=True)
    return {"coords": mesh.coords, "shape": dict(mesh.shape), "metrics": metrics,
            "state": {k: v.detach().cpu().numpy() for k, v in net.state_dict().items()},
            "serve": {f: getattr(r, f).float().cpu().numpy() if f != "match_indices"
                      else idx for f in ("valid", "match_indices", "match_scores",
                                         "embeddings")}}


# -- ranks ----------------------------------------------------------------------------------------


def require_cards(n: int) -> None:
    """Raise unless this machine has ``n`` CUDA cards: a layout of ``n``
    ranks runs one rank per card, never on the CPU or on shared cards."""
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < n:
        raise RuntimeError(f"this layout needs {n} CUDA cards, one rank each; the machine has "
                           f"{have}")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn_ranks(fn, world: int, *args, timeout: float = RANK_TIMEOUT_S) -> list:
    """``[fn(rank, world, *args) for rank in range(world)]``, each in its
    own process on card ``rank``, in one NCCL process group over
    ``tcp://localhost``. The parent waits at most ``timeout`` seconds; when
    a rank fails or the time is up, it stops every rank still running and
    raises."""
    ctx = torch.multiprocessing.get_context("spawn")
    port = _free_port()
    with tempfile.TemporaryDirectory(prefix="facerec_ranks_") as out:
        procs = [ctx.Process(target=_rank_main, args=(fn, r, world, port, out, args))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline and any(p.exitcode is None for p in procs):
            if any(p.exitcode not in (None, 0) for p in procs):
                break
            time.sleep(0.2)
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(30)
        codes = [p.exitcode for p in procs]
        found = {r: pickle.loads(Path(out, f"rank{r}.pkl").read_bytes())
                 for r in range(world) if Path(out, f"rank{r}.pkl").exists()}
    for r, (ok, payload) in sorted(found.items()):
        if not ok:
            raise RuntimeError(f"rank {r} of {world} raised:\n{payload}")
    if codes != [0] * world or len(found) != world:
        raise RuntimeError(f"ranks exited {codes} (a rank failed, or the ranks outlasted "
                           f"{timeout:.0f} s)")
    return [found[r][1] for r in range(world)]


def _rank_main(fn, rank: int, world: int, port: int, out: str, args) -> None:
    import torch.distributed as dist

    from facerec_torch.parallel.mesh import initialize_distributed

    os.environ["LOCAL_RANK"] = str(rank)
    initialize_distributed(f"localhost:{port}", world, rank, backend="nccl")
    try:
        result = (True, fn(rank, world, *args))
    except BaseException:  # the parent reports it and stops the other ranks
        result = (False, traceback.format_exc())
    tmp = Path(out, f"rank{rank}.pkl.tmp")
    tmp.write_bytes(pickle.dumps(result))
    tmp.rename(Path(out, f"rank{rank}.pkl"))
    if not result[0]:
        os._exit(1)  # a peer may wait in a collective: no orderly shutdown
    dist.destroy_process_group()


# -- the checks on a rank -------------------------------------------------------------------------


def step_launches(pipe, steps: int = 1) -> dict:
    """The launches of each kernel of ``ops.kernels.TABLE`` that ``steps``
    steps of ``pipe`` make on the card: K1 1 and K2 1 (0 on the precise
    path) a step, the NMS kernel once for each of ``NMS_SITES``, the crop
    kernel once for each of ``CROP_SITES`` (the first two on the precise
    path), and the embedder's epilogue passes (``IResNet.fused_passes``: 99
    for IResNet-100; none for other embedders)."""
    from facerec_torch.models.iresnet import IResNet

    crops = len(CROP_SITES) - (1 if pipe.precise_align else 0)
    passes = pipe.embedder.fused_passes() if isinstance(pipe.embedder, IResNet) else 0
    return {"gallery_topk": steps, "shear_rotate": 0 if pipe.precise_align else steps,
            "nms_suppress": len(NMS_SITES) * steps, "crop_resize": crops * steps,
            "iresnet_epilogue": passes * steps}


def profiled(fn, calls: int = 3) -> dict:
    """torch.profiler over ``calls`` calls of ``fn``: the port kernels
    launched by name per call, device ms per call (kernels and copies), and
    the busy share of the wall time (a lower bound: the profiler's host
    cost lengthens the wall)."""
    from torch.profiler import ProfilerActivity, profile

    from facerec_torch.ops.kernels import TABLE
    from facerec_torch.utils import profiling

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = profiling.device_ops(prof)
    busy_us = sum(e.self_device_time_total for e in kernels)
    nccl_us = sum(e.self_device_time_total for e in kernels if "nccl" in e.key.lower())
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    return {"by_kernel_name": {k: sum(e.count for e in kernels if t.profiler_name in e.key) / calls
                               for k, t in TABLE.items()},
            "device_ms": busy_us / calls / 1e3, "nccl_device_ms": nccl_us / calls / 1e3,
            "busy_share": busy_us / wall_us if wall_us else None,
            "top_kernels_ms": {e.key[:70]: e.self_device_time_total / calls / 1e3 for e in top}}


def k1_case(q: torch.Tensor, gallery: torch.Tensor, count: int, k: int, f32_tol: float) -> dict:
    """K1 on queries ``q`` [B, D] against the first ``count`` rows of
    ``gallery``, beside its plain version fed the queries as the kernel
    rounds them (to the gallery dtype) and fed f32 queries: the largest
    score error over the valid slots against each, the near-tie slots
    (indices that differ from the rounded plain version's), the largest gap
    between the two rows' plain scores there, whether the masked slots are
    equal, and ``within``: every bar but the near ties' share (errors and
    gap within ``SCORE_ATOL``, masked slots equal, within ``f32_tol`` of the
    f32 queries)."""
    from facerec_torch.ops.gallery import gallery_topk, gallery_topk_plain

    cnt = torch.tensor(count, dtype=torch.int32, device=q.device)
    v1, i1 = gallery_topk(q, gallery, cnt, k=k)
    v0, i0 = gallery_topk_plain(q.to(gallery.dtype), gallery, cnt, k=k)
    vf, _ = gallery_topk_plain(q, gallery, cnt, k=k)
    nv = min(count, k)
    masked_equal = bool(torch.equal(i1[:, nv:], i0[:, nv:]) and torch.equal(v1[:, nv:], v0[:, nv:]))
    differ = i1[:, :nv] != i0[:, :nv]
    near, gap = int(differ.sum()), 0.0
    if near:
        s1 = (q.to(gallery.dtype).float()[:, None, :] * gallery[i1[:, :nv].long()].float()).sum(-1)
        gap = (s1 - v0[:, :nv]).abs()[differ].max().item()
    out = {"max_abs_err": (v1 - v0)[:, :nv].abs().max().item() if nv else 0.0,
           "f32_err": (v1 - vf)[:, :nv].abs().max().item() if nv else 0.0,
           "near_tie_slots": near, "slots": differ.numel(), "near_tie_gap": gap,
           "masked_equal": masked_equal,
           "rows_differing": differ.any(dim=1).nonzero().flatten()[:3].tolist()}
    out["within"] = (masked_equal and out["max_abs_err"] <= SCORE_ATOL and gap <= SCORE_ATOL
                     and out["f32_err"] <= f32_tol)
    return out


def _ordered_bf16(t: torch.Tensor) -> torch.Tensor:
    """bf16 values as integers in their order: neighbours differ by 1."""
    i = t.contiguous().view(torch.int16).int()
    return torch.where(i >= 0, i, -(i + 32768))


def _epilogue_kind(kw: dict) -> str:
    if kw.get("prelu") is not None:
        return "stem" if kw.get("next_bn") is not None else "a"
    if not kw.get("keep", True):
        return "last"
    return "b_downsample" if kw.get("shortcut_bn") is not None else "b_identity"


def record_epilogues(pipe, crops: torch.Tensor) -> dict:
    """Each epilogue pass of one eager embed of ``crops`` by ``pipe``'s
    embedder (``kernels.recording``), held against its plain twin, grouped
    by kind and shape: {(kind, shape): {"calls", "args" (the first call's
    map, BatchNorm and keywords), "max_ulp" (the largest gap in bf16 ulps),
    "differ" and "values" (the values that differ, of all written)}}."""
    from facerec_torch.ops import kernels
    from facerec_torch.ops.iresnet_epilogue import iresnet_epilogue, iresnet_epilogue_plain

    with kernels.recording("iresnet_epilogue") as calls, torch.no_grad():
        pipe.embedder.embed(crops)
    groups = {}
    for (a, bn), kw in calls:
        g = groups.setdefault((_epilogue_kind(kw), tuple(a.shape)),
                              {"calls": 0, "args": (a, bn, kw), "max_ulp": 0, "differ": 0,
                               "values": 0})
        g["calls"] += 1
        with torch.no_grad():
            outs = zip(iresnet_epilogue(a, bn, **kw), iresnet_epilogue_plain(a, bn, **kw))
        for got, want in outs:
            if got is not None:
                ulps = (_ordered_bf16(got) - _ordered_bf16(want)).abs()
                g["max_ulp"] = max(g["max_ulp"], int(ulps.max().item()))
                g["differ"] += int((ulps > 0).sum().item())
                g["values"] += ulps.numel()
    return groups


def record_step(pipe, x: torch.Tensor, r,
                names: tuple[str, ...] = ("nms_suppress", "crop_resize", "shear_rotate")) -> dict:
    """The wrapper calls, (args, kwargs) in call order, of each kernel in
    ``names`` that one eager detect of frames ``x`` by ``pipe`` and its
    align of the step ``r``'s boxes and landmarks make
    (``kernels.recording``), and the crops [B, F, S, S, 3] under
    ``"crops"``."""
    from facerec_torch.ops import kernels

    with contextlib.ExitStack() as stack, torch.no_grad():
        calls = {name: stack.enter_context(kernels.recording(name)) for name in names}
        pipe.detector.detect(x)
        lm = torch.where(r.valid[..., None, None], r.landmarks, pipe._default_lmk)
        calls["crops"] = pipe.align(x, r.boxes, lm)
    return calls


def hold_kernels(pipe, x: torch.Tensor, r) -> dict:
    """Each kernel of ``pipe``'s step against its plain twin, on the inputs
    the step ``r`` of frames ``x`` gives it on this rank:

      * K1 on the step's embeddings against the rank's gallery rows and
        valid count: ``k1_case``'s bars, within ``K1_F32_TOL`` of the f32
        queries, near ties at most ``MAX_NEAR_TIE_SHARE`` of the slots;
      * on the calls of one eager detect and align (``record_step``): the
        NMS kernel on each of its calls (``NMS_SITES``), keep and rounds;
        the crop kernel on each of its calls (``CROP_SITES``, the first two
        on the precise path); K2 on its call (none on the precise path);
        each bit for bit;
      * where the embedder has epilogue passes (``step_launches``), each pass
        of one eager embed of those crops within one bf16 ulp
        (``record_epilogues``).

    Returns each kernel's largest error (bf16 ulps for the epilogue) with
    K1's near ties and each NMS call's rounds (max, mean); raises where a
    count of calls or a value disagrees."""
    from facerec_torch.ops import kernels
    from facerec_torch.ops.crop_kernel import crop_resize_kernel
    from facerec_torch.ops.nms import nms_suppress
    from facerec_torch.ops.warp_kernel import rotate_patches_kernel

    g, cfg = pipe.gallery, pipe.config
    q = r.embeddings.reshape(-1, r.embeddings.shape[-1]).float()
    k1 = k1_case(q, g.embeddings, g.local_count, cfg.top_k, K1_F32_TOL[g.dtype])
    out = {"gallery_topk": k1["max_abs_err"], "k1_f32_err": k1["f32_err"],
           "k1_near_tie_slots": k1["near_tie_slots"], "k1_local_count": g.local_count}
    if not (k1["within"] and k1["near_tie_slots"] <= MAX_NEAR_TIE_SHARE * k1["slots"]):
        raise AssertionError(f"K1 disagrees with its plain version: {k1}")

    want = step_launches(pipe)
    wrappers = {"nms_suppress": nms_suppress, "crop_resize": crop_resize_kernel,
                "shear_rotate": rotate_patches_kernel}
    calls = record_step(pipe, x, r, tuple(wrappers))
    for name, fn in wrappers.items():
        if len(calls[name]) != want[name]:
            raise AssertionError(f"the step made {len(calls[name])} {name} calls, not "
                                 f"{want[name]}")
        for i, (args, kw) in enumerate(calls[name]):
            got, ref = (t if isinstance(t, tuple) else (t,)
                        for t in (fn(*args, **kw), kernels.plain(name)(*args, **kw)))
            if not all(map(torch.equal, got, ref)):
                raise AssertionError(f"the {name} kernel disagrees with its plain version on "
                                     f"call {i} of the step")
            if name == "nms_suppress":
                out.setdefault("nms_rounds", {})[NMS_SITES[i]] = [int(got[1].max()),
                                                                   got[1].float().mean().item()]
        if want[name]:
            out[name] = 0.0  # bit for bit
    if want["iresnet_epilogue"]:
        s = cfg.embed_size
        groups = record_epilogues(pipe, calls["crops"].reshape(-1, s, s, 3))
        passes = sum(v["calls"] for v in groups.values())
        out["iresnet_epilogue"] = max(v["max_ulp"] for v in groups.values())
        if passes != want["iresnet_epilogue"] or out["iresnet_epilogue"] > 1:
            raise AssertionError(f"the embed made {passes} epilogue passes, the largest "
                                 f"{out['iresnet_epilogue']} bf16 ulps from the plain route")
    return out


# -- serving --------------------------------------------------------------------------------------


def serve_parts(dev: torch.device) -> tuple:
    """``bench.py``'s detector and embedder on ``dev`` (``facerec_torch.bench``'s)."""
    from facerec_torch.bench import build_pipeline

    pipe = build_pipeline(FRAME_HW, 8, 32, dev)
    return pipe.detector, pipe.embedder


def serve_config(rows: int):
    from facerec_torch.config import ServeConfig

    return ServeConfig(max_faces=FACES, gallery_capacity=rows, top_k=5, embed_size=160,
                       detection_threshold=0.0)


def enroll(gallery, n: int) -> None:
    """``n`` seeded rows: up to ``HOST_ROWS_MAX`` from ``default_rng(1)``
    through the host, beyond that in chunks of ``CHUNK`` normals made on the card, chunk
    ``c`` from seed ``11 + c`` (the same rows on every rank and card)."""
    if n <= HOST_ROWS_MAX:
        rows = np.random.default_rng(1).normal(size=(n, gallery.dim)).astype(np.float32)
        gallery.add_many([f"id_{i}" for i in range(n)], rows)
        return
    for c, start in enumerate(range(0, n, CHUNK)):
        m = min(CHUNK, n - start)
        gen = torch.Generator(device=gallery.device).manual_seed(11 + c)
        rows = torch.randn(m, gallery.dim, generator=gen, device=gallery.device)
        gallery.add_many_device([f"id_{i}" for i in range(start, start + m)], rows)
        del rows


def _matches(r) -> dict:
    return {"valid": r.valid.cpu(), "idx": r.match_indices.cpu(),
            "scores": r.match_scores.cpu()}


def near_ties(q, gallery, ref_idx, got_idx) -> tuple[int, float]:
    """Slots whose index differs from one process's, and the largest gap
    between the two rows' one-process scores there (queries rounded to the
    gallery dtype, as K1 rounds them)."""
    differ = got_idx != ref_idx
    if not differ.any():
        return 0, 0.0
    qq = q.to(gallery.dtype).float()[:, None, :].expand(-1, ref_idx.shape[1], -1)[differ]
    a = (qq * gallery[ref_idx[differ].long()].float()).sum(-1)
    b = (qq * gallery[got_idx[differ].long()].float()).sum(-1)
    return int(differ.sum()), (a - b).abs().max().item()


def serve_layout(dp: int, mp: int, frames: np.ndarray, det, emb, tmp: str) -> dict:
    """One serve layout on this rank (module docstring). Returns its launches,
    holds, timings and agreement; raises on any failed check."""
    from facerec_torch.config import MeshConfig
    from facerec_torch.ops import kernels
    from facerec_torch.parallel.mesh import build_mesh
    from facerec_torch.serve.pipeline import FacePipeline

    rows, enrolled = LAYOUTS[(dp, mp)]
    name = f"{dp}x{mp}"
    mesh = build_mesh(MeshConfig(data_parallel=dp, model_parallel=mp))
    rank, dev = mesh.rank, mesh.device
    pipe = FacePipeline(serve_config(rows), FRAME_HW, det, emb, embed_dim=512, mesh=mesh)
    t0 = time.perf_counter()
    enroll(pipe.gallery, enrolled)
    torch.cuda.synchronize()
    enroll_s = time.perf_counter() - t0
    batch = frames[:PER_RANK * dp]
    x = pipe.upload(batch)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    pipe.run_step(x)  # the warm-ups, the capture, one replay
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    kernels.zero()
    r = pipe.run_step(x)
    torch.cuda.synchronize()
    counted = kernels.launches()
    eager = pipe.step(x)
    graph_equal = {f: bool(torch.equal(a, b)) for f, a, b in zip(r._fields, r, eager)}
    by_name = profiled(lambda: pipe.run_step(x), calls=1)["by_kernel_name"]
    held = hold_kernels(pipe, x, r)
    stats = pipe.benchmark(batch, iters=10, warmup=2)
    busy = profiled(lambda: pipe.run_step(x))
    out = {"layout": name, "rank": rank, "coords": mesh.coords, "gallery_rows": rows,
           "enrolled": enrolled, "local_count": pipe.gallery.local_count,
           "frames": int(x.shape[0]), "enroll_s": enroll_s, "capture_s": capture_s,
           "max_memory_gb": torch.cuda.max_memory_allocated(dev) / 2**30,
           "launches": counted, "launches_by_kernel_name": by_name, "graph_equal": graph_equal,
           "held": held, "faces_per_sec": stats["faces_per_sec"],
           "step_ms": stats["sec_per_batch"] * 1e3,
           "host_ms": stats["host_sec_per_batch"] * 1e3,
           "device_ms": busy["device_ms"], "nccl_device_ms": busy["nccl_device_ms"],
           "busy_share": busy["busy_share"], "top_kernels_ms": busy["top_kernels_ms"]}
    faults = []
    if counted != step_launches(pipe) or by_name != step_launches(pipe):
        faults.append(f"one replay launched {counted} (by kernel name {by_name})")
    if not all(graph_equal.values()):
        faults.append(f"the replay differs from the eager mesh step: {graph_equal}")
    mine = {"before": _matches(r), "embeddings": r.embeddings.float().cpu()}
    if mp > 1:
        pipe.gallery.remove(REMOVED)
        mine["after"] = _matches(pipe.run_step(x))
    del pipe, r, eager, x
    torch.cuda.empty_cache()
    if mp == 1:
        out["agreement"] = _agree_one_card(mesh, frames, det, emb, rows, enrolled, mine)
    else:
        torch.save(mine, f"{tmp}/{name}_rank{rank}.pt")
        mesh.barrier()
        if mesh.is_primary:
            out["agreement"] = _agree_merged(mesh, dp, mp, frames, det, emb, rows, enrolled, tmp)
        mesh.barrier()
    if faults:
        raise AssertionError(f"the {name} layout, rank {rank}: " + "; ".join(faults))
    print(f"multichip serve {name} rank {rank}: " + json.dumps({k: out[k] for k in (
        "local_count", "launches", "held", "faces_per_sec", "step_ms", "busy_share",
        "capture_s", "max_memory_gb")} | {"replay_equals_eager": all(graph_equal.values())}),
        flush=True)
    return out


def _agree_one_card(mesh, frames, det, emb, rows, enrolled, mine) -> dict:
    """(4, 1): this rank's results against one process's captured step on
    the same 48 frames on this card."""
    from facerec_torch.serve.pipeline import FacePipeline

    ref = FacePipeline(serve_config(rows), FRAME_HW, det, emb, embed_dim=512, device=mesh.device)
    enroll(ref.gallery, enrolled)
    d = mesh.index(mesh.data_axis)
    one = ref.process(frames[d * PER_RANK:(d + 1) * PER_RANK])
    got = mine["before"]
    valid = one.valid.cpu()
    cos = (mine["embeddings"] * one.embeddings.float().cpu()).sum(-1)[valid]
    out = {"same_valid": bool(torch.equal(got["valid"], valid)),
           "same_idx": bool(torch.equal(got["idx"], one.match_indices.cpu())),
           "embeddings_bit_for_bit": bool(torch.equal(mine["embeddings"],
                                                      one.embeddings.float().cpu())),
           "min_cos": cos.min().item() if cos.numel() else None,
           "valid_slots": int(valid.sum())}
    if not (out["same_valid"] and out["same_idx"] and cos.numel() and out["min_cos"] > COS_BAR):
        raise AssertionError(f"the (4, 1) layout, rank {mesh.rank}, disagrees with one "
                             f"process: {out}")
    return out


def _agree_merged(mesh, dp, mp, frames, det, emb, rows, enrolled, tmp) -> dict:
    """(1, 4), (2, 2), on rank 0: every rank's merged top 5 against one
    process's K1 over the whole gallery on this card, before and after the
    remove (indices equal but for near-ties within ``SCORE_ATOL``, at most
    ``MAX_NEAR_TIE_SHARE`` of the slots; scores within ``SCORE_ATOL``; the
    same valid slots)."""
    from facerec_torch.serve.pipeline import FacePipeline

    ref = FacePipeline(serve_config(rows), FRAME_HW, det, emb, embed_dim=512, device=mesh.device)
    enroll(ref.gallery, enrolled)
    frames_of = [frames[d * PER_RANK:(d + 1) * PER_RANK] for d in range(dp)]
    got = [torch.load(f"{tmp}/{dp}x{mp}_rank{r}.pt") for r in range(mesh.world_size)]
    out = {f"rank{r}": {} for r in range(mesh.world_size)}
    for when in ("before", "after"):
        if when == "after":
            ref.gallery.remove(REMOVED)
        one = [ref.process(f) for f in frames_of]
        for r, mine in enumerate(got):
            o, g = one[r // mp], mine[when]
            # near-ties read the one-process gallery as it stands at this point
            ties, gap = near_ties(o.embeddings.reshape(-1, 512).float(), ref.gallery.embeddings,
                                   o.match_indices.reshape(-1, 5),
                                   g["idx"].to(mesh.device).reshape(-1, 5))
            v = {"same_valid": bool(torch.equal(g["valid"].to(mesh.device), o.valid)),
                 "near_tie_slots": ties, "near_tie_gap": gap,
                 "max_score_err": (g["scores"].to(mesh.device) - o.match_scores).abs().max().item()}
            out[f"rank{r}"][when] = v
            if not (v["same_valid"] and v["max_score_err"] <= SCORE_ATOL
                    and v["near_tie_gap"] <= SCORE_ATOL
                    and v["near_tie_slots"] <= MAX_NEAR_TIE_SHARE * o.match_indices.numel()):
                raise AssertionError(f"the ({dp}, {mp}) layout, rank {r}, {when} the remove, "
                                     f"disagrees with one process: {v}")
    return out


# -- training -------------------------------------------------------------------------------------


def _params(state) -> torch.Tensor:
    return torch.cat([p.detach().float().reshape(-1) for p in state.model.parameters()])


def _against_one(state, twin, mu_before: list[torch.Tensor]) -> dict:
    """A data-parallel step (``state``) against one process's from the same
    state (``twin``): the relative L2 difference of the gradients (after
    clipping; each recovered from the step's first moment, ``(mu - b1
    mu_before) / (1 - b1)``) and of the parameters after the step."""
    b1 = twin.opt_state.config.beta1
    g = [torch.cat([((m - b1 * m0) / (1 - b1)).reshape(-1) for m, m0 in zip(st.opt_state.slots[
        "mu"], mu_before)]) for st in (state, twin)]
    a, b = _params(state), _params(twin)
    return {"grads_l2": ((g[0] - g[1]).norm() / g[1].norm()).item(),
            "params_l2": ((a - b).norm() / b.norm()).item()}


def _rel(a: float, b: float) -> float:
    return abs(a - b) / abs(b) if b else abs(a - b)


@contextlib.contextmanager
def plain_batch_norm():
    """Within the block the data-parallel BatchNorm runs its plain version on
    the card too (``resnet.global_batch_norm_plain``): the yardstick that
    ``train_layout`` times the native function against. A step captured
    inside keeps it."""
    from facerec_torch.models import resnet

    native = resnet.global_batch_norm
    resnet.global_batch_norm = resnet.global_batch_norm_plain
    try:
        yield
    finally:
        resnet.global_batch_norm = native


def train_layout(world: int) -> dict:
    """The (world, 1) train step at ``bench_train``'s ArcFace (module
    docstring): captured against eager under deterministic cuDNN, each
    captured step against one process's step on the global batch (rank 0,
    on a copy of the state; held in f32), then the step's time with the
    default cuDNN algorithms, and the NCCL all-reduce at the gradient's
    size."""
    import torch.distributed as dist

    from facerec_torch.config import MeshConfig, TrainConfig
    from facerec_torch.models import get_model
    from facerec_torch.parallel.collectives import all_reduce_
    from facerec_torch.parallel.mesh import batch_sharding, build_mesh, shard_params
    from facerec_torch.train.state import create_train_state
    from facerec_torch.train.steps import make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False  # as train_model sets them
    torch.backends.cudnn.allow_tf32 = False
    mesh = build_mesh(MeshConfig(data_parallel=world))
    dev, n = mesh.device, TRAIN_PER_RANK * world
    gen = torch.Generator(device=dev).manual_seed(0)
    pool = [{"image": torch.randn(n, TRAIN_IMAGE, TRAIN_IMAGE, 3, generator=gen, device=dev),
             "label": torch.randint(0, TRAIN_CLASSES, (n,), generator=gen, device=dev,
                                    dtype=torch.int32)} for _ in range(POOL)]
    rows = batch_sharding(mesh, n)
    local = [{k: v[rows].contiguous() for k, v in b.items()} for b in pool]
    cfg = TrainConfig(model_type="arcface", batch_size=n, num_classes=TRAIN_CLASSES, seed=0,
                      compute_dtype=TRAIN_DTYPE)
    base = create_train_state(get_model("arcface", num_classes=TRAIN_CLASSES), cfg, "arcface",
                              dev)
    shard_params(base.model, mesh)

    def run(dtype: str, captured: bool, against_one: bool = False):
        state = copy.deepcopy(base)
        step = make_train_step("arcface", dtype, mesh)
        one = make_train_step("arcface", dtype) if against_one else None
        metrics, per_step = [], []
        for i in range(TRAIN_STEPS):
            twin = copy.deepcopy(state) if one is not None and mesh.is_primary else None
            m = (step if captured else step.eager)(state, local[i % POOL])
            metrics.append({k: float(m[k]) for k in ("loss_sum", "count", "grad_norm")})
            if twin is not None:
                mu_before = [t.clone() for t in twin.opt_state.slots["mu"]]
                m1 = one.eager(twin, pool[i % POOL])
                per_step.append({"loss": _rel(metrics[-1]["loss_sum"] / metrics[-1]["count"],
                                              float(m1["loss_sum"] / m1["count"])),
                                 "grad_norm": _rel(metrics[-1]["grad_norm"],
                                                   float(m1["grad_norm"]))}
                                | _against_one(state, twin, mu_before))
                del twin, mu_before
        return metrics, _params(state), per_step

    # bench_train's bf16 steps: captured against eager. The agreement with one
    # process is held in f32: in bf16 the sharded and the whole batch's
    # steps round differently at about 1e-3 of the loss (module docstring)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        eager_a, params_a, _ = run(TRAIN_DTYPE, False)
        eager_b, params_b, _ = run(TRAIN_DTYPE, False)
        captured, params_c, per_step_bf16 = run(TRAIN_DTYPE, True, against_one=True)
        _, _, per_step = run("float32", True, against_one=True)
        with plain_batch_norm():
            _, _, per_step_plain = run("float32", True, against_one=True)
    finally:
        torch.backends.cudnn.deterministic = deterministic

    def drift(ms, pa, ref, pref) -> dict:
        return {"loss_sum": max(_rel(x["loss_sum"], y["loss_sum"]) for x, y in zip(ms, ref)),
                "grad_norm": max(_rel(x["grad_norm"], y["grad_norm"]) for x, y in zip(ms, ref)),
                "params_l2": ((pa - pref).norm() / pref.norm()).item()}

    eager_self_equal = eager_a == eager_b and torch.equal(params_a, params_b)
    captured_equal = captured == eager_a and torch.equal(params_c, params_a)
    out = {"rank": mesh.rank, "global_batch": n, "steps": TRAIN_STEPS,
           "eager_equals_itself": eager_self_equal, "captured_equals_eager": captured_equal,
           "captured_against_eager_drift": drift(captured, params_c, eager_a, params_a),
           "eager_against_eager_drift": drift(eager_b, params_b, eager_a, params_a),
           "metrics": captured, "per_step_against_one_process": per_step,
           "per_step_against_one_process_plain_batch_norm": per_step_plain,
           "per_step_against_one_process_bf16": per_step_bf16}
    del params_a, params_b, params_c
    torch.cuda.empty_cache()

    def timed() -> dict:
        """The captured step's time, with cuDNN's default algorithms as
        bench_train takes it, and its profile."""
        state = copy.deepcopy(base)
        step = make_train_step("arcface", cfg.compute_dtype, mesh)
        for i in range(3):  # the first call captures
            step(state, local[i % POOL])
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(TIMED_STEPS):
            step(state, local[i % POOL])
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / TIMED_STEPS
        prof = profiled(lambda: step(state, local[0]))
        del step, state
        torch.cuda.empty_cache()
        return {"step_ms": ms, "images_per_sec": n / (ms * 1e-3), "device_ms": prof["device_ms"],
                "nccl_device_ms": prof["nccl_device_ms"], "busy_share": prof["busy_share"],
                "top_kernels_ms": prof["top_kernels_ms"]}

    # the native global BatchNorm against its plain version, in turns:
    # native, plain, plain, native
    turns = []
    for kind in ("native", "plain", "plain", "native"):
        with plain_batch_norm() if kind == "plain" else contextlib.nullcontext():
            turns.append(dict(timed(), batch_norm=kind))
    native = [t for t in turns if t["batch_norm"] == "native"]
    out.update({k: sum(t[k] for t in native) / 2 for k in ("step_ms", "device_ms",
                                                           "nccl_device_ms", "busy_share")})
    out["images_per_sec"] = n / (out["step_ms"] * 1e-3)
    out["top_kernels_ms"] = native[-1]["top_kernels_ms"]
    out["batch_norm_turns"] = turns

    # the gradient's all-reduce on its own: one flat f32 tensor of every parameter
    numel = sum(p.numel() for p in base.model.parameters())
    grad = torch.ones(numel, device=dev)
    group = mesh.group(mesh.data_axis)
    for _ in range(5):
        all_reduce_(grad, group)
    torch.cuda.synchronize()
    dist.barrier()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(TIMED_STEPS):
        all_reduce_(grad.mul_(0.25), group)
    end.record()
    torch.cuda.synchronize()
    ar_ms = start.elapsed_time(end) / TIMED_STEPS
    alg = numel * 4 / (ar_ms * 1e-3) / 1e9
    out["allreduce"] = {"bytes": numel * 4, "ms": ar_ms, "algorithm_gb_per_s": alg,
                        "bus_gb_per_s": alg * 2 * (world - 1) / world}
    faults = []
    if eager_self_equal and not captured_equal:
        faults.append("the captured steps differ from the eager steps, which equal themselves")
    # the first step from zero Adam moments moves each parameter by the
    # learning rate times its gradient's sign: where a gradient cancels to
    # near 0, any two f32 roundings of the step can pick either sign, so its
    # parameters are printed (module docstring)
    if any(max(s["loss"], s["grad_norm"]) > TRAIN_RTOL for s in per_step) or any(
            s["params_l2"] > TRAIN_RTOL for s in per_step[1:]):
        faults.append(f"an f32 step is not within {TRAIN_RTOL} of one process's: {per_step}")
    print(f"multichip train {world}x1 rank {mesh.rank}: " + json.dumps(
        {k: v for k, v in out.items() if k != "metrics"}), flush=True)
    if faults:
        raise AssertionError(f"the ({world}, 1) train step, rank {mesh.rank}: "
                             + "; ".join(faults))
    return out


# -- the run --------------------------------------------------------------------------------------


def _full_rank(rank: int, world: int, tmp: str) -> dict:
    """One rank of the full-width run: the dry run, the three serve layouts,
    the train step and the all-reduce."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    dry = _dryrun(world, None, None, None, 0.2)
    out = {"dryrun": {k: dry[k] for k in ("coords", "shape", "metrics")}}
    frames = np.load(f"{tmp}/frames.npy")
    det, emb = serve_parts(torch.device("cuda", torch.cuda.current_device()))
    for dp, mp in LAYOUTS:
        out[f"{dp}x{mp}"] = serve_layout(dp, mp, frames, det, emb, tmp)
    del det, emb
    torch.cuda.empty_cache()
    out["train"] = train_layout(world)
    out["seconds"] = time.perf_counter() - t0
    if "jax" in sys.modules:
        raise AssertionError("a rank imported jax")
    return out


def _run(cmd: list[str], env: dict, what: str) -> tuple[str, float]:
    """``cmd``'s stdout and stderr together, and its seconds; raises where it
    fails."""
    t0 = time.perf_counter()
    res = subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True, text=True,
                         timeout=CLI_TIMEOUT_S)
    secs = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError(f"{what} exited {res.returncode}: {' '.join(cmd)}\n"
                           f"{res.stdout[-4000:]}\n{res.stderr[-8000:]}")
    return res.stdout + res.stderr, secs


def cli_train_and_evaluate(work: Path, dataset: Path, device: str = "cuda") -> dict:
    """``train`` and ``evaluate`` through the command line under
    ``torchrun`` on every card (``FACEREC_COORDINATOR=auto``; outputs under
    ``FACEREC_ROOT=work``); then the checkpoint loaded in this process and
    ``evaluate_model`` on one card against the four ranks' results.
    ``device="cpu"`` runs the same over gloo on the CPU."""
    from facerec_torch.config import EvalConfig
    from facerec_torch.eval.engine import evaluate_model
    from facerec_torch.train.checkpoints import load_checkpoint

    env = dict(os.environ, FACEREC_COORDINATOR="auto", FACEREC_ROOT=str(work),
               PYTHONPATH=os.pathsep.join(filter(None, [str(ROOT), os.environ.get("PYTHONPATH")])))
    # torchrun, as this interpreter's module
    launch = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", str(CARDS), "-m",
              "facerec_torch.cli.main", "--device", device]
    log, train_s = _run([*launch, "train", "--dataset", str(dataset), "--model-name", "mc",
                       "--epochs", str(CLI_EPOCHS), "--image-size", str(CLI_IMAGE),
                       *CLI_TRAIN_FLAGS], env, "torchrun train")
    ckroot = work / "outputs" / "checkpoints"
    ck = load_checkpoint(ckroot / "mc")
    info = json.loads((ckroot / "mc" / "model_info.json").read_text())
    mesh = next((line for line in log.splitlines() if "(mesh {" in line), "")
    if f"'data': {CARDS}" not in mesh:
        raise AssertionError(f"torchrun's train did not run at data {CARDS}: {mesh!r}")
    _, eval_s = _run([*launch, "evaluate", "--model-type", "arcface", "--model-name", "mc",
                      "--dataset", str(dataset), "--image-size", str(CLI_IMAGE)], env,
                     "torchrun evaluate")
    four = json.loads((work / "outputs" / "mc" / "arcface_results.json").read_text())
    one = evaluate_model(EvalConfig(model_type="arcface", model_name="mc", image_size=CLI_IMAGE),
                         dataset, checkpoints_root=ckroot, outputs_root=work / "one",
                         device="cuda:0" if device == "cuda" else device)
    keys = ("accuracy", "precision", "recall", "f1", "roc_auc", "pr_auc", "num_test_images")
    out = {"train_s": train_s, "evaluate_s": eval_s, "mesh": mesh[mesh.index("(mesh "):],
           **{k: info[k] for k in ("epochs_trained", "best_val_acc", "test_acc")},
           "checkpoint_tensors": len(ck["model"]),
           "four_ranks": {k: four[k] for k in keys}, "one_process": {k: one[k] for k in keys},
           "same_confusion": four["confusion"] == one["confusion"],
           "same_per_class": four["per_class"] == one["per_class"]}
    print("multichip command line: " + json.dumps(out), flush=True)
    same = all(four[k] == one[k] for k in ("accuracy", "num_test_images"))
    close = all(abs(four[k] - one[k]) <= 1e-3 for k in keys)
    if not (same and close and out["same_confusion"] and out["same_per_class"]):
        raise AssertionError(f"evaluate_model over four ranks differs from one process: {out}")
    return out


def _layout_summary(ranks: list[dict], key: str) -> dict:
    dp = int(key.split("x")[0])
    rows = [r[key] for r in ranks]
    step_ms = max(r["step_ms"] for r in rows)
    return {"aggregate_faces_per_sec": dp * PER_RANK * FACES / (step_ms * 1e-3),
            "faces_per_sec_by_rank": [r["faces_per_sec"] for r in rows],
            "step_ms_by_rank": [r["step_ms"] for r in rows],
            "device_ms_by_rank": [r["device_ms"] for r in rows],
            "nccl_device_ms_by_rank": [r["nccl_device_ms"] for r in rows],
            "busy_share_by_rank": [r["busy_share"] for r in rows],
            "capture_s_by_rank": [r["capture_s"] for r in rows],
            "max_memory_gb_by_rank": [r["max_memory_gb"] for r in rows],
            "gallery_rows": rows[0]["gallery_rows"], "enrolled": rows[0]["enrolled"],
            "local_count_by_rank": [r["local_count"] for r in rows],
            "launches_by_rank": [r["launches"] for r in rows],
            "held_by_rank": [r["held"] for r in rows],
            "agreement": [r.get("agreement") for r in rows if r.get("agreement")]}


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="python -m facerec_torch.multichip",
                                description="the mesh path at full width on four cards")
    p.add_argument("--timeout", type=float, default=RANK_TIMEOUT_S,
                   help="seconds the ranks may take together")
    p.add_argument("--out", default=None, help="also write the whole summary (JSON) here")
    args = p.parse_args(argv)
    require_cards(CARDS)
    from facerec_torch import build
    from facerec_torch.bench import card_label
    from facerec_torch.data.synthetic import face_frames, write_synthetic_imagefolder

    t_run = time.perf_counter()
    cards = [card_label(torch.device("cuda", i)) for i in range(CARDS)]
    for i, line in enumerate(cards):
        print(f"card {i}: {line}", flush=True)
    topo = subprocess.run(["nvidia-smi", "topo", "-m"], capture_output=True, text=True,
                          timeout=60)
    print("nvidia-smi topo -m:\n" + topo.stdout, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} nccl "
          f"{'.'.join(map(str, torch.cuda.nccl.version()))}", flush=True)
    print(f"build: {len(build.SOURCES)} kernels in {build.build(force=True):.1f} s", flush=True)

    with tempfile.TemporaryDirectory(prefix="facerec_multichip_") as td:
        tmp = Path(td)
        # one card's bench_train, beside the frames' rendering on the host
        bench = subprocess.Popen([sys.executable, "-m", "facerec_torch.bench_train"], cwd=ROOT,
                                 env=dict(os.environ, CUDA_VISIBLE_DEVICES="0"),
                                 stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        t0 = time.perf_counter()
        frames = face_frames(PER_RANK * CARDS, FRAME_HW, FACES, np.random.default_rng(0))
        np.save(tmp / "frames.npy", frames)
        dataset = write_synthetic_imagefolder(tmp / "ds", num_classes=16, per_class=40,
                                              size=160, seed=0)
        print(f"rendered {len(frames)} frames and the 16 x 40 dataset in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        b_out, b_err = bench.communicate(timeout=CLI_TIMEOUT_S)
        if bench.returncode != 0:
            raise RuntimeError(f"bench_train exited {bench.returncode}:\n{b_err[-4000:]}")
        one_card = json.loads(b_out.strip().splitlines()[-1])
        print(f"bench_train on one card: {json.dumps(one_card)}; {b_err.strip()}", flush=True)
        del frames

        t0 = time.perf_counter()
        ranks = spawn_ranks(_full_rank, CARDS, str(tmp), timeout=args.timeout)
        ranks_s = time.perf_counter() - t0
        summary = {"cards": cards, "ranks_s": ranks_s,
                   "dryrun": [r["dryrun"] for r in ranks]}
        for dp, mp in LAYOUTS:
            key = f"{dp}x{mp}"
            summary[key] = _layout_summary(ranks, key)
            print(f"multichip serve {key}: " + json.dumps({k: v for k, v in summary[key].items()
                                                           if k not in ("held_by_rank",
                                                                        "agreement")}),
                  flush=True)
        train = [r["train"] for r in ranks]
        step_ms = max(t["step_ms"] for t in train)
        images = train[0]["global_batch"] / (step_ms * 1e-3)
        per_turn = [max(t["batch_norm_turns"][i]["step_ms"] for t in train)
                    for i in range(len(train[0]["batch_norm_turns"]))]
        summary["train"] = {
            "step_ms_by_rank": [t["step_ms"] for t in train], "images_per_sec": images,
            "one_card_bench_train": one_card,
            "scaling": images / (CARDS * one_card["train_imgs_per_sec"]),
            "busy_share_by_rank": [t["busy_share"] for t in train],
            "device_ms_by_rank": [t["device_ms"] for t in train],
            "nccl_device_ms_by_rank": [t["nccl_device_ms"] for t in train],
            # the native and the plain global BatchNorm in turns: the slowest rank's step
            "batch_norm_turns": [
                {"batch_norm": t["batch_norm"], "step_ms": ms,
                 "images_per_sec": images_turn,
                 "scaling": images_turn / (CARDS * one_card["train_imgs_per_sec"]),
                 **{k: t[k] for k in ("device_ms", "nccl_device_ms", "busy_share")}}
                for t, ms in zip(train[0]["batch_norm_turns"], per_turn)
                for images_turn in [train[0]["global_batch"] / (ms * 1e-3)]],
            "eager_equals_itself": [t["eager_equals_itself"] for t in train],
            "captured_equals_eager": [t["captured_equals_eager"] for t in train],
            "captured_against_eager_drift": [t["captured_against_eager_drift"] for t in train],
            "eager_against_eager_drift": [t["eager_against_eager_drift"] for t in train],
            "per_step_against_one_process": train[0]["per_step_against_one_process"],
            "per_step_against_one_process_plain_batch_norm":
                train[0]["per_step_against_one_process_plain_batch_norm"],
            "per_step_against_one_process_bf16": train[0]["per_step_against_one_process_bf16"],
            "top_kernels_ms_rank0": train[0]["top_kernels_ms"],
            "allreduce": [t["allreduce"] for t in train]}
        print("multichip train 4x1: " + json.dumps({k: v for k, v in summary["train"].items()
                                                    if k != "one_card_bench_train"}),
              flush=True)
        summary["command_line"] = cli_train_and_evaluate(tmp / "work", dataset)
    if "jax" in sys.modules:
        raise AssertionError("the run imported jax")
    summary["seconds"] = time.perf_counter() - t_run
    summary["launches"] = {f"multichip_{k}_rank{r}": ranks[r][k]["launches"]
                           for k in (f"{dp}x{mp}" for dp, mp in LAYOUTS) for r in range(CARDS)}
    summary["held"] = {f"multichip_{k}_rank{r}": ranks[r][k]["held"]
                       for k in (f"{dp}x{mp}" for dp, mp in LAYOUTS) for r in range(CARDS)}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(summary, indent=1))
    print(json.dumps({"multichip": "ok", "seconds": summary["seconds"],
                      "faces_per_sec": {f"{dp}x{mp}": summary[f"{dp}x{mp}"][
                          "aggregate_faces_per_sec"] for dp, mp in LAYOUTS},
                      "train_images_per_sec": summary["train"]["images_per_sec"],
                      "train_scaling": summary["train"]["scaling"],
                      "launches": summary["launches"], "held": summary["held"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
