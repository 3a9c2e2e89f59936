"""IResNet-100 ArcFace served at 112 px on the card: align's two kernels at
the shapes that crop size gives them (the crop kernel's stage-A patches of
144 px, K2 at 144 -> 112), bit for bit against their plain routes, and
``FacePipeline`` with ``build_iresnet_embedder`` at ``embed_size`` 112, its
replayed step against the eager one and ``identify`` end to end; the fused
route's passes (``ops/iresnet_epilogue.py``) against their plain route at
every stage's shapes, the whole model against the module chain, the kernels
a replay runs, the ``embed.fused_epilogues`` counter, and parameters read
in place.

These tests need an NVIDIA card and ``nvcc``; without them they skip. On the
card: ``python -m pytest tests/test_torch_iresnet_cuda.py -m cuda -q``."""

import math

import numpy as np
import pytest
import torch
import torch.nn as nn

from chip_smoke import K2_CASES, k2_case
from facerec_torch.ops import kernels
from facerec_torch.ops.crop_kernel import crop_resize_kernel
from facerec_torch.ops.warp_fast import _align_prep, crop_resize_matmul_batched, rotate_patches
from facerec_torch.ops.warp_kernel import rotate_patches_kernel

pytestmark = pytest.mark.cuda

HW = (480, 640)
CROP, PATCH = 112, 144  # the crop and align's stage-A patch (perfbench.flops.align_patch)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU or interpret mode")
    return torch.device("cuda")


@pytest.fixture
def no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def _pipeline(dev, rows: int = 64):
    """The benchmark's serve settings at 112 px: the committed detector, 8
    slots a frame, IResNet-100 from seed 1 in bf16, a gallery of ``rows``
    drawn rows, every face named by its nearest row."""
    from facerec_torch.config import ServeConfig
    from facerec_torch.detect.mtcnn import MTCNN
    from facerec_torch.detect.weights import load_detector_params
    from facerec_torch.models.iresnet import build_iresnet_embedder
    from facerec_torch.serve.pipeline import FacePipeline

    cfg = ServeConfig(max_faces=8, detection_threshold=0.0, recognition_threshold=2.0,
                      gallery_capacity=rows, top_k=5, embed_size=CROP)
    det = MTCNN(HW, min_face_size=40, max_faces=8, k_pnet=64, k_rnet=32, dtype=torch.bfloat16,
                input_range="255", device=dev)
    det.load_jax_params(load_detector_params())
    emb = build_iresnet_embedder(dtype=torch.bfloat16, seed=1, device=dev)
    pipe = FacePipeline(cfg, HW, det, emb, embed_dim=512, device=dev)
    gal = np.random.default_rng(2).normal(size=(rows, 512)).astype(np.float32)
    pipe.gallery.add_many([f"id{i}" for i in range(rows)], gal)
    return pipe


def _frames(seed: int = 0) -> np.ndarray:
    from facerec_torch.data.synthetic import face_frames

    return face_frames(48, HW, 8, np.random.default_rng(seed)).astype(np.uint8)


def test_align_kernels_at_112_on_a_serve_batch(dev, no_tf32):
    """The serve step's own calls at 112 px: the crop kernel's three calls
    (R-Net, O-Net, align's 48 x 8 patches of 144 px) against the matmul
    route, and K2 on those patches (384 x 144 -> 112) against the plain
    rotation, each bit for bit."""
    from facerec_torch.multichip import record_step

    pipe = _pipeline(dev)
    x = pipe.upload(_frames())
    r = pipe.step(x)
    assert r.valid.sum().item() >= 100
    calls = [args for args, _ in record_step(pipe, x, r, ("crop_resize",))["crop_resize"]]
    assert [(c[0].shape[1:3], c[1].shape[1], c[2]) for c in calls] == [
        ((288, 384), 32, 24), (HW, 20, 48), (HW, 8, PATCH)]
    for images, boxes, out, out_dtype in calls:
        got = crop_resize_kernel(images, boxes, out, out_dtype)
        assert torch.equal(got, crop_resize_matmul_batched(images, boxes, out, out_dtype))
    lmk = torch.where(r.valid[..., None, None], r.landmarks, pipe._default_lmk)
    patches, angle, centers = _align_prep(x.float(), r.boxes, lmk, CROP, 0.15)
    assert patches.shape == (48, 8, PATCH, PATCH, 3)
    flat = patches.reshape(-1, PATCH, PATCH, 3)
    before = kernels.launches()["shear_rotate"]
    got = rotate_patches_kernel(flat, angle.reshape(-1), centers.reshape(-1, 2), CROP)
    want = rotate_patches(flat, angle.reshape(-1), centers.reshape(-1, 2), CROP)
    torch.cuda.synchronize()
    assert kernels.launches()["shear_rotate"] == before + 1
    assert got.shape == (384, CROP, CROP, 3) and torch.equal(got, want)


@pytest.mark.parametrize("case", K2_CASES)
@pytest.mark.parametrize("n", [1, 5, 384])
def test_rotate_kernel_at_144_to_112(dev, case, n):
    """K2 at 112 px on drawn patches and its edge cases (``chip_smoke.k2_case``)."""
    g0 = torch.Generator(device=dev).manual_seed(n)
    patches = (torch.rand(n, PATCH, PATCH, 3, generator=g0, device=dev) * 255).to(torch.bfloat16)
    angles = (torch.rand(n, generator=g0, device=dev) * 2 - 1) * math.radians(15.0)
    centers = PATCH * (0.3 + 0.4 * torch.rand(n, 2, generator=g0, device=dev))
    angles, centers = k2_case(case, angles, centers, PATCH)
    got = rotate_patches_kernel(patches, angles, centers, CROP)
    assert torch.equal(got, rotate_patches(patches, angles, centers, CROP))


def test_identify_at_112_replays_the_eager_step(dev, no_tf32):
    """The replayed step equals the eager one, field for field, twice; a
    replay launches K1 once, K2 once, the NMS kernel 5 times, the crop
    kernel 3 times and the epilogue kernel 99 times; ``identify`` answers
    every valid face from it."""
    pipe = _pipeline(dev)
    frames = _frames(1)
    x = pipe.upload(frames)
    eager = pipe.step(x)
    first = pipe.run_step(x)
    before = kernels.launches()
    second = pipe.run_step(x)
    torch.cuda.synchronize()
    assert {k: n - before[k] for k, n in kernels.launches().items()} == {
        "gallery_topk": 1, "shear_rotate": 1, "nms_suppress": 5, "crop_resize": 3,
        "iresnet_epilogue": 99}
    assert len(pipe._graphs) == 1
    assert all(torch.equal(a, b) for a, b in zip(first, eager))
    assert all(torch.equal(a, b) for a, b in zip(second, eager))
    assert eager.embeddings.shape == (48, 8, 512) and eager.valid.sum().item() >= 100
    norms = eager.embeddings.float().norm(dim=-1)
    assert torch.allclose(norms, torch.ones_like(norms), atol=1e-5)
    answers = pipe.identify(frames)
    assert len(answers) == 48
    assert sum(len(f) for f in answers) == eager.valid.sum().item()
    named = [face["name"] for f in answers for face in f]
    rows = eager.match_indices[..., 0][eager.valid].tolist()
    assert named == [f"id{i}" for i in rows]


# -- the fused route: BatchNorm, PReLU and residual add as two passes a block --------------

N_CROPS = 384  # a serve batch's crops: 48 frames x 8 slots
WIDTHS = (64, 128, 256, 512)
IRESNET_BN = 1 + 3 * 49 + 4 + 1  # the stem's, 3 a block, 4 shortcuts, the head's bn2
IRESNET_PRELU = 1 + 49
IRESNET_ADDS = 49


def _bn(c: int, g: torch.Generator, dev) -> nn.BatchNorm2d:
    """A bf16 eval BatchNorm drawn as ``perfbench.weights`` draws them."""
    bn = nn.BatchNorm2d(c, eps=1e-5)
    with torch.no_grad():
        bn.weight.copy_(1 + 0.1 * torch.randn(c, generator=g))
        bn.bias.copy_(0.1 * torch.randn(c, generator=g))
        bn.running_mean.copy_(0.1 * torch.randn(c, generator=g))
        bn.running_var.copy_(torch.exp(0.2 * torch.randn(c, generator=g)))
    return bn.to(dev, torch.bfloat16).eval()


def _prelu(c: int, g: torch.Generator, dev) -> nn.PReLU:
    p = nn.PReLU(c)
    with torch.no_grad():
        p.weight.copy_(0.25 + 0.05 * torch.randn(c, generator=g))
    return p.to(dev, torch.bfloat16)


def _cl_map(shape, g: torch.Generator, dev) -> torch.Tensor:
    x = torch.randn(shape, generator=g, device=dev) * 2 + 0.3
    return x.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)


# (stage, pass): stage 0 is the stem's pass, stage 4's "last" the last block's
PASSES = [(0, "stem")] + [(s, k) for s in range(1, 5)
                          for k in ("a_first", "b_downsample", "a", "b_identity")] + [(4, "last")]


def _pass_args(stage: int, kind: str, dev) -> dict:
    """The map and modules of one pass at its stage's shapes, 384 crops."""
    g = torch.Generator().manual_seed(100 * stage + len(kind))
    gd = torch.Generator(device=dev).manual_seed(100 * stage + len(kind))
    c = WIDTHS[max(stage - 1, 0)]
    side = 112 >> stage  # the stage's output side: 56, 28, 14, 7
    if kind == "stem":
        return {"a": _cl_map((N_CROPS, 64, 112, 112), gd, dev), "bn": _bn(64, g, dev),
                "prelu": _prelu(64, g, dev), "next_bn": _bn(64, g, dev)}
    if kind in ("a_first", "a"):
        s = 2 * side if kind == "a_first" else side
        return {"a": _cl_map((N_CROPS, c, s, s), gd, dev), "bn": _bn(c, g, dev),
                "prelu": _prelu(c, g, dev)}
    args = {"a": _cl_map((N_CROPS, c, side, side), gd, dev), "bn": _bn(c, g, dev),
            "shortcut": _cl_map((N_CROPS, c, side, side), gd, dev), "next_bn": _bn(c, g, dev)}
    if kind == "b_downsample":
        args["shortcut_bn"] = _bn(c, g, dev)
    if kind == "last":
        args["keep"] = False
    return args


def _ordered(t: torch.Tensor) -> torch.Tensor:
    """bf16 values as integers in their order: neighbours differ by 1."""
    i = t.contiguous().view(torch.int16).int()
    return torch.where(i >= 0, i, -(i + 32768))


@pytest.mark.parametrize("stage,kind", PASSES)
def test_epilogue_pass_at_each_stage_against_its_plain_route(dev, stage, kind):
    """The kernel against the plain route (PyTorch's own BatchNorm, PReLU
    and add on the card) at the serve batch's shapes: at most one bf16 ulp
    apart (printed: the largest gap in ulps and the share that differs)."""
    from facerec_torch.ops.iresnet_epilogue import iresnet_epilogue, iresnet_epilogue_plain

    args = _pass_args(stage, kind, dev)
    a = args.pop("a")
    with torch.no_grad():
        got = iresnet_epilogue(a, **args)
        want = iresnet_epilogue_plain(a, **args)
    torch.cuda.synchronize()
    for name, x, y in zip(("z", "zn"), got, want):
        assert (x is None) == (y is None)
        if x is None:
            continue
        assert x.is_contiguous(memory_format=torch.channels_last)
        ulps = (_ordered(x) - _ordered(y)).abs()
        worst, share = ulps.max().item(), (ulps > 0).float().mean().item()
        print(f"epilogue {kind} stage {stage} {name}: {tuple(x.shape)} max {worst} ulp, "
              f"{share:.3e} differ")
        assert worst <= 1


def _serve_crops(pipe, frames):
    """The serve step's own 112 px crops of ``frames``."""
    from facerec_torch.serve.pipeline import DEFAULT_LANDMARKS

    x = pipe.upload(frames)
    r = pipe.step(x)
    lmk = torch.where(r.valid[..., None, None], r.landmarks,
                      torch.tensor(DEFAULT_LANDMARKS, device=x.device))
    return pipe.align(x, r.boxes, lmk).reshape(-1, CROP, CROP, 3)


def test_fused_iresnet100_against_the_module_chain_on_serve_crops(dev, no_tf32):
    """The whole IResNet-100 on a serve batch's own crops: the fused route
    (what ``embed`` takes here) against the module chain; the largest
    unit-embedding gap printed and under 0.05."""
    pipe = _pipeline(dev)
    emb = pipe.embedder
    with torch.no_grad():
        crops = _serve_crops(pipe, _frames(3))
        before = kernels.launches()["iresnet_epilogue"]
        fused = emb.embed(crops)
        assert kernels.launches()["iresnet_epilogue"] - before == 99
        with torch.enable_grad():  # the module chain: the route wants no gradient
            chain = emb.embed(crops).detach()
        assert kernels.launches()["iresnet_epilogue"] - before == 99
    gap = (fused - chain).norm(dim=1).max().item()
    print(f"IResNet-100 fused against the module chain on {len(crops)} serve crops: "
          f"largest unit-embedding gap {gap:.3g}; bit-equal rows "
          f"{(fused == chain).all(dim=1).sum().item()}")
    assert gap < 0.05


class _ChainEmbedder(nn.Module):
    """An IResNet that embeds through the module chain: with gradients on,
    which the fused route does not take."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def embed(self, crops):
        with torch.enable_grad():
            return self.model.embed(crops).detach()


def _replay_kernels(pipe, frames) -> dict[str, int]:
    from torch.profiler import ProfilerActivity, profile

    from facerec_torch.utils.profiling import device_ops

    x = pipe.upload(frames)
    pipe.run_step(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pipe.run_step(x)
        torch.cuda.synchronize()
    return {e.key: e.count for e in device_ops(prof)}


def test_a_replay_runs_the_epilogues_in_place_of_the_elementwise_kernels(dev, no_tf32):
    """By kernel name in one profiled replay of each captured step: the
    fused route launches the epilogue kernel 99 times and no bf16 BatchNorm
    (the head's f32 ``features`` keeps its own); against the module chain's
    replay it drops exactly embed's 153 BatchNorms (each three kernels: the
    running mean's f32 copy, its invstd, the transform), 50 PReLUs and 49
    residual adds, and no other kernel (the graphs' memset and memcpy nodes
    aside)."""
    pipe = _pipeline(dev)
    frames = _frames(4)
    fused = _replay_kernels(pipe, frames)
    pipe.embedder = _ChainEmbedder(pipe.embedder)
    chain = _replay_kernels(pipe, frames)
    count = lambda ks, part: sum(n for k, n in ks.items() if part in k)  # noqa: E731
    dropped = {k: chain.get(k, 0) - fused.get(k, 0) for k in set(chain) | set(fused)}
    dropped = {k: n for k, n in dropped.items() if n and "iresnet_epilogue" not in k
               and not k.lower().startswith(("memset", "memcpy"))}
    print("epilogue replay: fused", count(fused, "iresnet_epilogue"), "epilogue launches;",
          "dropped", {k[:90]: n for k, n in dropped.items()})
    assert count(fused, "iresnet_epilogue") == 99 and count(chain, "iresnet_epilogue") == 0
    bf16_bn = "batch_norm_transform_input_channels_last_kernel<c10::BFloat16"
    assert count(fused, bf16_bn) == 0 and count(chain, bf16_bn) == IRESNET_BN
    want = {bf16_bn: IRESNET_BN, "batch_norm_calc_invstd": IRESNET_BN,
            "direct_copy_kernel": IRESNET_BN, "prelu_kernel": IRESNET_PRELU,
            "CUDAFunctor_add<c10::BFloat16>": IRESNET_ADDS}
    assert sorted(dropped.values()) == sorted(want.values())
    assert {part: count(dropped, part) for part in want} == want


def test_the_fused_epilogues_counter_reads_99_a_request(dev, no_tf32):
    from facerec_torch.utils import profiling

    profiling.disable()
    profiling.reset()
    profiling.enable()
    try:
        pipe = _pipeline(dev)
        frames = _frames(5)
        pipe.identify(frames)  # captures, with its warm-ups
        profiling.reset()
        pipe.identify(frames)
        snap = profiling.snapshot()
    finally:
        profiling.disable()
        profiling.reset()
    counts = [c["value"] for c in snap["counts"] if c["name"] == "embed.fused_epilogues"]
    assert counts == [99]


def test_a_replay_reads_the_running_statistics_in_place(dev, no_tf32):
    """Running statistics edited in place after the capture change the
    replayed embeddings, which then equal the eager step's."""
    pipe = _pipeline(dev)
    x = pipe.upload(_frames(6))
    first = pipe.run_step(x)
    emb = pipe.embedder
    with torch.no_grad():
        emb.layer3[5].bn2.running_var.mul_(3.0)
        emb.layer1[0].bn1.running_mean.add_(0.5)
        emb.layer4[0].downsample[1].running_mean.sub_(0.25)
    second = pipe.run_step(x)
    eager = pipe.step(x)
    assert len(pipe._graphs) == 1
    assert not torch.equal(first.embeddings, second.embeddings)
    assert torch.equal(second.embeddings, eager.embeddings)
