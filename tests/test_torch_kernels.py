"""``facerec_torch/ops/kernels.py``, the table of the port's counted CUDA
kernels, and ``build.function``, on the CPU: the table against the
sources and wrappers, the counts, ``recording`` on a tiny CPU pipeline's
eager step, and ``multichip.hold_kernels`` there."""

import ctypes

import numpy as np
import pytest
import torch

from facerec_torch import build
from facerec_torch.detect.mtcnn import MTCNN
from facerec_torch.multichip import CROP_SITES, NMS_SITES, hold_kernels, step_launches
from facerec_torch.ops import kernels


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _counts_kept():
    """Each test leaves the process's counts as it found them."""
    before = kernels.launches()
    yield
    kernels.zero()
    kernels.advance(before)


def _tiny_pipeline(precise_align=False):
    """96 x 96 frames, the committed detector weights, a narrow ArcFace at
    32 px crops, an f32 gallery, all on the CPU."""
    from facerec_torch.config import ServeConfig
    from facerec_torch.detect.weights import load_detector_params
    from facerec_torch.models.arcface import build_embedder
    from facerec_torch.serve.pipeline import FacePipeline

    cfg = ServeConfig(max_faces=4, gallery_capacity=128, top_k=3, embed_size=32,
                      detection_threshold=0.0, recognition_threshold=10.0,
                      gallery_dtype="float32")
    det = MTCNN((96, 96), min_face_size=24, max_faces=4, k_pnet=16, k_rnet=8, device="cpu")
    det.load_jax_params(load_detector_params())
    emb = build_embedder(width=16, dtype=torch.float32, seed=1, device="cpu")
    pipe = FacePipeline(cfg, (96, 96), det, emb, device="cpu", precise_align=precise_align)
    rows = torch.randn(5, 512, generator=torch.Generator().manual_seed(3)).numpy()
    pipe.gallery.add_many([f"id{i}" for i in range(5)], rows)
    return pipe


def _frames():
    from facerec_torch.serve.app import synthetic_frame_source

    src = synthetic_frame_source((96, 96))
    return np.stack([src(), src()])


def test_sources_are_every_cuda_file():
    """``build.SOURCES`` is every ``csrc/*.cu``, the trace stamp's
    included, and every table entry's library is one of them."""
    stems = sorted(p.stem for p in build.CSRC.glob("*.cu"))
    assert list(build.SOURCES) == stems and "trace_stamp" in stems
    assert {k.library for k in kernels.TABLE.values()} <= set(build.SOURCES)


def test_table_names_each_launcher_and_its_plain_twin():
    """Each entry's symbol is in its source, its kernel name (the
    profiler's) too, and its plain twin resolves."""
    for name, k in kernels.TABLE.items():
        src = (build.CSRC / f"{k.library}.cu").read_text()
        assert f"{k.symbol}(" in src and k.profiler_name in src, name
        assert callable(kernels.plain(name))


def test_counts_zero_and_advance_round_trip():
    kernels.zero()
    assert kernels.launches() == dict.fromkeys(kernels.TABLE, 0)
    step = {name: i + 1 for i, name in enumerate(kernels.TABLE)}
    kernels.advance(step)
    kernels.advance(step)
    assert kernels.launches() == {k: 2 * n for k, n in step.items()}
    kernels.advance({k: -n for k, n in step.items()})
    assert kernels.launches() == step
    got = kernels.launches()
    got["gallery_topk"] += 10  # a copy: the counts stay
    assert kernels.launches() == step


def test_launch_binds_checks_and_counts(monkeypatch):
    """``launch`` calls the bound symbol with the table's types, counts a
    launch that returns 0 and raises, naming the kernel, on any other."""
    seen = []

    def function(lib, symbol, argtypes):
        seen.append((lib, symbol, argtypes))
        return lambda *args: args[0]

    monkeypatch.setattr(build, "function", function)
    before = kernels.launches()
    kernels.launch("crop_resize", 0, 1, 2)
    k = kernels.TABLE["crop_resize"]
    assert seen == [(k.library, k.symbol, k.argtypes)]
    assert kernels.launches() == before | {"crop_resize": before["crop_resize"] + 1}
    with pytest.raises(RuntimeError, match="crop_resize"):
        kernels.launch("crop_resize", 700)
    assert kernels.launches()["crop_resize"] == before["crop_resize"] + 1


def test_function_binds_once_with_its_types():
    libc = ctypes.CDLL(None)
    fn = build.function(libc, "abs", (ctypes.c_int,))
    assert fn(-7) == 7 and list(fn.argtypes) == [ctypes.c_int] and fn.restype is ctypes.c_int
    assert build.function(libc, "abs", (ctypes.c_int,)) is fn
    other = build.function(libc, "abs", (ctypes.c_long,), ctypes.c_long)
    assert other is not fn and list(fn.argtypes) == [ctypes.c_int]


@pytest.mark.parametrize("precise", [False, True])
def test_recording_an_eager_step(precise):
    """One eager CPU step under ``recording``: the detect's five NMS calls
    in ``NMS_SITES`` order (each site's threshold and mode), the crop
    calls (R-Net, O-Net and, on the fast path, align's patches), K1 once,
    K2 once on the fast path; the counts as they were."""
    pipe = _tiny_pipeline(precise)
    x = pipe.upload(_frames())
    before = kernels.launches()
    with kernels.recording("nms_suppress") as nms, kernels.recording("crop_resize") as crops, \
            kernels.recording("gallery_topk") as k1, kernels.recording("shear_rotate") as k2:
        r = pipe.step(x)
    assert kernels.launches() == before
    sites = [(args[3], args[4]) for args, _ in nms]
    assert sites == [(0.5, "union"), (0.7, MTCNN.CROSS_SCALE_NMS_MODE),
                     (MTCNN.RNET_NMS_IOU, "union"), (0.7, "union"), (0.7, "min")]
    assert len(sites) == len(NMS_SITES)
    assert [args[2] for args, _ in crops] == [24, 48] + ([] if precise else [40])
    assert len(crops) == len(CROP_SITES) - precise
    assert len(k1) == 1 and torch.equal(k1[0][0][0], r.embeddings.flatten(0, 1))
    assert len(k2) == (0 if precise else 1)
    want = step_launches(pipe)
    assert (want["nms_suppress"], want["crop_resize"], want["shear_rotate"]) == (
        len(nms), len(crops), len(k2))
    assert want["iresnet_epilogue"] == 0


def test_recording_copies_and_nests():
    """Arguments are copies; a recording of another kernel or an inner one
    of the same kernel sees only its own block; the counts stay."""
    from facerec_torch.ops.crop_kernel import crop_resize_kernel

    images, boxes = torch.rand(1, 20, 20, 3), torch.tensor([[[2.0, 2.0, 12.0, 12.0]]])
    with kernels.recording("crop_resize") as outer, kernels.recording("nms_suppress") as other:
        crop_resize_kernel(images, boxes, 8)
        with kernels.recording("crop_resize") as inner:
            crop_resize_kernel(images, boxes, 4)
        images += 1.0
    assert [c[0][2] for c in outer] == [8, 4] and [c[0][2] for c in inner] == [4]
    assert other == [] and torch.equal(outer[0][0][0] + 1.0, images)
    kernels.note("crop_resize", images, boxes, 8)  # no recording open: nothing kept
    assert len(outer) == 2


@pytest.mark.parametrize("precise", [False, True])
def test_hold_kernels_on_a_cpu_pipeline(precise):
    """The merged hold runs on the CPU pipeline (every wrapper takes its
    plain route, so each kernel holds exactly) and leaves the counts."""
    pipe = _tiny_pipeline(precise)
    x = pipe.upload(_frames())
    r = pipe.step(x)
    before = kernels.launches()
    held = hold_kernels(pipe, x, r)
    assert kernels.launches() == before
    assert held["gallery_topk"] == 0.0 and held["k1_f32_err"] == 0.0
    assert list(held["nms_rounds"]) == list(NMS_SITES)
    assert held["nms_suppress"] == held["crop_resize"] == 0.0
    assert ("shear_rotate" in held) == (not precise) and "iresnet_epilogue" not in held
