"""The port's IResNet ArcFace embedder (``facerec_torch/models/iresnet.py``)
against the benchmark's plain reference (``perfbench/reference/iresnet.py``)
on the CPU, on weights drawn as the benchmark draws them
(``perfbench.weights.make_state``: PReLU slopes 0.25 + 0.05 z, BatchNorm
scales 1 + 0.1 z, running variances exp(0.2 z)), at two small depths and
crops; insightface's ``iresnet100`` state-dict layout; the benchmark's
count of its multiply-adds; its spans; the fused route's passes
(``ops/iresnet_epilogue.py``) on their CPU route against the module chain,
which route an input takes, and what the pass refuses. The card's tests are
in ``tests/test_torch_iresnet_cuda.py``."""

import numpy as np
import pytest
import torch
import torch.nn as nn

from facerec_torch.models import iresnet
from facerec_torch.models.iresnet import IResNet, build_iresnet_embedder
from facerec_torch.ops.iresnet_epilogue import iresnet_epilogue
from facerec_torch.utils import profiling
from perfbench import weights
from perfbench.embedders import arcface_iresnet100
from perfbench.reference import iresnet as ref
from perfbench.reference.precision import Precision

SMALL = [((1, 2, 2, 1), 32), ((2, 1, 1, 1), 48)]  # (layers, crop)
SEED = 2 ** 31 + 23
# f32: the port and the reference compute the same f32 operations in
# another order (F.batch_norm's fused scale and shift against the written-out
# normalisation, PReLU as a kernel against torch.where), so each layer's
# output differs by a few f32 roundings (~1e-7 relative); over ten to
# twenty layers, after the unit normalisation, the embeddings read 1e-6
# apart. 1e-4 leaves that room a hundredfold and stays far below what a
# wrong layer gives (0.1 or more, the faults below).
F32_TOL = 1e-4
# bf16: the trunk's weights and activations rounded to bf16 (8 bits of
# mantissa, 2e-3 relative a rounding) at every layer, about 0.01 apart at
# these depths; 0.04 leaves room for the deeper of the two.
BF16_TOL = 0.04


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _case(layers, crop, dtype, n=6):
    state = weights.make_state(ref.param_shapes(layers, 512, crop), SEED + crop, "cpu", dtype)
    g = torch.Generator().manual_seed(crop)
    crops = torch.randint(0, 256, (n, crop, crop, 3), generator=g).float()
    return state, crops


def _gap(layers, crop, dtype) -> float:
    """The widest L2 distance between the port's and the reference's unit
    embeddings of the same crops."""
    state, crops = _case(layers, crop, dtype)
    model = build_iresnet_embedder(state, dtype=dtype, device="cpu")
    with torch.no_grad():
        got = model.embed(crops)
        want = ref.embed(Precision("f32"), state, crops)
    assert got.dtype == torch.float32 and got.shape == (len(crops), 512)
    return (got - want).norm(dim=1).max().item()


@pytest.mark.parametrize("layers,crop", SMALL)
def test_f32_matches_the_reference(layers, crop):
    assert _gap(layers, crop, torch.float32) <= F32_TOL


@pytest.mark.parametrize("layers,crop", SMALL)
def test_bf16_matches_the_reference(layers, crop):
    assert _gap(layers, crop, torch.bfloat16) <= BF16_TOL


@pytest.mark.parametrize("layers,crop", SMALL)
def test_the_head_runs_in_f32(layers, crop):
    state, _ = _case(layers, crop, torch.bfloat16)
    model = build_iresnet_embedder(state, dtype=torch.bfloat16, device="cpu")
    assert {p.dtype for p in model.fc.parameters()} == {torch.float32}
    assert {t.dtype for t in model.features.state_dict().values()} <= {torch.float32, torch.int64}
    assert model.conv1.weight.dtype == model.layer4[0].prelu.weight.dtype == torch.bfloat16
    assert not model.training


def _identity_prelu(monkeypatch):
    monkeypatch.setattr(nn.PReLU, "forward", lambda self, x: x)


def _unstandardised(monkeypatch):
    monkeypatch.setattr(iresnet, "standardize", lambda x: x.float())


def _nhwc_flatten(monkeypatch):
    monkeypatch.setattr(iresnet, "flatten_nchw", lambda x: x.permute(0, 2, 3, 1).flatten(1))


@pytest.mark.parametrize("fault", [_identity_prelu, _unstandardised, _nhwc_flatten],
                         ids=["prelu_identity", "no_standardisation", "nhwc_flatten"])
@pytest.mark.parametrize("layers,crop", SMALL)
def test_a_fault_fails_the_f32_comparison(monkeypatch, fault, layers, crop):
    fault(monkeypatch)
    assert _gap(layers, crop, torch.float32) > 100 * F32_TOL


class _InsightfaceBlock(nn.Module):
    """insightface's ``IBasicBlock.__init__``, written out: its modules in
    its order, torch's own BatchNorm classes."""

    def __init__(self, inplanes, planes, stride=1, downsample=None):
        super().__init__()
        self.bn1 = nn.BatchNorm2d(inplanes, eps=1e-05)
        self.conv1 = nn.Conv2d(inplanes, planes, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes, eps=1e-05)
        self.prelu = nn.PReLU(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(planes, eps=1e-05)
        self.downsample = downsample


class _InsightfaceIResNet(nn.Module):
    """insightface's ``IResNet.__init__`` for ``iresnet100``
    (``IResNet(IBasicBlock, [3, 13, 30, 3])``, fc_scale 7 * 7, 512
    features), written out."""

    def __init__(self, layers=(3, 13, 30, 3)):
        super().__init__()
        self.inplanes = 64
        self.conv1 = nn.Conv2d(3, 64, 3, 1, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(64, eps=1e-05)
        self.prelu = nn.PReLU(64)
        self.layer1 = self._make_layer(64, layers[0], 2)
        self.layer2 = self._make_layer(128, layers[1], 2)
        self.layer3 = self._make_layer(256, layers[2], 2)
        self.layer4 = self._make_layer(512, layers[3], 2)
        self.bn2 = nn.BatchNorm2d(512, eps=1e-05)
        self.dropout = nn.Dropout(p=0.0, inplace=True)
        self.fc = nn.Linear(512 * 7 * 7, 512)
        self.features = nn.BatchNorm1d(512, eps=1e-05)

    def _make_layer(self, planes, blocks, stride):
        downsample = None
        if stride != 1 or self.inplanes != planes:
            downsample = nn.Sequential(nn.Conv2d(self.inplanes, planes, 1, stride, bias=False),
                                       nn.BatchNorm2d(planes, eps=1e-05))
        layers = [_InsightfaceBlock(self.inplanes, planes, stride, downsample)]
        self.inplanes = planes
        layers += [_InsightfaceBlock(self.inplanes, planes) for _ in range(1, blocks)]
        return nn.Sequential(*layers)


@pytest.fixture(scope="module")
def insightface_state():
    return _InsightfaceIResNet().state_dict()


def test_the_state_dict_is_insightfaces_iresnet100(insightface_state):
    want = {k: tuple(v.shape) for k, v in insightface_state.items()}
    got = {k: tuple(v.shape) for k, v in IResNet().state_dict().items()}
    assert list(got) == list(want) and got == want
    assert len(want) == 925 and want["fc.weight"] == (512, 25088)
    assert list(want) == list(ref.param_shapes())
    assert ref.param_shapes() == want


def test_build_loads_insightfaces_dict_strictly(insightface_state, tmp_path):
    state = {k: (v.normal_() if v.is_floating_point() else v)
             for k, v in insightface_state.items()}
    path = tmp_path / "backbone.pth"
    torch.save(state, path)
    for weights_ in (state, path):
        model = build_iresnet_embedder(weights_, dtype=torch.float32, device="cpu")
        assert [len(getattr(model, f"layer{i}")) for i in range(1, 5)] == [3, 13, 30, 3]
        got = model.state_dict()
        assert all(torch.equal(got[k], state[k]) for k in state)
    with pytest.raises(RuntimeError, match="Unexpected key"):
        IResNet().load_state_dict({**state, "extra.weight": torch.zeros(1)})


def test_the_benchmark_counts_insightfaces_multiply_adds():
    emb = {"kind": "arcface_iresnet100", "layers": [3, 13, 30, 3], "embedding_dim": 512,
           "crop": 112}
    assert arcface_iresnet100.macs(emb) == 12_089_606_144  # 24.2 GFLOPs a crop, as published


def _embed_spans(snap):
    return [s for s in snap["spans"] if s["name"].startswith("embed.")]


def test_the_spans_nest_in_the_callers():
    state, crops = _case(*SMALL[0], torch.float32, n=2)
    model = build_iresnet_embedder(state, dtype=torch.float32, device="cpu")
    names = ["embed.stem", "embed.stage1", "embed.stage2", "embed.stage3", "embed.stage4",
             "embed.head"]
    profiling.disable()
    profiling.reset()
    try:
        with torch.no_grad():
            model.embed(crops)
            assert profiling.snapshot() == {"spans": [], "counts": []}
            profiling.enable()
            for _ in range(2):
                with profiling.span("serve.step.embed"):
                    model.embed(crops)
        snap = profiling.snapshot()
    finally:
        profiling.disable()
        profiling.reset()
    callers = [s for s in snap["spans"] if s["name"] == "serve.step.embed"]
    spans = _embed_spans(snap)
    assert len(callers) == 2 and len(spans) == 12
    for caller in callers:
        mine = [s for s in spans if s["parent"] == caller["id"]]
        assert [s["name"] for s in mine] == names
        assert all(caller["start"] <= s["start"] <= s["end"] <= caller["end"] for s in mine)
        assert np.all(np.diff([s["start"] for s in mine]) >= 0)


# -- the fused route (ops/iresnet_epilogue.py) --------------------------------------------

FUSED_LAYERS, FUSED_CROP = (2, 2, 2, 2), 32  # every kind of pass: identity last block


def _cl_model(layers=FUSED_LAYERS, crop=FUSED_CROP, dtype=torch.bfloat16):
    state, crops = _case(layers, crop, dtype, n=3)
    model = build_iresnet_embedder(state, dtype=dtype, device="cpu")
    return model.to(memory_format=torch.channels_last), crops


def _map(shape, seed, dtype=torch.bfloat16):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=g) * 2 + 0.3
    return x.to(dtype).contiguous(memory_format=torch.channels_last)


def _pass_case(model, kind):
    """(what the fused route computes, what the module chain computes) for
    one kind of pass: each a (output, next BatchNorm of it) pair."""
    if kind == "stem":
        c = _map((3, 64, 32, 32), 1)
        z = model.prelu(model.bn1(c))
        got = iresnet_epilogue(c, model.bn1, prelu=model.prelu, next_bn=model.layer1[0].bn1)
        return got, (z, model.layer1[0].bn1(z))
    block, x, nxt, keep = {
        "plain_block": (model.layer2[1], _map((3, 128, 8, 8), 2), model.layer3[0].bn1, True),
        "downsample_block": (model.layer3[0], _map((3, 128, 8, 8), 3), model.layer3[1].bn1,
                             True),
        "last_block": (model.layer4[1], _map((3, 512, 2, 2), 4), model.bn2, False),
    }[kind]
    z = block(x)
    return block.fused(x, block.bn1(x), nxt, keep=keep), (z if keep else None, nxt(z))


@pytest.mark.parametrize("kind", ["stem", "plain_block", "downsample_block", "last_block"])
def test_the_passes_cpu_route_is_the_module_chain_bit_for_bit(kind):
    model, _ = _cl_model()
    with torch.no_grad():
        (z, zn), (want_z, want_zn) = _pass_case(model, kind)
    assert (z is None) == (want_z is None)
    for got, want in ((z, want_z), (zn, want_zn)):
        if got is None:
            continue
        assert got.dtype == torch.bfloat16 and torch.equal(got, want)
        assert got.is_contiguous(memory_format=torch.channels_last)


def _fused_counts(snap):
    return [c["value"] for c in snap["counts"] if c["name"] == "embed.fused_epilogues"]


@pytest.mark.parametrize("layers,crop", SMALL + [(FUSED_LAYERS, FUSED_CROP)])
def test_the_fused_route_is_the_module_chain_end_to_end(monkeypatch, layers, crop):
    """The whole embed through the passes' CPU route (the route chosen as
    on a card) against the module chain, bit for bit; the counter reads the
    route's launches, 1 + 2 per block, and is absent on the chain."""
    model, crops = _cl_model(layers, crop)
    profiling.disable()
    profiling.reset()
    profiling.enable()
    try:
        with torch.no_grad():
            chain = model.embed(crops)
            assert _fused_counts(profiling.snapshot()) == []
            monkeypatch.setattr(iresnet, "fusable", lambda model, x: True)
            fused = model.embed(crops)
        snap = profiling.snapshot()
    finally:
        profiling.disable()
        profiling.reset()
    assert torch.equal(fused, chain)
    assert _fused_counts(snap) == [1 + 2 * sum(layers)]


class _OnCard:
    """A CPU map that says it lies on a card, for the route's predicate."""

    is_cuda = True

    def __init__(self, t: torch.Tensor):
        self.t = t

    def __getattr__(self, name):
        return getattr(self.t, name)


def _fusable_case(kind):
    model, _ = _cl_model((1, 1, 1, 1))
    x = _map((2, 64, 8, 8), 5)
    if kind == "f32":
        x = x.float()
    elif kind == "train":
        model.train()
    elif kind == "not_channels_last":
        x = x.contiguous()
    elif kind == "12_channels":
        x = _map((2, 12, 8, 8), 5)
    return model, (x if kind == "cpu" else _OnCard(x))


@pytest.mark.parametrize("kind,want", [("served", True), ("cpu", False), ("f32", False),
                                       ("train", False), ("not_channels_last", False),
                                       ("12_channels", False), ("grad", False)])
def test_only_a_served_bf16_channels_last_map_on_a_card_is_fusable(kind, want):
    model, x = _fusable_case(kind)
    with torch.set_grad_enabled(kind == "grad"):
        assert iresnet.fusable(model, x) is want


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_embed_on_the_cpu_takes_the_module_chain(monkeypatch, dtype):
    def refuse(*args, **kwargs):
        raise AssertionError("the fused route ran on the CPU")

    model, crops = _cl_model((1, 1, 1, 1), dtype=dtype)
    monkeypatch.setattr(iresnet, "iresnet_epilogue", refuse)
    profiling.disable()
    profiling.reset()
    profiling.enable()
    try:
        with torch.no_grad():
            got = model.embed(crops)
        snap = profiling.snapshot()
    finally:
        profiling.disable()
        profiling.reset()
    assert got.shape == (len(crops), 512) and _fused_counts(snap) == []


def _bad_call(kind):
    model, _ = _cl_model((1, 1, 1, 1))
    a, b = _map((2, 64, 8, 8), 6), _map((2, 64, 8, 8), 7)
    bn, nxt = model.layer1[0].bn3, model.layer2[0].bn1
    f32_bn = nn.BatchNorm2d(64).eval()
    short_bn = nn.BatchNorm2d(48).to(torch.bfloat16).eval()
    return {
        "f32_map": lambda: iresnet_epilogue(a.float(), bn),
        "f32_shortcut": lambda: iresnet_epilogue(a, bn, shortcut=b.float()),
        "f32_parameters": lambda: iresnet_epilogue(a, f32_bn),
        "map_on_another_device": lambda: iresnet_epilogue(a.to("meta"), bn),
        "shortcut_on_another_device": lambda: iresnet_epilogue(a, bn, shortcut=b.to("meta")),
        "3d_map": lambda: iresnet_epilogue(a[0], bn),
        "not_channels_last": lambda: iresnet_epilogue(a.contiguous(), bn),
        "12_channels": lambda: iresnet_epilogue(_map((2, 12, 8, 8), 8), bn),
        "shortcut_shape": lambda: iresnet_epilogue(a, bn, shortcut=b[:1]),
        "parameters_of_another_width": lambda: iresnet_epilogue(a, short_bn),
        "writes_nothing": lambda: iresnet_epilogue(a, bn, keep=False),
        "shortcut_bn_alone": lambda: iresnet_epilogue(a, bn, shortcut_bn=bn, next_bn=nxt),
    }[kind]


@pytest.mark.parametrize("kind,error", [
    ("f32_map", TypeError), ("f32_shortcut", TypeError), ("f32_parameters", TypeError),
    ("map_on_another_device", ValueError), ("shortcut_on_another_device", ValueError),
    ("3d_map", ValueError), ("not_channels_last", ValueError), ("12_channels", ValueError),
    ("shortcut_shape", ValueError), ("parameters_of_another_width", ValueError),
    ("writes_nothing", ValueError), ("shortcut_bn_alone", ValueError)])
def test_the_pass_refuses_what_the_kernel_does_not_take(kind, error):
    call = _bad_call(kind)
    with torch.no_grad(), pytest.raises(error):
        call()
