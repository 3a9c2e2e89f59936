"""The port's IResNet ArcFace embedder (``facerec_torch/models/iresnet.py``)
against the benchmark's plain reference (``perfbench/reference/iresnet.py``)
on the CPU, on weights drawn as the benchmark draws them
(``perfbench.weights.make_state``: PReLU slopes 0.25 + 0.05 z, BatchNorm
scales 1 + 0.1 z, running variances exp(0.2 z)), at two small depths and
crops; insightface's ``iresnet100`` state-dict layout; the benchmark's
count of its multiply-adds; its spans. The card's tests are in
``tests/test_torch_iresnet_cuda.py``."""

import numpy as np
import pytest
import torch
import torch.nn as nn

from facerec_torch.models import iresnet
from facerec_torch.models.iresnet import IResNet, build_iresnet_embedder
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
