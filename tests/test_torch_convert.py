"""``facerec_torch.models.convert`` against the JAX package's converters on
the CPU: reference ``.pth`` layouts (the replicas of
``tools/torch_replicas.py``) to the port's state dicts and back for every
model type, facenet-pytorch's MTCNN nets (their (W, H, C) dense order, and
O-Net's 128 x 3 x 3 map), and the ``.pt`` branch of the detector loader."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn as tnn

from facerec_torch.convert import from_jax
from facerec_torch.data.synthetic import face_frames
from facerec_torch.detect.mtcnn import MTCNN, ONet, PNet, RNet
from facerec_torch.detect.weights import (CLASSIC_THRESHOLDS, load_detector_params,
                                          load_detector_params_with_source)
from facerec_torch.models import ArcFaceNet, AttentionNet, BaselineNet, HybridNet, ResNetTransfer, SiameseNet
from facerec_torch.models.convert import (CONVERTERS, convert_checkpoint, convert_mtcnn_net,
                                          load_torch_state_dict, to_reference_state_dict)
from facerec_tpu.detect.mtcnn import RNet as JaxRNet
from facerec_tpu.models import convert as jax_convert

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
from torch_replicas import (REPLICAS, TorchArcFaceNet, TorchHybridNet,  # noqa: E402
                            make_default_ensemble, randomize_bn_stats)

CLASSES = 5
TYPES = ["baseline", "cnn", "attention", "arcface", "hybrid", "siamese"]
# test_convert.py's bars for the JAX conversion of each type: (atol, or a
# cosine error for the embedders)
ATOL = {"baseline": 2e-5, "cnn": 1e-3, "attention": 2e-4, "arcface": 1e-4, "hybrid": 2e-4,
        "siamese": 2e-4}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _replica(model_type, seed):
    torch.manual_seed(seed)
    if model_type == "hybrid":
        tm = TorchHybridNet(num_classes=CLASSES, seq=4)
    elif model_type == "siamese":
        tm = REPLICAS["siamese"]()
    else:
        tm = REPLICAS[model_type](num_classes=CLASSES)
    randomize_bn_stats(tm, seed)
    return tm.eval()


def _port_model(model_type):
    return {"baseline": lambda: BaselineNet(CLASSES), "cnn": lambda: ResNetTransfer(CLASSES),
            "attention": lambda: AttentionNet(CLASSES), "arcface": lambda: ArcFaceNet(num_classes=CLASSES),
            "hybrid": lambda: HybridNet(CLASSES, seq_len=4), "siamese": SiameseNet}[model_type]()


def _numpy_sd(m):
    sd = m.state_dict() if isinstance(m, tnn.Module) else m
    return {k: v.numpy() for k, v in sd.items()}


def _cos_err(a, b):
    a = a / np.linalg.norm(a, axis=-1, keepdims=True)
    b = b / np.linalg.norm(b, axis=-1, keepdims=True)
    return float(np.max(1.0 - np.sum(a * b, axis=-1)))


def _assert_same(got: dict, want: dict, skip_counts: bool = False):
    assert set(got) == set(want), sorted(set(got) ^ set(want))
    for k in want:
        if skip_counts and k.endswith("num_batches_tracked"):
            continue
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("model_type", TYPES)
def test_convert_checkpoint_matches_jax_and_replica(model_type, tmp_path):
    """A reference ``.pth`` (wrapped as the reference's trainer saves it)
    through the port's converter equals JAX's converter followed by
    ``from_jax``, tensor for tensor; the port's model on it agrees with the
    replica."""
    tm = _replica(model_type, 20 + TYPES.index(model_type))
    torch.save({"model_state_dict": tm.state_dict(), "epoch": 3}, tmp_path / "ref.pth")
    got = convert_checkpoint(tmp_path / "ref.pth", model_type)
    _assert_same(got, from_jax(jax_convert.CONVERTERS[model_type](_numpy_sd(tm)), model_type))

    net = _port_model(model_type)
    net.load_state_dict(got)
    net.eval()
    rng = np.random.default_rng(9)
    size = 96 if model_type == "siamese" else 64
    x = rng.normal(size=(2, size, size, 3)).astype(np.float32)
    xt, xn = torch.from_numpy(x), torch.from_numpy(x.transpose(0, 3, 1, 2))
    with torch.no_grad():
        if model_type == "siamese":
            xb = rng.normal(size=(2, size, size, 3)).astype(np.float32)
            ea, eb = net(xt, torch.from_numpy(xb))
            ta, tb = tm(xn, torch.from_numpy(xb.transpose(0, 3, 1, 2)))
            assert _cos_err(ea.numpy(), ta.numpy()) < 1e-3 and _cos_err(eb.numpy(), tb.numpy()) < 1e-3
            np.testing.assert_allclose(ea.numpy(), ta.numpy(), atol=ATOL[model_type])
        elif model_type == "arcface":
            assert _cos_err(net.embed(xt).numpy(), tm(xn).numpy()) < 1e-3
            np.testing.assert_allclose(net.eval_logits(xt).numpy(), tm.eval_logits(xn).numpy(),
                                       atol=ATOL[model_type])
        else:
            np.testing.assert_allclose(net(xt).numpy(), tm(xn).numpy(), atol=ATOL[model_type])


def test_converters_cover_the_reference_types():
    assert set(CONVERTERS) == set(jax_convert.CONVERTERS) == set(TYPES)
    with pytest.raises(ValueError, match="no converter"):
        convert_checkpoint("unused.pth", "ensemble")


def test_arcface_val_classifier_is_dropped():
    """The reference's ArcFace carries a randomly initialised
    ``val_classifier`` that JAX's converter drops; so does the port's."""
    sd = dict(TorchArcFaceNet(num_classes=CLASSES).state_dict())
    sd["val_classifier.weight"] = torch.zeros(CLASSES, 512)
    sd["val_classifier.bias"] = torch.zeros(CLASSES)
    assert set(CONVERTERS["arcface"](sd)) == set(ArcFaceNet(num_classes=CLASSES).state_dict())


def _jax_tree(model_type, seed):
    """A JAX parameter tree (numpy) of ``model_type``, made by JAX's
    converter from a seeded replica; the ensemble's from its three
    members'."""
    if model_type != "ensemble":
        return jax_convert.CONVERTERS[model_type](_numpy_sd(_replica(model_type, seed)))
    torch.manual_seed(seed)
    members = make_default_ensemble(CLASSES).models
    tree = {"params": {}, "batch_stats": {}}
    for i, (t, m) in enumerate(zip(["cnn", "attention", "arcface"], members)):
        randomize_bn_stats(m, seed + i)
        sub = jax_convert.CONVERTERS[t](_numpy_sd(m))
        tree["params"][f"members_{i}"] = sub["params"]
        tree["batch_stats"][f"members_{i}"] = sub["batch_stats"]
    return tree


@pytest.mark.parametrize("model_type", TYPES + ["ensemble"])
def test_to_reference_matches_jax_and_loads_strict(model_type):
    """The port's state dict in the reference's layout equals JAX's
    ``flax_to_torch_state_dict`` key for key (JAX writes every BatchNorm's
    ``num_batches_tracked`` as 1; the JAX tree holds no count, and the port
    carries its own), and loads strict into the reference's model."""
    tree = _jax_tree(model_type, 40 + len(model_type))
    got = to_reference_state_dict(from_jax(tree, model_type), model_type)
    _assert_same(got, jax_convert.flax_to_torch_state_dict(tree, model_type), skip_counts=True)
    if model_type == "hybrid":
        ref = TorchHybridNet(num_classes=CLASSES, seq=4)
    elif model_type == "siamese":
        ref = REPLICAS["siamese"]()
    else:
        ref = REPLICAS[model_type](num_classes=CLASSES)
    ref.load_state_dict(got, strict=True)


def test_round_trip_is_exact():
    for model_type in TYPES:
        sd = _replica(model_type, 60).state_dict()
        back = to_reference_state_dict(CONVERTERS[model_type](sd), model_type)
        _assert_same(back, sd)
    with pytest.raises(ValueError, match="no reverse converter"):
        to_reference_state_dict({}, "facenet")


def test_load_torch_state_dict_unwraps_and_refuses_objects(tmp_path):
    sd = {"a.weight": torch.ones(2), "a.bias": torch.zeros(2)}
    for i, obj in enumerate([sd, {"state_dict": sd}, {"model_state_dict": sd, "epoch": 4}]):
        torch.save(obj, tmp_path / f"{i}.pth")
        _assert_same(load_torch_state_dict(tmp_path / f"{i}.pth"), sd)
    torch.save({"model_state_dict": sd, "path": Path("x")}, tmp_path / "obj.pth")
    with pytest.raises(Exception, match="[Ww]eights only load failed"):
        load_torch_state_dict(tmp_path / "obj.pth")


def test_jax_npz_claim_does_not_hold(tmp_path):
    """The JAX demo's docstring says FACEREC_FACENET_WEIGHTS may name a
    ``.npz``; its loader, ``torch.load``, cannot read one (ROADMAP section
    3), and neither can the port's."""
    np.savez(tmp_path / "facenet.npz", **{"conv2d_1a.conv.weight": np.zeros((32, 3, 3, 3))})
    with pytest.raises(RuntimeError):
        jax_convert.load_torch_state_dict(tmp_path / "facenet.npz")
    with pytest.raises(RuntimeError):
        load_torch_state_dict(tmp_path / "facenet.npz")


# facenet-pytorch's MTCNN nets (facenet_pytorch/models/mtcnn.py): NCHW, and
# R-Net/O-Net flatten x.permute(0, 3, 2, 1), in (W, H, C) order
class FacenetPytorchPNet(tnn.Module):
    def __init__(self):
        super().__init__()
        self.conv1, self.prelu1 = tnn.Conv2d(3, 10, 3), tnn.PReLU(10)
        self.pool1 = tnn.MaxPool2d(2, 2, ceil_mode=True)
        self.conv2, self.prelu2 = tnn.Conv2d(10, 16, 3), tnn.PReLU(16)
        self.conv3, self.prelu3 = tnn.Conv2d(16, 32, 3), tnn.PReLU(32)
        self.conv4_1 = tnn.Conv2d(32, 2, 1)
        self.conv4_2 = tnn.Conv2d(32, 4, 1)

    def forward(self, x):
        x = self.pool1(self.prelu1(self.conv1(x)))
        x = self.prelu3(self.conv3(self.prelu2(self.conv2(x))))
        return torch.softmax(self.conv4_1(x), dim=1)[:, 1], self.conv4_2(x).permute(0, 2, 3, 1)


class FacenetPytorchRNet(tnn.Module):
    def __init__(self):
        super().__init__()
        self.conv1, self.prelu1 = tnn.Conv2d(3, 28, 3), tnn.PReLU(28)
        self.pool1 = tnn.MaxPool2d(3, 2, ceil_mode=True)
        self.conv2, self.prelu2 = tnn.Conv2d(28, 48, 3), tnn.PReLU(48)
        self.pool2 = tnn.MaxPool2d(3, 2, ceil_mode=True)
        self.conv3, self.prelu3 = tnn.Conv2d(48, 64, 2), tnn.PReLU(64)
        self.dense4, self.prelu4 = tnn.Linear(576, 128), tnn.PReLU(128)
        self.dense5_1 = tnn.Linear(128, 2)
        self.dense5_2 = tnn.Linear(128, 4)

    def forward(self, x):
        x = self.pool1(self.prelu1(self.conv1(x)))
        x = self.pool2(self.prelu2(self.conv2(x)))
        x = self.prelu3(self.conv3(x))
        x = x.permute(0, 3, 2, 1).contiguous()
        x = self.prelu4(self.dense4(x.view(x.shape[0], -1)))
        return torch.softmax(self.dense5_1(x), dim=1)[:, 1], self.dense5_2(x)


class FacenetPytorchONet(tnn.Module):
    def __init__(self):
        super().__init__()
        self.conv1, self.prelu1 = tnn.Conv2d(3, 32, 3), tnn.PReLU(32)
        self.pool1 = tnn.MaxPool2d(3, 2, ceil_mode=True)
        self.conv2, self.prelu2 = tnn.Conv2d(32, 64, 3), tnn.PReLU(64)
        self.pool2 = tnn.MaxPool2d(3, 2, ceil_mode=True)
        self.conv3, self.prelu3 = tnn.Conv2d(64, 64, 3), tnn.PReLU(64)
        self.pool3 = tnn.MaxPool2d(2, 2, ceil_mode=True)
        self.conv4, self.prelu4 = tnn.Conv2d(64, 128, 2), tnn.PReLU(128)
        self.dense5, self.prelu5 = tnn.Linear(1152, 256), tnn.PReLU(256)
        self.dense6_1 = tnn.Linear(256, 2)
        self.dense6_2 = tnn.Linear(256, 4)
        self.dense6_3 = tnn.Linear(256, 10)

    def forward(self, x):
        x = self.pool1(self.prelu1(self.conv1(x)))
        x = self.pool2(self.prelu2(self.conv2(x)))
        x = self.pool3(self.prelu3(self.conv3(x)))
        x = self.prelu4(self.conv4(x))
        x = x.permute(0, 3, 2, 1).contiguous()
        x = self.prelu5(self.dense5(x.view(x.shape[0], -1)))
        return (torch.softmax(self.dense6_1(x), dim=1)[:, 1], self.dense6_2(x),
                self.dense6_3(x))


NETS = {"pnet": (FacenetPytorchPNet, PNet, 25), "rnet": (FacenetPytorchRNet, RNet, 24),
        "onet": (FacenetPytorchONet, ONet, 48)}


def _facenet_pytorch_net(which, seed):
    torch.manual_seed(seed)
    tm = NETS[which][0]().eval()
    for p in tm.parameters():
        p.data.uniform_(-0.2, 0.2)
    return tm


@pytest.mark.parametrize("which", ["pnet", "rnet", "onet"])
def test_mtcnn_net_matches_facenet_pytorch(which):
    """The port's net on converted facenet-pytorch weights agrees with the
    facenet-pytorch net within 1e-5 (relative, for O-Net's landmark outputs
    of up to ~60 at these weights, and absolute), O-Net over its whole
    128 x 3 x 3 map."""
    tm = _facenet_pytorch_net(which, 70)
    net = NETS[which][1]()
    net.load_state_dict(convert_mtcnn_net(tm.state_dict(), which))
    size = NETS[which][2]
    x = np.random.default_rng(3).normal(size=(3, size, size, 3)).astype(np.float32)
    with torch.no_grad():
        got = net.eval()(torch.from_numpy(x))
        want = tm(torch.from_numpy(x.transpose(0, 3, 1, 2)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5, atol=1e-5)


def test_pnet_conversion_equals_jax():
    sd = _facenet_pytorch_net("pnet", 71).state_dict()
    _assert_same(convert_mtcnn_net(sd, "pnet"),
                 from_jax(jax_convert.convert_mtcnn_net(_numpy_sd(sd), "pnet")["params"], "pnet"))


def test_jax_converter_misreads_rnet_and_onet():
    """JAX's converter assumes (C, H, W) rows before R-Net's dense4, where
    facenet-pytorch flattens (W, H, C), and permutes O-Net's dense5 as a
    128 x 2 x 2 map, 512 of its 1,152 rows (ROADMAP section 3)."""
    tm = _facenet_pytorch_net("rnet", 72)
    x = np.random.default_rng(4).normal(size=(3, 24, 24, 3)).astype(np.float32)
    tree = jax_convert.convert_mtcnn_net(_numpy_sd(tm), "rnet")
    jax_prob, _ = JaxRNet().apply({"params": tree["params"]}, x)
    with torch.no_grad():
        want, _ = tm(torch.from_numpy(x.transpose(0, 3, 1, 2)))
    assert np.abs(np.asarray(jax_prob) - want.numpy()).max() > 1e-3
    onet = jax_convert.convert_mtcnn_net(_numpy_sd(_facenet_pytorch_net("onet", 73)), "onet")
    assert onet["params"]["dense5"]["kernel"].shape == (512, 256)
    assert convert_mtcnn_net(_facenet_pytorch_net("onet", 73).state_dict(),
                             "onet")["dense5.weight"].shape == (256, 1152)


def _to_facenet_pytorch(sd, which):
    """The port's MTCNN state dict in facenet-pytorch's layout: the dense
    columns from (H, W, C) back to (W, H, C) order."""
    out = dict(sd)
    dense = {"rnet": ("dense4", 64), "onet": ("dense5", 128)}.get(which)
    if dense:
        name, c = dense
        whc_of_hwc = np.arange(9 * c).reshape(3, 3, c).transpose(1, 0, 2).reshape(-1)
        out[f"{name}.weight"] = sd[f"{name}.weight"][:, torch.from_numpy(np.argsort(whc_of_hwc))]
    return out


def test_pt_branch_loads_pretrained(tmp_path, monkeypatch):
    """facenet-pytorch ``{pnet,rnet,onet}.pt`` files made from the committed
    weights load through the ``.pt`` branch as "pretrained" (the classic
    thresholds), equal to the ``.npz`` trees, and detect the same boxes."""
    monkeypatch.delenv("FACEREC_MTCNN_WEIGHTS", raising=False)
    npz = load_detector_params()
    for n in ("pnet", "rnet", "onet"):
        torch.save(_to_facenet_pytorch(from_jax(npz[n], n), n), tmp_path / f"{n}.pt")
    params, source = load_detector_params_with_source(tmp_path)
    assert source == "pretrained"
    for n in ("pnet", "rnet", "onet"):
        _assert_same(from_jax(params[n], n), from_jax(npz[n], n))
    monkeypatch.setenv("FACEREC_MTCNN_WEIGHTS", str(tmp_path))
    assert load_detector_params_with_source()[1] == "pretrained"

    hw = (120, 160)
    frames = torch.from_numpy(face_frames(2, hw, 1, np.random.default_rng(0)))
    kw = dict(min_face_size=40, max_faces=2, k_pnet=16, k_rnet=8, thresholds=CLASSIC_THRESHOLDS,
              device="cpu")
    a = MTCNN(hw, **kw).load_jax_params(params).detect(frames)
    b = MTCNN(hw, **kw).load_jax_params(npz).detect(frames)
    assert torch.equal(a.valid, b.valid) and torch.equal(a.boxes, b.boxes)
