"""``facerec_torch.models.fold`` against the JAX package's BatchNorm folding
(tests/test_fold.py's models, statistics and bars) on the CPU: ResNet-18,
the ArcFace embedding and InceptionResnetV1 at repeats (1, 1, 1), the port
folded against JAX folded and against the port unfolded; and the three
refusals."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as tnn

from facerec_torch.convert import _resnet18, from_jax
from facerec_torch.models import ArcFaceNet, BaselineNet, ResNet18
from facerec_torch.models.facenet import InceptionResnetV1
from facerec_torch.models.fold import FoldedBias, fold_batchnorm, folded_arcface, folded_facenet
from facerec_tpu.models import ResNet18 as JaxResNet18
from facerec_tpu.models import get_model
from facerec_tpu.models.fold import fold_batchnorm as jax_fold_batchnorm
from facerec_tpu.models.fold import folded_arcface as jax_folded_arcface
from torch_facenet import JaxFaceNetPublished, seeded_variables


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _randomize_bn(variables, rng):
    """tests/test_fold.py's statistics: scale U(0.5, 1.5), bias N(0, 0.3),
    mean N(0, 0.5), var U(0.3, 2.0), on numpy copies."""
    params = jax.tree_util.tree_map(np.array, variables["params"])
    stats = jax.tree_util.tree_map(np.array, variables["batch_stats"])

    def walk(p, s):
        for k, v in p.items():
            if isinstance(v, dict) and "scale" in v and k in s and "mean" in s[k]:
                n = v["scale"].shape[0]
                v["scale"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
                v["bias"] = rng.normal(0, 0.3, n).astype(np.float32)
                s[k]["mean"] = rng.normal(0, 0.5, n).astype(np.float32)
                s[k]["var"] = rng.uniform(0.3, 2.0, n).astype(np.float32)
            elif isinstance(v, dict):
                walk(v, s.get(k, {}))

    walk(params, stats)
    return {"params": params, "batch_stats": stats}


def _cos(a, b):
    return np.sum(a * b, axis=-1) / np.linalg.norm(a, axis=-1) / np.linalg.norm(b, axis=-1)


def _no_batchnorm_left(folded, module):
    n_bn = sum(isinstance(m, tnn.modules.batchnorm._BatchNorm) for m in module.modules())
    assert n_bn > 0
    assert not any(isinstance(m, tnn.modules.batchnorm._BatchNorm) for m in folded.modules())
    assert sum(isinstance(m, FoldedBias) for m in folded.modules()) == n_bn


def test_resnet18_fold_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (2, 64, 64, 3)).astype(np.float32)
    variables = _randomize_bn(jax.jit(JaxResNet18().init)(jax.random.key(0), jnp.asarray(x)), rng)
    ref = np.asarray(JaxResNet18(folded=True).apply(jax_fold_batchnorm(variables), x))
    sd: dict = {}
    _resnet18(variables["params"], variables["batch_stats"], sd, "")
    net = ResNet18()
    net.load_state_dict(sd)
    net.eval()
    folded = fold_batchnorm(net)
    _no_batchnorm_left(folded, net)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = folded.features(xt).permute(0, 2, 3, 1).numpy()
        unfolded = net.features(xt).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(got, unfolded, atol=2e-4, rtol=2e-4)


@pytest.fixture(scope="module")
def arcface_vars():
    rng = np.random.default_rng(1)
    model = get_model("arcface", num_classes=6)
    v = jax.jit(functools.partial(model.init, train=True))(
        {"params": jax.random.key(1), "dropout": jax.random.key(2)},
        jnp.zeros((1, 64, 64, 3)), labels=jnp.zeros(1, jnp.int32))
    return _randomize_bn(v, rng)


def test_arcface_embed_fold_matches_jax(arcface_vars):
    x = np.random.default_rng(11).normal(0, 1, (3, 64, 64, 3)).astype(np.float32)
    ref = np.asarray(get_model("arcface", num_classes=6, arcface_kwargs={"folded": True}).apply(
        jax_fold_batchnorm(arcface_vars), x, method="embed"))
    net = ArcFaceNet(num_classes=6)
    net.load_state_dict(from_jax(arcface_vars, "arcface"))
    net.eval()
    folded = fold_batchnorm(net)
    _no_batchnorm_left(folded, net)
    with torch.no_grad():
        got = folded.embed(torch.from_numpy(x)).numpy()
        unfolded = net.embed(torch.from_numpy(x)).numpy()
    for other in (ref, unfolded):
        assert float(np.min(_cos(got, other))) > 1 - 1e-6
        np.testing.assert_allclose(got, other, atol=1e-4)


def test_folded_arcface_helper_matches_jax(arcface_vars):
    """``folded_arcface`` (a port state dict in, a folded embedder out)
    against JAX's ``folded_arcface``."""
    x = np.random.default_rng(12).normal(0, 1, (2, 64, 64, 3)).astype(np.float32)
    jax_model, jax_vars = jax_folded_arcface(6, arcface_vars, compute_dtype="float32")
    ref = np.asarray(jax_model.apply(jax_vars, x, method="embed"))
    folded = folded_arcface(from_jax(arcface_vars, "arcface"), dtype=torch.float32, device="cpu")
    with torch.no_grad():
        got = folded.embed(torch.from_numpy(x)).numpy()
    assert float(np.min(_cos(got, ref))) > 1 - 1e-6
    assert folded.arc_weight.shape == (6, 512) and not folded.training


def test_facenet_fold_matches_jax():
    """InceptionResnetV1 (BatchNorm eps 1e-3) folded, against JAX's on the
    repaired net (tests/torch_facenet.py) and against the port unfolded."""
    variables = seeded_variables((1, 1, 1), 4)
    x = (np.random.default_rng(4).normal(0, 1, (2, 160, 160, 3)) * 60 + 120).astype(np.float32)
    ref = np.asarray(JaxFaceNetPublished(repeats=(1, 1, 1), folded=True).apply(
        jax_fold_batchnorm(variables, eps=1e-3), x))
    net = InceptionResnetV1((1, 1, 1))
    net.load_state_dict(from_jax(variables, "facenet"))
    net.eval()
    folded = fold_batchnorm(net)
    _no_batchnorm_left(folded, net)
    crops = torch.from_numpy(x * 128.0 + 127.5)  # the port's embed standardises 0..255 crops
    with torch.no_grad():
        got = folded.embed(crops).numpy()
        unfolded = net.embed(crops).numpy()
    for other in (ref, unfolded):
        assert float(np.min(_cos(got, other))) > 1 - 1e-6
        np.testing.assert_allclose(got, other, atol=1e-4)
    helper = folded_facenet(from_jax(variables, "facenet"), dtype=torch.float32, device="cpu")
    with torch.no_grad():
        same = helper.embed(crops).numpy()
    assert float(np.min(_cos(same, got))) > 1 - 1e-6


def test_folded_model_rejects_train():
    folded = fold_batchnorm(ArcFaceNet(num_classes=4))
    assert not folded.training and not folded.bn.training
    with pytest.raises(ValueError, match="eval-only"):
        folded.train()
    with pytest.raises(ValueError, match="eval-only"):
        folded.bn.train()
    folded.eval()
    assert not folded.training


def test_fold_rejects_orphan_bn():
    class Orphan(tnn.Module):
        def __init__(self):
            super().__init__()
            self.bn1 = tnn.BatchNorm2d(4)
            self.conv2 = tnn.Conv2d(4, 4, 1, bias=False)

    with pytest.raises(ValueError, match="no foldable producer"):
        fold_batchnorm(Orphan())


def test_fold_rejects_missing_stats():
    """A BatchNorm without running statistics must raise, not leave beta as a
    raw bias and the weights unscaled."""
    net = ArcFaceNet(num_classes=4)
    net.backbone.layer2[0].bn1.running_var = None
    with pytest.raises(ValueError, match="no running statistics"):
        fold_batchnorm(net)


def test_fold_rejects_a_producer_with_bias():
    """BaselineNet's convolutions carry biases before their BatchNorms: both
    packages refuse to fold it."""
    with pytest.raises(ValueError, match="carries a bias"):
        fold_batchnorm(BaselineNet(4))
    model = get_model("baseline", num_classes=4)
    shapes = jax.eval_shape(model.init, {"params": jax.random.key(0),
                                         "dropout": jax.random.key(1)}, jnp.zeros((1, 32, 32, 3)))
    with pytest.raises(ValueError, match="carries a bias"):
        jax_fold_batchnorm(jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype), shapes))
