"""Parity of the port's embed stage with the JAX package on the CPU: a
ResNet-18 ArcFace ``embed`` with weights (and non-trivial BatchNorm
statistics) carried by ``facerec_torch.convert.from_jax``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facerec_torch.convert import from_jax
from facerec_torch.models.arcface import ArcFaceNet, build_embedder
from facerec_tpu.models import get_model


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def variables():
    model = get_model("arcface", num_classes=18)
    v = model.init({"params": jax.random.key(1), "dropout": jax.random.key(2)},
                   jnp.zeros((1, 64, 64, 3)), labels=jnp.zeros(1, jnp.int32), train=True)
    rng = np.random.default_rng(3)
    stats = jax.tree_util.tree_map(
        lambda a: rng.uniform(0.6, 1.4, a.shape).astype(np.float32), v["batch_stats"])
    return {"params": jax.tree_util.tree_map(np.asarray, v["params"]), "batch_stats": stats}


def _crops():
    return np.random.default_rng(0).uniform(0, 255, (3, 64, 64, 3)).astype(np.float32)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 1e-2)])
def test_arcface_embed_matches_jax(variables, dtype, tol):
    model = get_model("arcface", num_classes=18, compute_dtype=dtype)
    crops = _crops()
    ref = np.asarray(model.apply(variables, jnp.asarray(crops), method="embed"))
    net = build_embedder(variables, dtype=getattr(torch, dtype), device="cpu")
    with torch.no_grad():
        got = net.embed(torch.from_numpy(crops)).numpy()
    assert got.shape == ref.shape == (3, 512) and got.dtype == np.float32
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)
    cos = np.sum(got * ref, axis=1) / np.linalg.norm(ref, axis=1)
    assert np.all(1.0 - cos < tol), 1.0 - cos


def test_from_jax_covers_every_tensor(variables):
    sd = from_jax(variables, "arcface")
    assert set(sd) == set(ArcFaceNet().state_dict())
    assert sd["backbone.conv1.weight"].shape == (64, 3, 7, 7)
    assert sd["embedding.weight"].shape == (512, 512)
    np.testing.assert_array_equal(sd["backbone.layer2.0.downsample.1.running_var"].numpy(),
                                  variables["batch_stats"]["backbone"]["layer2_0"]["downsample_bn"]["var"])


def test_seeded_embedder_is_reproducible():
    a = build_embedder(width=8, embedding_dim=16, dtype=torch.float32, seed=5, device="cpu")
    b = build_embedder(width=8, embedding_dim=16, dtype=torch.float32, seed=5, device="cpu")
    c = build_embedder(width=8, embedding_dim=16, dtype=torch.float32, seed=6, device="cpu")
    x = torch.from_numpy(_crops())
    with torch.no_grad():
        assert torch.equal(a.embed(x), b.embed(x))
        assert not torch.equal(a.embed(x), c.embed(x))
