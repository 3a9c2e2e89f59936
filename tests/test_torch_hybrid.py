"""The port's HybridNet against the JAX package's at full width (ResNet-18
trunk, 512-d tokens, 4 heads, FFN 2048) on the CPU: eval forward and
``embed`` at 64 px (4 tokens, the positional table resized) and at 224 px
(49 tokens, the table as it is), train forward with the BatchNorm
statistics, one train step, the positional-table resize alone, and the
attention-weight dropout's statistics against Flax's."""

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facerec_torch.convert import from_jax
from facerec_torch.eval.metrics import count_parameters
from facerec_torch.models import get_model
from facerec_torch.models.hybrid import MultiHeadAttention
from facerec_tpu.eval.metrics import count_parameters as jax_count_parameters

import torch_zoo as Z


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def hybrid():
    return Z.jax_variables("hybrid")


@pytest.mark.parametrize("size,n", [(64, 4), (224, 1)])
def test_eval_forward_and_embed_match_jax(hybrid, size, n):
    jm, v = hybrid
    x = Z.batch("hybrid", n=n, size=size, seed=3)["image"]
    net = Z.port_model("hybrid", v).eval()
    with torch.no_grad():
        got, emb = net(torch.from_numpy(x)), net.embed(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jm.apply(v, x)), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(emb.numpy(), np.asarray(jm.apply(v, x, method=jm.embed)),
                               atol=1e-4, rtol=1e-4)


def test_train_forward_matches_jax(hybrid):
    jm, v = hybrid
    x = Z.batch("hybrid", seed=4)["image"]
    ref, mutated = jax.jit(functools.partial(jm.apply, train=True, mutable=["batch_stats"]))(
        v, jnp.asarray(x))
    net = Z.port_model("hybrid", v).train()
    got = net(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)
    want = from_jax({"params": v["params"], **Z.np_tree(mutated)}, "hybrid")
    sd = net.state_dict()
    for k in [k for k in want if k.endswith(("running_mean", "running_var"))]:
        np.testing.assert_allclose(sd[k].numpy(), want[k].numpy(), atol=1e-4, rtol=1e-4, err_msg=k)


def test_one_train_step_matches_jax(hybrid, synthetic_imagefolder):
    """One SGD step on the same face batch, gradients through the
    positional table's resize included."""
    jm, v = hybrid
    net = Z.port_model("hybrid", v)
    jmet, _, tm, after = Z.one_step_each(jm, v, net, "hybrid",
                                         Z.face_batch("hybrid", synthetic_imagefolder))
    Z.assert_step_matches(jmet, tm, after, net)


def test_from_jax_and_counts_match(hybrid):
    _, v = hybrid
    port = get_model("hybrid", num_classes=Z.CLASSES)
    assert set(from_jax(v, "hybrid")) == set(port.state_dict())
    assert count_parameters(port) == jax_count_parameters(v["params"])
    assert port.transformer.dropout_rate == 0.1  # whatever the net's dropout_rate
    assert get_model("hybrid", dropout_rate=0.5).transformer.dropout_rate == 0.1


@pytest.mark.parametrize("rows", [25, 4, 1, 49])
def test_pos_table_resize_matches_jax(rows):
    """The 49-row table at 160, 64, 32 and 224 px: ``jax.image.resize(...,
    "linear")``, antialiased when it shrinks."""
    net = get_model("hybrid", num_classes=3)
    table = np.random.default_rng(rows).normal(size=(49, 512)).astype(np.float32)
    with torch.no_grad():
        net.pos_encoding.copy_(torch.from_numpy(table))
        got = net.positions(rows).numpy()
    ref = np.asarray(jax.image.resize(jnp.asarray(table), (rows, 512), method="linear"))
    assert got.shape == (rows, 512)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    if rows < 49:  # without the antialias the rows would differ
        plain = torch.nn.functional.interpolate(torch.from_numpy(table)[None, None],
                                                size=(rows, 512), mode="bilinear")
        assert np.abs(plain[0, 0].numpy() - ref).max() > 1e-3


def _probe_mha_weights(d: int, heads: int, s: int):
    """Query and key kernels 0 (uniform attention, 1/S) and identity value
    and output projections, as Flax kernels."""
    eye = np.eye(d, dtype=np.float32)
    z = np.zeros((d, heads, d // heads), np.float32)
    zb = np.zeros((heads, d // heads), np.float32)
    return {"query": {"kernel": z, "bias": zb}, "key": {"kernel": z, "bias": zb},
            "value": {"kernel": eye.reshape(d, heads, d // heads), "bias": zb},
            "out": {"kernel": eye.reshape(heads, d // heads, d), "bias": np.zeros(d, np.float32)}}


def test_attention_dropout_matches_flax_statistics():
    """With uniform attention (1/S) and identity value/output projections,
    token k's one-hot in every head's dims reads out each weight's dropout
    factor. Both packages: one [S, S] mask shared by every batch row and
    head, kept weights scaled by 1/keep, a kept share near keep."""
    d, heads, s, b, rate = 512, 4, 32, 3, 0.4
    x = np.zeros((b, s, d), np.float32)
    for h in range(heads):
        x[:, np.arange(s), h * (d // heads) + np.arange(s)] = 1.0
    p = _probe_mha_weights(d, heads, s)
    flax_mha = fnn.MultiHeadDotProductAttention(num_heads=heads, dropout_rate=rate,
                                                deterministic=False)
    ref = np.asarray(flax_mha.apply({"params": p}, x, x, rngs={"dropout": jax.random.key(0)}))
    mha = MultiHeadAttention(d, heads, rate).train()
    mha.load_state_dict(_mha_state(p))
    with torch.no_grad():
        got = mha(torch.from_numpy(x), torch.Generator().manual_seed(0)).numpy()
    for out in (ref, got):
        factors = np.stack([out[:, :, h * (d // heads):h * (d // heads) + s]
                            for h in range(heads)], axis=1) * s  # [B, H, S(q), S(k)]
        assert np.allclose(factors, factors[:1, :1], atol=1e-5)  # one mask for all b, h
        kept = factors[0, 0] > 0
        np.testing.assert_allclose(factors[0, 0][kept], 1 / (1 - rate), rtol=1e-5)
        assert abs(kept.mean() - (1 - rate)) < 0.05
    # without dropout the probe reads 1 everywhere
    with torch.no_grad():
        flat = mha.eval()(torch.from_numpy(x)).numpy()[:, :, :s] * s
    np.testing.assert_allclose(flat, 1.0, rtol=1e-5)


def _mha_state(p) -> dict:
    from facerec_torch.convert import _mha

    out = {}
    _mha(p, out, "m")
    return {k[2:]: v for k, v in out.items()}
