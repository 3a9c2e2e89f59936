"""The port's ResNetTransfer (``cnn``) and AttentionNet against the JAX
package's at full width on the CPU: eval forward and ``embed``, train
forward with the updated BatchNorm statistics, one train step, the weight
bridge, the parameter counts and Flax's initial statistics; then the
registry (all seven types, lists of types, unknown types) and ``train_model``
end to end for ``attention``."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facerec_torch.config import OptimizerConfig, TrainConfig
from facerec_torch.convert import from_jax
from facerec_torch.eval.metrics import count_parameters
from facerec_torch.models import MODEL_TYPES, EnsembleModel, get_model
from facerec_torch.models.arcface import init_like_flax
from facerec_torch.train.engine import train_model
from facerec_tpu.eval.metrics import count_parameters as jax_count_parameters
from facerec_tpu.models import MODEL_TYPES as JAX_MODEL_TYPES
from facerec_tpu.models import get_model as jax_get_model

import torch_zoo as Z

TYPES = ["cnn", "attention"]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module", params=TYPES)
def zoo(request):
    jm, v = Z.jax_variables(request.param)
    return request.param, jm, v


def test_eval_forward_and_embed_match_jax(zoo):
    mt, jm, v = zoo
    x = Z.batch(mt, seed=3)["image"]
    net = Z.port_model(mt, v).eval()
    with torch.no_grad():
        got, emb = net(torch.from_numpy(x)), net.embed(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jm.apply(v, x)), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(emb.numpy(), np.asarray(jm.apply(v, x, method=jm.embed)),
                               atol=1e-4, rtol=1e-4)


def test_train_forward_matches_jax(zoo):
    """Training mode: logits and the running statistics after one batch."""
    mt, jm, v = zoo
    x = Z.batch(mt, seed=4)["image"]
    ref, mutated = jax.jit(functools.partial(jm.apply, train=True, mutable=["batch_stats"]))(
        v, jnp.asarray(x))
    net = Z.port_model(mt, v).train()
    got = net(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)
    want = from_jax({"params": v["params"], **Z.np_tree(mutated)}, mt)
    sd = net.state_dict()
    for k in [k for k in want if k.endswith(("running_mean", "running_var"))]:
        np.testing.assert_allclose(sd[k].numpy(), want[k].numpy(), atol=1e-4, rtol=1e-4, err_msg=k)


def test_one_train_step_matches_jax(zoo, synthetic_imagefolder):
    """One SGD step of each package's train step on the same face batch:
    loss and grad_norm within 1e-4 relative, the parameters after it within
    1e-5 and the BatchNorm statistics within 1e-4."""
    mt, jm, v = zoo
    net = Z.port_model(mt, v)
    jmet, _, tm, after = Z.one_step_each(jm, v, net, mt, Z.face_batch(mt, synthetic_imagefolder))
    Z.assert_step_matches(jmet, tm, after, net)


def test_from_jax_and_counts_match(zoo):
    mt, _, v = zoo
    port = get_model(mt, num_classes=Z.CLASSES)
    assert set(from_jax(v, mt)) == set(port.state_dict())
    assert count_parameters(port) == jax_count_parameters(v["params"])


def test_registry_builds_all_seven_types():
    assert MODEL_TYPES == JAX_MODEL_TYPES
    for mt in MODEL_TYPES:
        assert isinstance(get_model(mt, num_classes=3), torch.nn.Module), mt
    ens = get_model(["cnn", "siamese"], num_classes=3, ensemble_method="max")
    assert isinstance(ens, EnsembleModel) and ens.member_types == ["cnn", "siamese"]
    assert ens.ensemble_method == "max"
    assert get_model("ensemble", num_classes=3).member_types == ["cnn", "attention", "arcface"]
    # the factory's default rates, as JAX's: a rate of None or 0 takes them
    assert get_model("cnn").dropout_rate == jax_get_model("cnn").dropout_rate == 0.1
    assert get_model("attention", dropout_rate=0.0).dropout_rate == 0.25
    with pytest.raises(ValueError, match="Invalid model type"):
        get_model("nope")
    with pytest.raises(ValueError, match="Invalid model type"):
        jax_get_model("nope")
    with pytest.raises(ValueError, match="ensemble method"):
        get_model(["cnn", "attention"], ensemble_method="vote")


def test_init_matches_flax_statistics():
    """``init_like_flax`` against a JAX init of the same models: LayerNorm
    scale 1 and bias 0, the attention's q/k/v/out kernels at std
    1/sqrt(512), the positional table at std 0.02, ``gamma`` 0, the
    ensemble's weights 1/n."""
    hybrid = get_model("hybrid", num_classes=4)
    init_like_flax(hybrid, torch.Generator().manual_seed(0))
    jv = jax.jit(functools.partial(jax_get_model("hybrid", num_classes=4).init, train=False))(
        {"params": jax.random.key(0)}, jnp.zeros((1, 32, 32, 3)))["params"]
    ref = from_jax({"params": Z.np_tree(jv), "batch_stats": _zero_stats(jv)}, "hybrid")
    sd = hybrid.state_dict()
    for k in ("transformer.norm1", "transformer.norm2", "norm"):
        assert torch.equal(sd[f"{k}.weight"], ref[f"{k}.weight"]) and not sd[f"{k}.bias"].any()
    for p in ("query", "key", "value", "out"):
        w, r = sd[f"transformer.attention.{p}.weight"], ref[f"transformer.attention.{p}.weight"]
        assert w.std().item() == pytest.approx(r.std().item(), rel=0.02)
        assert r.std().item() == pytest.approx(512 ** -0.5, rel=0.02)
        assert not sd[f"transformer.attention.{p}.bias"].any()
    assert sd["pos_encoding"].std().item() == pytest.approx(ref["pos_encoding"].std().item(),
                                                           rel=0.05)
    assert sd["pos_encoding"].std().item() == pytest.approx(0.02, rel=0.05)
    att = get_model("attention", num_classes=4)
    att.attention.gamma.data.fill_(3.0)
    init_like_flax(att, torch.Generator().manual_seed(0))
    assert att.attention.gamma.item() == 0.0
    ens = get_model(["cnn", "attention", "arcface"], num_classes=4, ensemble_method="attention")
    ens.weights.data.fill_(5.0)
    init_like_flax(ens, torch.Generator().manual_seed(0))
    assert torch.equal(ens.weights.detach(), torch.full((3,), 1 / 3))


def _zero_stats(params):
    """BatchNorm statistics of a ResNet-18 params tree (mean 0, var 1)."""
    def walk(p):
        if "scale" in p and "bias" in p and len(p) == 2:
            return {"mean": np.zeros_like(p["scale"]), "var": np.ones_like(p["scale"])}
        return {k: walk(s) for k, s in p.items() if isinstance(s, dict)}
    return {"backbone": walk(Z.np_tree(params["backbone"]))}


def test_train_model_attention_e2e(tmp_path):
    """``train_model`` on an attention net at 32 px for 2 epochs on the CPU:
    the JAX engine's artifacts, a finite falling loss, and the parameter
    groups of ``model_info.json``."""
    import json

    from facerec_torch.data.synthetic import write_synthetic_imagefolder

    root = write_synthetic_imagefolder(tmp_path / "ds", num_classes=3, per_class=8, size=32, seed=1)
    cfg = TrainConfig(model_type="attention", batch_size=8, epochs=2, image_size=32, seed=0,
                      early_stopping=False, checkpoint_every=0, compute_dtype="float32",
                      optimizer=OptimizerConfig(learning_rate=1e-3))
    out = train_model(cfg, root, checkpoints_root=tmp_path / "ck", model_name="att",
                      device="cpu")
    hist = out["history"]
    assert len(hist) == 2 and all(np.isfinite(r["train_loss"]) for r in hist)
    model_dir = tmp_path / "ck" / "att"
    for rel in ("best/state.pt", "final/state.pt", "metrics/training_metrics.csv",
                "metrics/confusion_matrix.json", "model_info.json"):
        assert (model_dir / rel).exists(), rel
    info = json.loads((model_dir / "model_info.json").read_text())
    assert set(info["parameters"]["by_module"]) == {"backbone", "attention", "fc"}
    cm = json.loads((model_dir / "metrics" / "confusion_matrix.json").read_text())["matrix"]
    assert np.asarray(cm).sum() == 3  # one test image per person
