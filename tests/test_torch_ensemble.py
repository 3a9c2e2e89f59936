"""The port's EnsembleModel against the JAX package's on the CPU, with the
default members (cnn, attention, arcface) at full width: logits and
``embed`` for each combining method, one train step that leaves the
members' running statistics alone on both sides, and ``evaluate_model`` on
an ensemble built by ``create_pretrained_ensemble`` from member
checkpoints."""

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facerec_torch.config import EvalConfig
from facerec_torch.convert import from_jax
from facerec_torch.data.synthetic import write_synthetic_imagefolder
from facerec_torch.eval.engine import evaluate_model
from facerec_torch.eval.metrics import count_parameters
from facerec_torch.models import DEFAULT_ENSEMBLE_MEMBERS, get_model
from facerec_torch.models.ensemble import create_pretrained_ensemble
from facerec_torch.train.checkpoints import save_checkpoint
from facerec_tpu.config import EvalConfig as JaxEvalConfig
from facerec_tpu.eval.engine import evaluate_model as jax_evaluate_model
from facerec_tpu.eval.metrics import count_parameters as jax_count_parameters
from facerec_tpu.models import create_ensemble as jax_create_ensemble
from facerec_tpu.models import get_model as jax_get_model
from facerec_tpu.models.ensemble import EnsembleModel as JaxEnsembleModel
from facerec_tpu.train.checkpoints import save_checkpoint as jax_save_checkpoint

import torch_zoo as Z

SIZE = 32
METHODS = ["average", "weighted", "attention", "max"]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def attention_vars():
    """The attention-combined ensemble's tree, which holds every method's
    parameters: the members from a JAX init of the average ensemble with
    random statistics, and seeded combiner parameters, ``weights`` away from
    1/n so that the weighted methods differ from the average."""
    jm = jax_create_ensemble(DEFAULT_ENSEMBLE_MEMBERS, Z.CLASSES, "average")
    v = jax.jit(functools.partial(jm.init, train=False))(
        {"params": jax.random.key(5), "dropout": jax.random.key(6)}, jnp.zeros((1, SIZE, SIZE, 3)))
    v = {"params": Z.np_tree(v["params"]), "batch_stats": Z.random_stats(v["batch_stats"], 8)}
    rng = np.random.default_rng(9)
    n = len(DEFAULT_ENSEMBLE_MEMBERS)
    v["params"]["weights"] = np.array([0.9, -0.4, 0.2], np.float32)
    v["params"]["attn1"] = {"kernel": rng.normal(0, n ** -0.5, (n, 64)).astype(np.float32),
                            "bias": rng.normal(0, 0.1, 64).astype(np.float32)}
    v["params"]["attn2"] = {"kernel": rng.normal(0, 0.125, (64, n)).astype(np.float32),
                            "bias": rng.normal(0, 0.1, n).astype(np.float32)}
    return v


class JaxEnsemble(JaxEnsembleModel):
    """JAX's EnsembleModel with a ``weights`` initialiser that takes the
    dtype Flax passes (the package's takes (key, shape) only, so Flax's
    shape check raises a TypeError whenever a weighted or attention
    ensemble is initialised or applied); its combining code is JAX's."""

    def setup(self):
        n = len(self.members)
        if self.ensemble_method in ("weighted", "attention"):
            self.weights = self.param("weights", lambda k, s, d=jnp.float32: jnp.full(s, 1.0 / n, d),
                                      (n,), self.param_dtype)
        if self.ensemble_method == "attention":
            self.attn1 = fnn.Dense(64, dtype=self.dtype, param_dtype=self.param_dtype, name="attn1")
            self.attn2 = fnn.Dense(n, dtype=self.dtype, param_dtype=self.param_dtype, name="attn2")


def _jax_ensemble(method):
    members = tuple(jax_get_model(t, num_classes=Z.CLASSES) for t in DEFAULT_ENSEMBLE_MEMBERS)
    return JaxEnsemble(members=members, member_types=tuple(DEFAULT_ENSEMBLE_MEMBERS),
                       ensemble_method=method)


def test_weighted_ensemble_initialises_as_jax_means_it_to():
    """The JAX package's weighted ensemble raises at ``init``; with its
    initialiser repaired it starts at 1/n, as the port's does."""
    jm = jax_create_ensemble(["cnn", "attention"], Z.CLASSES, "weighted")
    x = jnp.zeros((1, SIZE, SIZE, 3))
    with pytest.raises(TypeError):
        jm.init({"params": jax.random.key(0)}, x)
    members = tuple(jax_get_model(t, num_classes=Z.CLASSES) for t in ("cnn", "attention"))
    fixed = JaxEnsemble(members=members, member_types=("cnn", "attention"),
                        ensemble_method="weighted")
    ref = jax.eval_shape(functools.partial(fixed.init, train=False), jax.random.key(0), x)
    assert ref["params"]["weights"].shape == (2,)
    net = get_model(["cnn", "attention"], num_classes=Z.CLASSES, ensemble_method="weighted")
    assert torch.equal(net.weights.detach(), torch.full((2,), 0.5))


def _method_vars(v, method):
    drop = {"average": ("weights", "attn1", "attn2"), "max": ("weights", "attn1", "attn2"),
            "weighted": ("attn1", "attn2"), "attention": ()}[method]
    return {"params": {k: p for k, p in v["params"].items() if k not in drop},
            "batch_stats": v["batch_stats"]}


def _port(v, method):
    net = get_model(DEFAULT_ENSEMBLE_MEMBERS, num_classes=Z.CLASSES, ensemble_method=method)
    net.load_state_dict(from_jax(v, "ensemble"))
    return net


@pytest.mark.parametrize("method", METHODS)
def test_logits_and_embed_match_jax(attention_vars, method):
    v = _method_vars(attention_vars, method)
    jm = _jax_ensemble(method)
    net = _port(v, method).eval()
    x = Z.batch("ensemble", n=3, size=SIZE, seed=11)["image"]
    with torch.no_grad():
        got, emb = net(torch.from_numpy(x)), net.embed(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jm.apply(v, x)), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(emb.numpy(), np.asarray(jm.apply(v, x, method=jm.embed)),
                               atol=1e-4, rtol=1e-4)
    assert emb.shape == (3, 512 * 3)
    assert set(from_jax(v, "ensemble")) == set(net.state_dict())
    assert count_parameters(net) == jax_count_parameters(v["params"])


def test_average_is_the_mean_of_the_members(attention_vars):
    net = _port(_method_vars(attention_vars, "average"), "average").eval()
    x = torch.from_numpy(Z.batch("ensemble", n=2, size=SIZE, seed=12)["image"])
    with torch.no_grad():
        members = [net.members_0(x), net.members_1(x),
                   net.members_2(x, labels=torch.zeros(2, dtype=torch.long))]
        torch.testing.assert_close(net(x), torch.stack(members).mean(0), atol=1e-6, rtol=0)


def test_one_train_step_matches_jax_and_leaves_member_stats(attention_vars, synthetic_imagefolder):
    """One SGD step of a weighted ensemble: both packages run the members in
    eval mode (their running statistics do not move) while every parameter,
    the members' included, takes the step; loss, grad_norm and the
    parameters after it as for the single models."""
    v = _method_vars(attention_vars, "weighted")
    jm = _jax_ensemble("weighted")
    net = _port(v, "weighted")
    net.train()
    assert net.training and not any(m.training for m in net.members)
    before = {k: t.clone() for k, t in net.state_dict().items()}
    jmet, jstate, tm, after = Z.one_step_each(jm, v, net, "ensemble",
                                              Z.face_batch("ensemble", synthetic_imagefolder,
                                                           size=SIZE),
                                              member_types=DEFAULT_ENSEMBLE_MEMBERS)
    sd = net.state_dict()
    stats = [k for k in sd if k.endswith(("running_mean", "running_var", "num_batches_tracked"))]
    assert stats and all(torch.equal(sd[k], before[k]) for k in stats)
    for k in stats:  # the JAX step leaves them too
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(after[k], before[k]), k
    moved = [k for k in after if k not in stats and not torch.equal(after[k], before[k])]
    assert "weights" in moved and any(k.startswith("members_0.backbone") for k in moved)
    Z.assert_step_matches(jmet, tm, after, net)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_synthetic_imagefolder(tmp_path_factory.mktemp("ens_tree"), num_classes=Z.CLASSES,
                                       per_class=12, size=SIZE, seed=3)


def test_evaluate_ensemble_matches_jax(tree, tmp_path):
    """Member checkpoints (seeded JAX inits, carried over by ``from_jax``)
    combined by ``create_pretrained_ensemble`` in the port and by the
    member tree in JAX, as tests/test_e2e_parity.py builds it: identical
    predictions, equal accuracy, ROC-AUC within 1e-3, probabilities within
    1e-4; the same ensemble saved as one checkpoint evaluates the same."""
    params, stats = {}, {}
    names = {}
    for i, mt in enumerate(DEFAULT_ENSEMBLE_MEMBERS):
        jm = jax_get_model(mt, num_classes=Z.CLASSES)
        x = jnp.zeros((2, SIZE, SIZE, 3))
        kw = {"labels": jnp.zeros(2, jnp.int32)} if mt == "arcface" else {}
        mv = Z.np_tree(jax.jit(functools.partial(jm.init, train=False, **kw))(
            {"params": jax.random.key(20 + i), "dropout": jax.random.key(30 + i)}, x))
        mv["batch_stats"] = Z.random_stats(mv["batch_stats"], 40 + i)
        params[f"members_{i}"], stats[f"members_{i}"] = mv["params"], mv["batch_stats"]
        names[mt] = f"{mt}_m"
        save_checkpoint(tmp_path / "tck" / names[mt], "best", from_jax(mv, mt))
    jax_save_checkpoint(tmp_path / "jck" / "ens", "best", params, stats)
    kw = dict(model_type="ensemble", model_name="ens", batch_size=8, image_size=SIZE,
              compute_dtype="float32")
    ref = jax_evaluate_model(JaxEvalConfig(**kw), tree, checkpoints_root=tmp_path / "jck",
                             outputs_root=tmp_path / "jout", return_predictions=True)
    ens = create_pretrained_ensemble(names, Z.CLASSES, checkpoints_root=tmp_path / "tck")
    got = evaluate_model(EvalConfig(**kw), tree, outputs_root=tmp_path / "tout",
                         return_predictions=True, device="cpu", model=ens)
    p0, p1 = ref["_predictions"], got["_predictions"]
    np.testing.assert_array_equal(p1["y"], p0["y"])
    np.testing.assert_array_equal(p1["yhat"], p0["yhat"])
    np.testing.assert_allclose(p1["probs"], p0["probs"], atol=1e-4)
    assert got["accuracy"] == ref["accuracy"]
    assert abs(got["roc_auc"] - ref["roc_auc"]) < 1e-3
    assert set(got) == set(ref)
    save_checkpoint(tmp_path / "tck" / "ens", "best", ens.state_dict())
    again = evaluate_model(EvalConfig(**kw), tree, checkpoints_root=tmp_path / "tck",
                           outputs_root=tmp_path / "tout2", return_predictions=True, device="cpu")
    np.testing.assert_allclose(again["_predictions"]["probs"], p1["probs"], atol=1e-6)
