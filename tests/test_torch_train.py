"""Parity of the port's training path with the JAX package's on the CPU: the
margin logits and their gradients, the losses, train-mode BatchNorm (the
running statistics Flax keeps), the optax chain, one train step, three
steps of each trainer on the same batches, and the batchers and datasets
that feed them. The same seeded numpy inputs go to both sides; weights
carry over through ``facerec_torch.convert.from_jax``."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facerec_torch.config import OptimizerConfig
from facerec_torch.convert import _resnet18, from_jax
from facerec_torch.data.datasets import ClassificationBatcher, ImageFolderIndex
from facerec_torch.data.pipeline import InMemoryBatcher, prefetch_to_device
from facerec_torch.data.synthetic import make_synthetic_arrays, write_synthetic_imagefolder
from facerec_torch.eval.metrics import count_parameters
from facerec_torch.models import get_criterion, get_model
from facerec_torch.models.arcface import ArcFaceNet
from facerec_torch.models.losses import contrastive_loss, cross_entropy
from facerec_torch.models.resnet import ResNet18
from facerec_torch.ops.arcface import arc_margin_logits, cosine_logits
from facerec_torch.train.state import OptaxChain, TrainState, set_hyperparam
from facerec_torch.train.steps import _forward, make_train_step
from facerec_tpu.config import OptimizerConfig as JaxOptimizerConfig
from facerec_tpu.data import datasets as jax_datasets
from facerec_tpu.data import pipeline as jax_pipeline
from facerec_tpu.data import synthetic as jax_synthetic
from facerec_tpu.eval.metrics import count_parameters as jax_count_parameters
from facerec_tpu.models import get_criterion as jax_get_criterion
from facerec_tpu.models.arcface import ArcFaceNet as JaxArcFaceNet
from facerec_tpu.models.losses import contrastive_loss as jax_contrastive
from facerec_tpu.models.losses import cross_entropy as jax_cross_entropy
from facerec_tpu.models.resnet import ResNet18 as JaxResNet18
from facerec_tpu.ops import arcface as jax_arcface
from facerec_tpu.train import state as jax_state
from facerec_tpu.train import steps as jax_steps

ARC = dict(margin=0.3, scale=16.0, easy_margin=True, progressive_margin=True, warmup_epochs=5)
IMAGE = 32
BATCH = 8


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ---------------------------------------------------------------- margin logits

def _arc_inputs():
    rng = np.random.default_rng(11)
    emb = rng.normal(size=(6, 16)).astype(np.float32)
    w = rng.normal(size=(5, 16)).astype(np.float32)
    labels = rng.integers(0, 5, 6).astype(np.int32)
    probe = rng.normal(size=(6, 5)).astype(np.float32)  # weights of the summed loss
    return emb, w, labels, probe


@functools.cache
def _jax_margin_grad(kw):
    """Jitted value and gradients of sum(logits * probe), one compile for
    each set of static arguments (the epoch is traced)."""
    def loss(e, w, labels, probe, epoch):
        out, stats = jax_arcface.arc_margin_logits(e, w, labels, epoch, **dict(kw))
        return jnp.sum(out * probe), (out, stats)

    return jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))


@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("progressive", [True, False])
@pytest.mark.parametrize("margin", [0.3, 0.5])
@pytest.mark.parametrize("easy_margin", [True, False])
@pytest.mark.parametrize("epoch", [0.0, 2.5, 5.0, 12.0])
def test_arc_margin_logits_match_jax(epoch, easy_margin, margin, progressive, training):
    """Logits within 1e-5, their gradients with respect to the embeddings
    and the class centres within 1e-4, the stats equal (1e-6)."""
    emb, w, labels, probe = _arc_inputs()
    kw = dict(margin=margin, scale=32.0, easy_margin=easy_margin, progressive=progressive,
              warmup_epochs=5, training=training)
    (_, (ref, ref_stats)), (ge, gw) = _jax_margin_grad(tuple(sorted(kw.items())))(
        jnp.asarray(emb), jnp.asarray(w), jnp.asarray(labels), jnp.asarray(probe),
        jnp.asarray(epoch, jnp.float32))
    te = torch.tensor(emb, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    got, stats = arc_margin_logits(te, tw, torch.from_numpy(labels), epoch, **kw)
    (got * torch.from_numpy(probe)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=1e-5, rtol=0)
    np.testing.assert_allclose(te.grad.numpy(), np.asarray(ge), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(gw), atol=1e-4, rtol=1e-4)
    for name, a, b in zip(stats._fields, stats, ref_stats):
        np.testing.assert_allclose(float(a), float(b), atol=1e-6, rtol=1e-6, err_msg=name)


def test_cosine_logits_match_jax():
    emb, w, _, _ = _arc_inputs()
    ref = np.asarray(jax_arcface.cosine_logits(jnp.asarray(emb), jnp.asarray(w)))
    got = cosine_logits(torch.from_numpy(emb), torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


def test_progressive_margin_reaches_its_plateau():
    """The margin ramp ends at the warmup: factors 0.9 / 0.8 from epoch 5 on."""
    emb, w, labels, _ = _arc_inputs()
    for epoch, (mf, sf) in ((0.0, (0.0, 0.3)), (2.5, (0.25, 0.55)), (5.0, (0.9, 0.8))):
        _, stats = arc_margin_logits(torch.from_numpy(emb), torch.from_numpy(w),
                                     torch.from_numpy(labels), epoch, warmup_epochs=5)
        assert float(stats.margin_factor) == pytest.approx(mf)
        assert float(stats.scale_factor) == pytest.approx(sf)


# ---------------------------------------------------------------------- losses

@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("smoothing", [0.0, 0.05, 0.1])
def test_cross_entropy_matches_jax(smoothing, masked):
    rng = np.random.default_rng(1)
    logits = (rng.normal(size=(7, 6)) * 3).astype(np.float32)
    labels = rng.integers(0, 6, 7).astype(np.int32)
    mask = np.array([1, 1, 0, 1, 1, 0, 1], np.float32) if masked else None
    ref = float(jax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels), smoothing,
                                  None if mask is None else jnp.asarray(mask)))
    got = float(cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels), smoothing,
                              None if mask is None else torch.from_numpy(mask)))
    assert got == pytest.approx(ref, abs=1e-6, rel=1e-6)


@pytest.mark.parametrize("masked", [False, True])
def test_contrastive_loss_matches_jax(masked):
    rng = np.random.default_rng(2)
    a = rng.normal(size=(8, 12)).astype(np.float32)
    b = rng.normal(size=(8, 12)).astype(np.float32)
    b[:3] = a[:3] + 0.01 * rng.normal(size=(3, 12)).astype(np.float32)
    same = np.array([1, 1, 1, 0, 0, 0, 1, 0], np.int32)
    mask = np.array([1, 0, 1, 1, 1, 0, 1, 1], np.float32) if masked else None
    ref = float(jax_contrastive(jnp.asarray(a), jnp.asarray(b), jnp.asarray(same),
                                mask=None if mask is None else jnp.asarray(mask)))
    got = float(contrastive_loss(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(same),
                                 mask=None if mask is None else torch.from_numpy(mask)))
    assert got == pytest.approx(ref, abs=1e-6, rel=1e-6)


# ------------------------------------------------------------- train-mode BN

def _random_stats(stats, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32), _np(stats))


def _trunk_state(tree):
    """A bare JAX ResNet-18 tree as the port's trunk state dict (the arcface
    converter's backbone branch, without its prefix)."""
    out = {}
    _resnet18(tree["params"], tree["batch_stats"], out, "")
    return out


def _assert_stats_match(port_sd, ref, tol=1e-4):
    keys = [k for k in ref if k.endswith(("running_mean", "running_var"))]
    assert keys
    for k in keys:
        np.testing.assert_allclose(port_sd[k].numpy(), ref[k].numpy(), atol=tol, rtol=tol, err_msg=k)


def test_resnet18_train_forward_matches_jax():
    """Width 8, f32: the feature map and the updated running statistics
    (momentum 0.9, biased variance) within 1e-4."""
    net = JaxResNet18(width=8)
    x = np.random.default_rng(4).normal(size=(4, 64, 64, 3)).astype(np.float32)
    v = jax.jit(functools.partial(net.init, train=True))(jax.random.key(0), jnp.asarray(x))
    v = {"params": _np(v["params"]), "batch_stats": _random_stats(v["batch_stats"], 5)}
    ref, mutated = jax.jit(functools.partial(net.apply, train=True, mutable=["batch_stats"]))(
        v, jnp.asarray(x))
    port = ResNet18(8).train()
    port.load_state_dict(_trunk_state(v))
    got = port.features(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(), np.asarray(ref),
                               atol=1e-4, rtol=1e-4)
    _assert_stats_match(port.state_dict(), _trunk_state({"params": v["params"], **_np(mutated)}))


def test_stock_batchnorm_would_drift():
    """The reason for the port's BatchNorm: ``nn.BatchNorm2d`` updates the
    running variance with the unbiased batch variance, which differs from
    Flax's by n/(n-1)."""
    x = torch.from_numpy(np.random.default_rng(6).normal(size=(4, 3, 2, 2)).astype(np.float32))
    from facerec_torch.models.resnet import BatchNorm

    ours, stock = BatchNorm(3), torch.nn.BatchNorm2d(3, momentum=0.1)
    ours.train()(x)
    stock.train()(x)
    biased = x.var(dim=(0, 2, 3), unbiased=False)
    torch.testing.assert_close(ours.running_var, 0.9 + 0.1 * biased)
    assert not torch.allclose(stock.running_var, ours.running_var, atol=1e-4)


def test_batchnorm_follows_the_module_mode():
    """``model.train()`` normalises with the batch and moves the running
    statistics; ``model.eval()`` uses them and leaves them alone."""
    net = ArcFaceNet(num_classes=3, width=8, dropout_rate=0.0)
    x = torch.from_numpy(np.random.default_rng(10).normal(size=(4, 32, 32, 3)).astype(np.float32))
    before = net.backbone.bn1.running_var.clone()
    with torch.no_grad():
        net.eval()(x)
        assert torch.equal(net.backbone.bn1.running_var, before)
        net.train()(x, torch.tensor([0, 1, 2, 0]))
    assert not torch.equal(net.backbone.bn1.running_var, before)
    assert int(net.bn.num_batches_tracked) == 1


# ------------------------------------------------------- the ArcFace model

@pytest.fixture(scope="module")
def arc():
    """A full-width JAX ArcFaceNet (dropout 0, the arcface_synth margin
    settings), its variables with random BN statistics, the port's net
    carrying them, and the jitted JAX train step."""
    jnet = JaxArcFaceNet(num_classes=4, dropout_rate=0.0, **ARC)
    x = jnp.zeros((1, IMAGE, IMAGE, 3))
    v = jax.jit(functools.partial(jnet.init, train=True))(
        {"params": jax.random.key(1), "dropout": jax.random.key(2)}, x, jnp.zeros(1, jnp.int32))
    v = {"params": _np(v["params"]), "batch_stats": _random_stats(v["batch_stats"], 7)}
    jit_step = jax.jit(jax_steps.make_train_step(jnet, "arcface"))
    return jnet, v, jit_step


def _port_net(v):
    net = ArcFaceNet(num_classes=4, dropout_rate=0.0, **ARC)
    net.load_state_dict(from_jax(v, "arcface"))
    return net


def test_arcface_train_forward_matches_jax(arc):
    jnet, v, _ = arc
    rng = np.random.default_rng(8)
    x = rng.normal(size=(4, 64, 64, 3)).astype(np.float32)
    labels = np.array([0, 3, 1, 3], np.int32)
    ref, mutated = jax.jit(functools.partial(jnet.apply, train=True, mutable=["batch_stats"]))(
        v, jnp.asarray(x), jnp.asarray(labels), 2.5)
    net = _port_net(v).train()
    got = net(torch.from_numpy(x), torch.from_numpy(labels), epoch=2.5)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)
    _assert_stats_match(net.state_dict(), from_jax({"params": v["params"], **_np(mutated)}, "arcface"))
    # eval with labels, on the updated statistics: cosine logits
    net.eval()
    ref_cos = jnet.apply({"params": v["params"], **mutated}, jnp.asarray(x),
                         labels=jnp.asarray(labels))
    with torch.no_grad():
        np.testing.assert_allclose(net(torch.from_numpy(x), torch.from_numpy(labels)).numpy(),
                                   np.asarray(ref_cos), atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(net.eval_logits(torch.from_numpy(x)).numpy(),
                                   np.asarray(ref_cos), atol=1e-4, rtol=1e-4)


def test_arc_weight_init_matches_jax_variance_scaling():
    """The class centres start as JAX's ``variance_scaling(2.0, "fan_avg",
    "truncated_normal")``: the same spread and the same truncation."""
    from facerec_torch.models.arcface import init_like_flax

    net = ArcFaceNet(num_classes=512, width=8)
    init_like_flax(net, torch.Generator().manual_seed(0))
    got = net.arc_weight.detach().numpy()
    init = jax.nn.initializers.variance_scaling(2.0, "fan_avg", "truncated_normal")
    ref = np.asarray(init(jax.random.key(0), (512, 512), jnp.float32))
    std = np.sqrt(2.0 / 512)
    assert got.std() == pytest.approx(ref.std(), rel=0.01) and ref.std() == pytest.approx(std, rel=0.01)
    bound = 2 * std / 0.87962566103423978
    assert np.abs(got).max() <= bound and np.abs(ref).max() <= bound * (1 + 1e-6)
    assert np.abs(got).max() > 0.99 * bound


def test_count_parameters_matches_jax(arc):
    _, v, _ = arc
    assert count_parameters(_port_net(v)) == jax_count_parameters(v["params"])
    assert set(count_parameters(_port_net(v))["by_module"]) == {"backbone", "embedding", "bn",
                                                                "arc_weight"}


def test_from_jax_covers_the_training_trees(arc):
    _, v, _ = arc
    assert set(from_jax(v, "arcface")) == set(_port_net(v).state_dict())
    from facerec_tpu.models.baseline import BaselineNet as JaxBaselineNet

    jb = JaxBaselineNet(num_classes=4)
    bv = jax.jit(jb.init)({"params": jax.random.key(0)}, jnp.zeros((1, IMAGE, IMAGE, 3)))
    port = get_model("baseline", num_classes=4).eval()
    assert set(from_jax(_np(bv), "baseline")) == set(port.state_dict())
    port.load_state_dict(from_jax(_np(bv), "baseline"))
    x = np.random.default_rng(9).normal(size=(3, IMAGE, IMAGE, 3)).astype(np.float32)
    ref = jax.jit(jb.apply)(bv, jnp.asarray(x))
    with torch.no_grad():
        np.testing.assert_allclose(port(torch.from_numpy(x)).numpy(), np.asarray(ref),
                                   atol=1e-4, rtol=1e-4)


# ------------------------------------------------------------------ optimizer

OPTIMIZERS = {
    "adam": dict(name="adam"),
    "adamw": dict(name="adamw"),
    "adamw_amsgrad": dict(name="adamw", amsgrad=True),
    "radam": dict(name="radam"),
    "sgd": dict(name="sgd", momentum=0.9),
}
# (learning_rate, max_norm, backbone_scale) before each of the 8 steps
SCHEDULE = [(1e-2, 1.0, 0.0), (1e-2, 10.0, 0.0), (5e-3, 0.5, 0.0), (5e-3, 10.0, 1.0),
            (2e-3, 1.0, 1.0), (2e-3, 0.3, 1.0), (1e-3, 10.0, 1.0), (1e-3, 1.0, 1.0)]


def _find(state, field):
    """The first ``field`` of a namedtuple inside an optax state."""
    if hasattr(state, "_fields"):
        if field in state._fields:
            return getattr(state, field)
        state = tuple(state)
    if isinstance(state, tuple):
        for s in state:
            found = _find(s, field)
            if found is not None:
                return found
    return None


@pytest.mark.parametrize("opt", list(OPTIMIZERS))
def test_optimizer_matches_optax_chain(opt):
    """8 steps of the same numpy gradients through the optax chain and the
    port's: LR and clip changed between steps, the backbone frozen for 3
    steps, norms over and under the clip. Parameters and moments within
    1e-6."""
    rng = np.random.default_rng(3)
    shapes = {"backbone": {"w": (3, 4)}, "head": {"b": (2,), "w": (4, 2)}}
    params = jax.tree_util.tree_map(lambda s: rng.normal(size=s).astype(np.float32), shapes,
                                    is_leaf=lambda s: isinstance(s, tuple))
    grads = [jax.tree_util.tree_map(lambda p: (rng.normal(size=p.shape) * 0.5).astype(np.float32),
                                    params) for _ in SCHEDULE]
    kw = dict(OPTIMIZERS[opt], learning_rate=1e-2, weight_decay=1e-2)
    tx = jax_state.make_optimizer(JaxOptimizerConfig(**kw))
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jopt = tx.init(jparams)
    flat = {"backbone.w": params["backbone"]["w"], "head.b": params["head"]["b"],
            "head.w": params["head"]["w"]}
    tparams = {k: torch.from_numpy(v.copy()) for k, v in flat.items()}
    topt = OptaxChain(tparams.items(), OptimizerConfig(**kw))
    clipped = []
    for (lr, max_norm, scale), g in zip(SCHEDULE, grads):
        for name, value in (("learning_rate", lr), ("max_norm", max_norm),
                            ("backbone_scale", scale)):
            jax_state.set_hyperparam(jopt, name, value)
            set_hyperparam(topt, name, value)
        norm = np.sqrt(sum(float(np.sum(x ** 2)) * (scale if k == "backbone" else 1.0)
                           for k, t in g.items() for x in t.values()))
        clipped.append(norm >= max_norm)
        updates, jopt = tx.update(jax.tree_util.tree_map(jnp.asarray, g), jopt, jparams)
        jparams = jax.tree_util.tree_map(lambda p, u: p + u, jparams, updates)
        topt.step([torch.from_numpy(g["backbone"]["w"].copy()), torch.from_numpy(g["head"]["b"].copy()),
                   torch.from_numpy(g["head"]["w"].copy())])
        for k, t in tparams.items():
            a, b = k.split(".")
            np.testing.assert_allclose(t.numpy(), np.asarray(jparams[a][b]), atol=1e-6, rtol=0,
                                       err_msg=f"{opt} {k}")
        for slot in topt.slots:
            ref = _find(jopt.inner_state, slot)
            for k, t in topt.state_dict()["slots"][slot].items():
                a, b = k.split(".")
                np.testing.assert_allclose(t.numpy(), np.asarray(ref[a][b]), atol=1e-6, rtol=0,
                                           err_msg=f"{opt} {slot} {k}")
    assert any(clipped) and not all(clipped)
    if opt != "sgd":
        assert topt.count == int(_find(jopt.inner_state, "count")) == len(SCHEDULE)


def test_optimizer_state_round_trips():
    p = {"backbone.w": torch.ones(3), "head.w": torch.ones(2)}
    opt = OptaxChain(p.items(), OptimizerConfig(name="adamw", amsgrad=True))
    opt.step([torch.full((3,), 0.5), torch.full((2,), -0.25)])
    set_hyperparam(opt, "backbone_scale", 0.0)
    q = {k: torch.ones_like(v) for k, v in p.items()}
    other = OptaxChain(q.items(), OptimizerConfig(name="adamw", amsgrad=True))
    other.load_state_dict(opt.state_dict())
    assert other.count == 1 and other.hyperparams == opt.hyperparams
    for s in opt.slots:
        for a, b in zip(opt.slots[s], other.slots[s]):
            assert torch.equal(a, b)
    with pytest.raises(ValueError):
        OptaxChain(p.items(), OptimizerConfig(name="lamb"))


def test_hyperparameters_and_count_stay_in_place():
    """The injected hyperparameters and the step count are device tensors
    written in place: ``set_hyperparam``, a step and ``load_state_dict``
    leave each at its storage (a captured step reads them there), with the
    f32 value set; ``hyperparams`` is read-only."""
    p = {"backbone.w": torch.ones(3), "head.w": torch.ones(2)}
    opt = OptaxChain(p.items(), OptimizerConfig(name="radam"))
    ptrs = {k: t.data_ptr() for k, t in opt.hp_tensors.items()} | {
        "count": opt.count_tensor.data_ptr()}
    for name, value in (("learning_rate", 0.1), ("max_norm", 0.7), ("backbone_scale", 0.0)):
        set_hyperparam(opt, name, value)
        assert opt.hyperparams[name] == value
        assert opt.hp_tensors[name].item() == np.float32(value)
    for _ in range(6):  # past RAdam's threshold (ro >= 5 from step 6 at b2 0.999)
        opt.step([torch.full((3,), 0.5), torch.full((2,), -0.25)])
    opt.load_state_dict(opt.state_dict())
    assert opt.count == 6 and opt.count_tensor.dtype == torch.int32
    assert ptrs == {k: t.data_ptr() for k, t in opt.hp_tensors.items()} | {
        "count": opt.count_tensor.data_ptr()}
    with pytest.raises(TypeError):
        opt.hyperparams["learning_rate"] = 1.0
    with pytest.raises(KeyError):
        set_hyperparam(opt, "momentum", 0.9)


def test_state_dict_keeps_its_format(tmp_path):
    """``state_dict`` holds the count as an int and the hyperparameters as
    the floats set, as checkpoints of either trainer hold them, and a dict in
    that format loads into the device tensors (through ``torch.save``)."""
    p = {"backbone.w": torch.ones(3), "head.w": torch.ones(2)}
    old = {"count": 7, "hyperparams": {"learning_rate": 3e-4, "max_norm": 0.3,
                                       "backbone_scale": 0.0},
           "slots": {s: {"backbone.w": torch.full((3,), 0.25), "head.w": torch.full((2,), 2.0)}
                     for s in ("mu", "nu", "nu_max")}}
    torch.save(old, tmp_path / "opt.pt")
    opt = OptaxChain(p.items(), OptimizerConfig(name="adamw", amsgrad=True))
    opt.load_state_dict(torch.load(tmp_path / "opt.pt"))
    d = opt.state_dict()
    assert type(d["count"]) is int and d["count"] == 7
    assert d["hyperparams"] == old["hyperparams"]
    assert all(type(v) is float for v in d["hyperparams"].values())
    assert {k: t.item() for k, t in opt.hp_tensors.items()} == {
        k: float(np.float32(v)) for k, v in old["hyperparams"].items()}
    for s, slot in old["slots"].items():
        for k, t in slot.items():
            assert torch.equal(d["slots"][s][k], t)


def test_train_state_epoch_generator_and_copy():
    """``epoch`` is a host float held in a device tensor filled in place;
    ``dropout_generator`` draws what a fresh generator seeded from (seed,
    step) draws; a deep copy has its own model, an optimizer over the
    copy's parameters, and its own generator and epoch tensor."""
    import copy

    net = torch.nn.Linear(3, 2)
    state = TrainState(net, OptaxChain(net.named_parameters(), OptimizerConfig()), seed=5,
                       step=4, epoch=1.0)
    ptr = state.epoch_tensor.data_ptr()
    state.epoch = 3
    assert state.epoch == 3.0 and state.epoch_tensor.item() == 3.0
    assert state.epoch_tensor.data_ptr() == ptr
    fresh = torch.Generator().manual_seed(5 * 1_000_003 + 4)
    for _ in range(2):  # reseeded each time
        assert torch.equal(torch.rand(4, generator=state.dropout_generator()),
                           torch.rand(4, generator=fresh.manual_seed(5 * 1_000_003 + 4)))
    twin = copy.deepcopy(state)
    assert twin.model is not net and twin.opt_state.params == list(twin.model.parameters())
    assert all(a is not b for a, b in zip(twin.opt_state.params, state.opt_state.params))
    assert twin.generator is not state.generator and twin.epoch_tensor is not state.epoch_tensor
    assert (twin.seed, twin.step, twin.epoch) == (5, 4, 3.0)


# --------------------------------------------------------------- train steps

@pytest.fixture(scope="module")
def batches(synthetic_imagefolder):
    """The first batches of epoch 0 from both packages' batchers."""
    root = synthetic_imagefolder / "train"
    jb = jax_datasets.ClassificationBatcher(jax_datasets.ImageFolderIndex.build(root), BATCH, IMAGE,
                                            shuffle=True, seed=0)
    tb = ClassificationBatcher(ImageFolderIndex.build(root), BATCH, IMAGE, shuffle=True, seed=0)
    return list(jb.epoch(0)), list(tb.epoch(0))


def _jax_state(jnet, v, opt):
    tx = jax_state.make_optimizer(JaxOptimizerConfig(**opt), "arcface")
    return jax_state.TrainState(step=jnp.zeros((), jnp.int32), epoch=jnp.asarray(2.0, jnp.float32),
                                params=v["params"], batch_stats=v["batch_stats"],
                                opt_state=tx.init(v["params"]), rng=jax.random.key(0), tx=tx)


def _port_state(v, opt):
    net = _port_net(v)
    chain = OptaxChain(net.named_parameters(), OptimizerConfig(**opt), "arcface")
    return TrainState(model=net, opt_state=chain, seed=0, epoch=2.0)


def _port_loss(net, batch):
    out = _forward(net.train(), "arcface", batch, 2.0)
    return get_criterion("arcface")(out, batch, batch["mask"])


def _rel_close(got, ref, tol, name):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol * max(np.abs(ref).max(), 1e-12),
                               err_msg=name)


SGD = dict(name="sgd", momentum=0.9, learning_rate=0.05)


def test_one_train_step_matches_jax(arc, batches):
    """One arcface step, f32, dropout 0, from the same parameters on the
    same batch: loss, grad_norm and every gradient within 1e-4 relative;
    the new BN statistics within 1e-4; the parameters after the SGD step
    (clipped at 0.3) within 1e-5."""
    jnet, v, jit_step = arc
    jb, tb = batches
    jbatch = jax.tree_util.tree_map(jnp.asarray, jb[0])
    tbatch = {k: torch.from_numpy(x) for k, x in tb[0].items()}

    # gradients, through each package's forward and criterion
    def jax_loss(params):
        out, _ = jax_steps._forward(jnet, "arcface", params, v["batch_stats"], jbatch, True,
                                    jnp.asarray(2.0), jax.random.key(0))
        return jax_get_criterion("arcface")(out, jbatch, jbatch["mask"])

    jgrads = jax.jit(jax.grad(jax_loss))(jax.tree_util.tree_map(jnp.asarray, v["params"]))
    ref_grads = from_jax({"params": _np(jgrads), "batch_stats": v["batch_stats"]}, "arcface")
    net = _port_net(v)
    loss = _port_loss(net, tbatch)
    names, params = zip(*net.named_parameters())
    tgrads = torch.autograd.grad(loss, params)
    for name, g in zip(names, tgrads):
        _rel_close(g.numpy(), ref_grads[name].numpy(), 1e-4, name)

    new_jstate, jm = jit_step(_jax_state(jnet, v, SGD), jbatch)
    state = _port_state(v, SGD)
    tm = make_train_step("arcface")(state, tbatch)
    _rel_close(float(tm["loss_sum"]) / float(tm["count"]),
               float(jm["loss_sum"]) / float(jm["count"]), 1e-4, "loss")
    _rel_close(float(tm["grad_norm"]), float(jm["grad_norm"]), 1e-4, "grad_norm")
    assert float(tm["correct"]) == float(jm["correct"]) and float(tm["count"]) == BATCH
    after = from_jax({"params": _np(new_jstate.params), "batch_stats": _np(new_jstate.batch_stats)},
                     "arcface")
    sd = state.model.state_dict()
    for k, ref in after.items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(sd[k].numpy(), ref.numpy(), atol=1e-4, rtol=1e-4, err_msg=k)
        elif not k.endswith("num_batches_tracked"):
            np.testing.assert_allclose(sd[k].numpy(), ref.numpy(), atol=1e-5, rtol=0, err_msg=k)
    assert state.step == int(new_jstate.step) == 1


# Measured on the CPU with these inputs: the three losses agree within
# 6.3e-7 relative (2.4e-7, 6.3e-7, 3.3e-7); the bound leaves 16x room.
TRAJECTORY_RTOL = 1e-5


def test_three_steps_of_each_trainer_agree(arc, batches):
    """The slice as a whole: three arcface SGD steps of each trainer from the
    JAX initial state on the same batcher batches; the loss trajectory
    within ``TRAJECTORY_RTOL`` and the parameters after it within 1e-4."""
    jnet, v, jit_step = arc
    jb, tb = batches
    jstate, state = _jax_state(jnet, v, SGD), _port_state(v, SGD)
    step = make_train_step("arcface")
    for i in range(3):
        jstate, jm = jit_step(jstate, jax.tree_util.tree_map(jnp.asarray, jb[i]))
        tm = step(state, {k: torch.from_numpy(x) for k, x in tb[i].items()})
        ref = float(jm["loss_sum"]) / float(jm["count"])
        got = float(tm["loss_sum"]) / float(tm["count"])
        assert got == pytest.approx(ref, rel=TRAJECTORY_RTOL), (i, got, ref)
    after = from_jax({"params": _np(jstate.params), "batch_stats": _np(jstate.batch_stats)}, "arcface")
    sd = state.model.state_dict()
    for k, ref in after.items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_allclose(sd[k].numpy(), ref.numpy(), atol=1e-4, rtol=1e-4, err_msg=k)


# ------------------------------------------------------------- data and batchers

@pytest.mark.parametrize("epoch", [0, 1])
def test_classification_batches_equal_jax(synthetic_imagefolder, epoch):
    for split, shuffle in (("train", True), ("val", False)):
        root = synthetic_imagefolder / split
        jb = jax_datasets.ClassificationBatcher(jax_datasets.ImageFolderIndex.build(root), 5, 24,
                                                shuffle=shuffle, seed=3)
        tb = ClassificationBatcher(ImageFolderIndex.build(root), 5, 24, shuffle=shuffle, seed=3)
        got, ref = list(tb.epoch(epoch)), list(jb.epoch(epoch))
        assert len(got) == len(ref) == len(tb)
        assert got[-1]["mask"].sum() < 5  # a padded, masked final batch
        for a, b in zip(got, ref):
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def test_in_memory_batches_equal_jax():
    imgs, labels = make_synthetic_arrays(num_classes=3, per_class=5, size=16, seed=2)
    arrays = {"image": imgs, "label": labels}
    for epoch in (0, 1):
        got = list(InMemoryBatcher(arrays, 4, seed=9).epoch(epoch))
        ref = list(jax_pipeline.InMemoryBatcher(arrays, 4, seed=9).epoch(epoch))
        assert len(got) == len(ref) == 4
        for a, b in zip(got, ref):
            assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("skin", [(0.25, 1.0), None])
def test_synthetic_arrays_equal_jax(skin):
    got = make_synthetic_arrays(num_classes=3, per_class=4, size=32, seed=5, skin_lum_range=skin)
    ref = jax_synthetic.make_synthetic_arrays(num_classes=3, per_class=4, size=32, seed=5,
                                              skin_lum_range=skin)
    assert all(np.array_equal(a, b) and a.dtype == b.dtype for a, b in zip(got, ref))


def test_synthetic_imagefolder_equals_jax(tmp_path):
    a = write_synthetic_imagefolder(tmp_path / "a", num_classes=2, per_class=7, size=24, seed=4)
    b = jax_synthetic.write_synthetic_imagefolder(tmp_path / "b", num_classes=2, per_class=7,
                                                  size=24, seed=4)
    files = sorted(p.relative_to(a) for p in a.rglob("*.jpg"))
    assert files == sorted(p.relative_to(b) for p in b.rglob("*.jpg")) and len(files) == 14
    assert all((a / f).read_bytes() == (b / f).read_bytes() for f in files)


def test_prefetch_to_device_on_the_cpu():
    arrays = {"image": np.arange(40, dtype=np.float32).reshape(10, 4), "label": np.arange(10)}
    got = list(prefetch_to_device(InMemoryBatcher(arrays, 3, shuffle=False).epoch(0), "cpu"))
    assert [int(b["mask"].sum()) for b in got] == [3, 3, 3, 1]
    assert torch.equal(got[1]["image"], torch.from_numpy(arrays["image"][3:6]))

    def failing():
        yield {"x": np.zeros(2)}
        raise OSError("unreadable image")

    with pytest.raises(OSError, match="unreadable"):
        list(prefetch_to_device(failing(), "cpu"))
    # a consumer that stops early leaves no thread behind
    it = prefetch_to_device(InMemoryBatcher(arrays, 1, shuffle=False).epoch(0), "cpu", depth=1)
    next(it)
    it.close()
