"""Parity helpers for the model-zoo tests (``tests/test_torch_models.py``,
``test_torch_hybrid.py``, ``test_torch_siamese.py``,
``test_torch_ensemble.py``): the JAX model of each type with its dropout
off (test-local subclasses for the rates the JAX models hard-code, with the
same parameter names), its variables with random BatchNorm statistics, the
port's model carrying them, and one train step of each package."""

from __future__ import annotations

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import torch

from facerec_torch.config import OptimizerConfig
from facerec_torch.convert import from_jax
from facerec_torch.models.attention import AttentionNet
from facerec_torch.models.hybrid import HybridNet
from facerec_torch.models.siamese import SiameseNet
from facerec_torch.models.transfer import ResNetTransfer
from facerec_torch.train.state import OptaxChain, TrainState
from facerec_torch.train.steps import make_train_step
from facerec_tpu.config import OptimizerConfig as JaxOptimizerConfig
from facerec_tpu.models.attention import AttentionNet as JaxAttentionNet
from facerec_tpu.models.hybrid import HybridNet as JaxHybridNet
from facerec_tpu.models.hybrid import TransformerBlock as JaxTransformerBlock
from facerec_tpu.models.resnet import ResNet18 as JaxResNet18
from facerec_tpu.models.siamese import SiameseNet as JaxSiameseNet
from facerec_tpu.models.transfer import ResNetTransfer as JaxResNetTransfer
from facerec_tpu.train import state as jax_state
from facerec_tpu.train import steps as jax_steps

CLASSES = 5
SGD = dict(name="sgd", momentum=0.9, learning_rate=0.05)


class JaxHybridNoDropout(JaxHybridNet):
    """JAX's HybridNet with the transformer block's dropout (0.1 in the JAX
    model whatever ``dropout_rate`` says) at 0."""

    def setup(self):
        kw = dict(dtype=self.dtype, param_dtype=self.param_dtype)
        self.backbone = JaxResNet18(name="backbone", **kw)
        self.pos_encoding = self.param("pos_encoding", fnn.initializers.normal(0.02),
                                       (self.seq_len, self.fdim), self.param_dtype)
        self.transformer = JaxTransformerBlock(self.fdim, dropout=0.0, name="transformer", **kw)
        self.norm = fnn.LayerNorm(name="norm", **kw)
        self.dropout = fnn.Dropout(self.dropout_rate)
        self.fc = fnn.Dense(self.num_classes, name="fc", **kw)


class JaxSiameseNoDropout(JaxSiameseNet):
    """JAX's SiameseNet with its two dropouts (0.3, 0.2, hard-coded) at 0."""

    def setup(self):
        kw = dict(dtype=self.dtype, param_dtype=self.param_dtype)
        self.conv_specs = ((64, 7, 2), (128, 3, 1), (128, 3, 1), (256, 3, 1), (256, 3, 1),
                           (512, 3, 1))
        self.convs = [fnn.Conv(ch, (k, k), strides=s, padding=k // 2, name=f"conv{i}", **kw)
                      for i, (ch, k, s) in enumerate(self.conv_specs)]
        self.conv_bns = [fnn.BatchNorm(momentum=0.9, epsilon=1e-5, name=f"conv_bn{i}", **kw)
                         for i in range(6)]
        self.fc1 = fnn.Dense(1024, name="fc1", **kw)
        self.fc_bn1 = fnn.BatchNorm(momentum=0.9, epsilon=1e-5, name="fc_bn1", **kw)
        self.fc2 = fnn.Dense(512, name="fc2", **kw)
        self.fc_bn2 = fnn.BatchNorm(momentum=0.9, epsilon=1e-5, name="fc_bn2", **kw)
        self.fc3 = fnn.Dense(self.embedding_dim, name="fc3", **kw)
        self.drop1 = fnn.Dropout(0.0)
        self.drop2 = fnn.Dropout(0.0)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def random_stats(stats, seed: int):
    """Running means in [-0.2, 0.2] and variances in [0.5, 1.5]: the eval
    forward then keeps most activations alive through each ReLU."""
    rng = np.random.default_rng(seed)

    def draw(path, a):
        lo, hi = (-0.2, 0.2) if path[-1].key == "mean" else (0.5, 1.5)
        return rng.uniform(lo, hi, a.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, np_tree(stats))


def jax_model(model_type: str):
    """The JAX model of ``model_type`` at full width, dropout off."""
    return {"cnn": lambda: JaxResNetTransfer(num_classes=CLASSES, dropout_rate=0.0),
            "attention": lambda: JaxAttentionNet(num_classes=CLASSES),
            "hybrid": lambda: JaxHybridNoDropout(num_classes=CLASSES, dropout_rate=0.0),
            "siamese": JaxSiameseNoDropout}[model_type]()


def port_model(model_type: str, variables) -> torch.nn.Module:
    """The port's model of ``model_type``, dropout off, carrying
    ``variables``."""
    if model_type == "cnn":
        net = ResNetTransfer(num_classes=CLASSES, dropout_rate=0.0)
    elif model_type == "attention":
        net = AttentionNet(num_classes=CLASSES)
    elif model_type == "hybrid":
        net = HybridNet(num_classes=CLASSES, dropout_rate=0.0)
        net.transformer.set_dropout(0.0)
    else:
        net = SiameseNet()
        net.dropout_rates = (0.0, 0.0)
    net.load_state_dict(from_jax(variables, model_type))
    return net


def jax_variables(model_type: str, size: int = 64, seed: int = 1):
    """A JAX init at ``size`` px with random BatchNorm statistics, and the
    attention residual ``gamma`` at 0.5 so that the attention branch counts."""
    jm = jax_model(model_type)
    x = jnp.zeros((2, size, size, 3))
    args = (x, x) if model_type == "siamese" else (x,)
    v = jax.jit(functools.partial(jm.init, train=False))(
        {"params": jax.random.key(seed), "dropout": jax.random.key(seed + 1)}, *args)
    v = {"params": np_tree(v["params"]), "batch_stats": random_stats(v["batch_stats"], seed + 6)}
    if model_type == "attention":
        v["params"]["attention"]["gamma"] = np.array([0.5], np.float32)
    return jm, v


def batch(model_type: str, n: int = 4, size: int = 64, seed: int = 0) -> dict:
    """A seeded numpy batch with its last example masked out: images and
    labels, or image pairs with pair labels for siamese."""
    rng = np.random.default_rng(seed)
    img = lambda: rng.normal(size=(n, size, size, 3)).astype(np.float32)  # noqa: E731
    mask = np.ones(n, np.float32)
    mask[-1] = 0.0
    if model_type == "siamese":
        return {"image_a": img(), "image_b": img(),
                "pair_label": (np.arange(n) % 2).astype(np.int32), "mask": mask}
    return {"image": img(), "label": rng.integers(0, CLASSES, n).astype(np.int32), "mask": mask}


def face_batch(model_type: str, root, n: int = 8, size: int = 64) -> dict:
    """The first batch of epoch 0 of the port's batcher over ``root``'s
    train split (synthetic faces, ImageNet-normalised): the train-step
    tests' input, as in ``tests/test_torch_train.py``. Noise images make
    the trunk's last BatchNorms ill-conditioned (a few weights then differ
    by 17% of their update, on both sides' rounding alone); faces do not."""
    from facerec_torch.data.datasets import ClassificationBatcher, ImageFolderIndex, SiamesePairBatcher

    index = ImageFolderIndex.build(root / "train")
    if model_type == "siamese":
        batcher = SiamesePairBatcher(index, n, size, seed=0)
    else:
        batcher = ClassificationBatcher(index, n, size, shuffle=True, seed=0)
    return next(iter(batcher.epoch(0)))


def jax_train_state(v, model_type: str, opt=SGD):
    tx = jax_state.make_optimizer(JaxOptimizerConfig(**opt), model_type)
    params = jax.tree_util.tree_map(jnp.asarray, v["params"])
    return jax_state.TrainState(step=jnp.zeros((), jnp.int32), epoch=jnp.zeros((), jnp.float32),
                                params=params, batch_stats=v["batch_stats"],
                                opt_state=tx.init(params), rng=jax.random.key(0), tx=tx)


def port_train_state(net: torch.nn.Module, model_type: str, opt=SGD) -> TrainState:
    return TrainState(model=net, opt_state=OptaxChain(net.named_parameters(),
                                                      OptimizerConfig(**opt), model_type), seed=0)


def rel_close(got, ref, tol: float, name: str) -> None:
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol * max(np.abs(ref).max(), 1e-12),
                               err_msg=name)


def one_step_each(jm, v, net, model_type: str, b: dict, member_types=None):
    """One SGD step of each package's train step from the same weights on
    the same batch. Returns (JAX metrics, JAX state after, port metrics,
    port state dict after as the JAX tree converted)."""
    jit_step = jax.jit(jax_steps.make_train_step(jm, model_type))
    new_jstate, jm_metrics = jit_step(jax_train_state(v, model_type),
                                      jax.tree_util.tree_map(jnp.asarray, b))
    state = port_train_state(net, model_type)
    tm = make_train_step(model_type)(state, {k: torch.from_numpy(x) for k, x in b.items()})
    after = from_jax({"params": np_tree(new_jstate.params),
                      "batch_stats": np_tree(new_jstate.batch_stats)}, model_type,
                     member_types=member_types)
    return jm_metrics, new_jstate, tm, after


def assert_step_matches(jm_metrics, tm, after, net, param_atol: float = 1e-5) -> None:
    """Loss and grad_norm within 1e-4 relative, the same correct count, the
    parameters after the step within ``param_atol`` and the BatchNorm
    statistics within 1e-4."""
    rel_close(float(tm["loss_sum"]) / float(tm["count"]),
              float(jm_metrics["loss_sum"]) / float(jm_metrics["count"]), 1e-4, "loss")
    rel_close(float(tm["grad_norm"]), float(jm_metrics["grad_norm"]), 1e-4, "grad_norm")
    for k in jm_metrics:
        if k.endswith(("correct", "count")):
            assert float(tm[k]) == float(jm_metrics[k]), k
    sd = net.state_dict()
    for k, ref in after.items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(sd[k].numpy(), ref.numpy(), atol=1e-4, rtol=1e-4, err_msg=k)
        elif not k.endswith("num_batches_tracked"):
            np.testing.assert_allclose(sd[k].numpy(), ref.numpy(), atol=param_atol, rtol=0,
                                       err_msg=k)
