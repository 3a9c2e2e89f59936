"""Helpers for the FaceNet tests (``tests/test_torch_facenet.py``,
``test_torch_fold.py``): JAX's InceptionResnetV1 with its last Block8 at
facenet-pytorch's scale 1.0, seeded JAX variables with non-trivial
BatchNorm statistics made without compiling ``init``, and the
facenet-pytorch replica of ``tools/torch_replicas.py`` with the same repair.

The JAX package builds ``Block8(no_relu=True, name="block8")`` at the
default scale 0.20; facenet-pytorch builds ``Block8(noReLU=True)`` at its
default 1.0 (ROADMAP section 3). The port follows facenet-pytorch, so the
JAX side of a parity test is this subclass; ``test_torch_facenet.py`` also
shows that the unmodified JAX net differs.
"""

from __future__ import annotations

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
from flax import linen as fnn

from facerec_tpu.models.facenet import (Block8, Block17, Block35, BasicConv2d, InceptionResnetV1,
                                        Mixed6a, Mixed7a)

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))


class JaxFaceNetPublished(InceptionResnetV1):
    """JAX's InceptionResnetV1, the same parameter names, with ``block8``
    at scale 1.0."""

    def setup(self):
        base = dict(dtype=self.dtype, param_dtype=self.param_dtype)
        kw = dict(folded=self.folded, **base)
        self.conv2d_1a = BasicConv2d(32, (3, 3), strides=2, name="conv2d_1a", **kw)
        self.conv2d_2a = BasicConv2d(32, (3, 3), name="conv2d_2a", **kw)
        self.conv2d_2b = BasicConv2d(64, (3, 3), padding=1, name="conv2d_2b", **kw)
        self.conv2d_3b = BasicConv2d(80, (1, 1), name="conv2d_3b", **kw)
        self.conv2d_4a = BasicConv2d(192, (3, 3), name="conv2d_4a", **kw)
        self.conv2d_4b = BasicConv2d(256, (3, 3), strides=2, name="conv2d_4b", **kw)
        self.repeat_1 = [Block35(name=f"repeat_1_{i}", **kw) for i in range(self.repeats[0])]
        self.mixed_6a = Mixed6a(name="mixed_6a", **kw)
        self.repeat_2 = [Block17(name=f"repeat_2_{i}", **kw) for i in range(self.repeats[1])]
        self.mixed_7a = Mixed7a(name="mixed_7a", **kw)
        self.repeat_3 = [Block8(name=f"repeat_3_{i}", **kw) for i in range(self.repeats[2])]
        self.block8 = Block8(scale=1.0, no_relu=True, name="block8", **kw)
        self.dropout = fnn.Dropout(self.dropout_rate)
        self.last_linear = fnn.Dense(512, use_bias=False, name="last_linear", **base)
        if self.folded:
            from facerec_tpu.models.fold import FoldedBias

            self.last_bn = FoldedBias(512, name="last_bn", **base)
        else:
            self.last_bn = fnn.BatchNorm(momentum=0.9, epsilon=1e-3, name="last_bn", **base)
        if self.num_classes > 0:
            self.classify = fnn.Dense(self.num_classes, name="logits", **base)


def seeded_variables(repeats, seed: int, size: int = 160) -> dict:
    """``{"params", "batch_stats"}`` of numpy arrays for JAX's
    InceptionResnetV1 at ``repeats``: shapes from ``jax.eval_shape`` (the
    full-width ``init`` takes seconds to compile on the CPU), kernels
    LeCun-normal, conv biases normal(0, 0.05), BatchNorm scale U(0.5, 1.5),
    bias N(0, 0.3), mean N(0, 0.5), var U(0.3, 2.0), as tests/test_fold.py
    randomises them."""
    net = InceptionResnetV1(repeats=repeats)
    shapes = jax.eval_shape(net.init, jax.random.key(0), jnp.zeros((1, size, size, 3)))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name, parent = path[-1].key, path[-2].key if len(path) > 1 else ""
        shape = leaf.shape
        if name == "kernel":
            v = rng.normal(0.0, np.prod(shape[:-1]) ** -0.5, shape)
        elif name == "scale":
            v = rng.uniform(0.5, 1.5, shape)
        elif name == "mean":
            v = rng.normal(0.0, 0.5, shape)
        elif name == "var":
            v = rng.uniform(0.3, 2.0, shape)
        elif name == "bias":
            v = rng.normal(0.0, 0.3 if parent.endswith("bn") else 0.05, shape)
        else:
            raise KeyError(name)
        return v.astype(np.float32)

    tree = jax.tree_util.tree_map_with_path(fill, shapes)
    return {"params": tree["params"], "batch_stats": tree["batch_stats"]}


def facenet_pytorch_replica(repeats):
    """``tools/torch_replicas.TorchInceptionResnetV1`` (facenet-pytorch's
    names) with its last Block8 at facenet-pytorch's scale 1.0."""
    from torch_replicas import TorchInceptionResnetV1

    tm = TorchInceptionResnetV1(repeats=repeats)
    tm.block8.scale = 1.0
    return tm
