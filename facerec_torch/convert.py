"""Weight bridge: JAX/Flax parameter trees -> the port's state dicts.

``from_jax(tree, which)`` takes a nested mapping of arrays (numpy or
anything ``np.asarray`` reads) as the JAX package stores it, either a bare
``params`` tree (the MTCNN ``.npz`` files) or ``{"params", "batch_stats"}``
(the embedder, and the models the trainer trains, whose statistics may come
from ``apply(..., mutable=["batch_stats"])``), and returns a
``{key: torch.Tensor}`` state dict for ``which`` in
pnet/rnet/onet/arcface/baseline. Conv kernels go HWIO -> OIHW, dense
kernels [in, out] -> [out, in]; ArcFace's class centres ``arc_weight``
[C, D] carry over as they are. No row permutation is needed before the
R-Net/O-Net dense layers because the port flattens their feature maps in
NHWC order, as the JAX nets do. A gradient tree has the parameters' shape,
so it carries over the same way.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any

import numpy as np
import torch

_MTCNN = {
    "pnet": (["conv1", "conv2", "conv3", "conv4_1", "conv4_2"], 3, []),
    "rnet": (["conv1", "conv2", "conv3"], 4, ["dense4", "dense5_1", "dense5_2"]),
    "onet": (["conv1", "conv2", "conv3", "conv4"], 5,
             ["dense5", "dense6_1", "dense6_2", "dense6_3"]),
}


def _t(x: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(np.asarray(x, dtype=np.float32)))


def _conv(p: Mapping, out: dict, key: str, bias: bool = True) -> None:
    out[f"{key}.weight"] = _t(np.transpose(np.asarray(p["kernel"], np.float32), (3, 2, 0, 1)))
    if bias and "bias" in p:
        out[f"{key}.bias"] = _t(p["bias"])


def _dense(p: Mapping, out: dict, key: str) -> None:
    out[f"{key}.weight"] = _t(np.asarray(p["kernel"], np.float32).T)
    if "bias" in p:
        out[f"{key}.bias"] = _t(p["bias"])


def _bn(p: Mapping, s: Mapping, out: dict, key: str) -> None:
    out[f"{key}.weight"] = _t(p["scale"])
    out[f"{key}.bias"] = _t(p["bias"])
    out[f"{key}.running_mean"] = _t(s["mean"])
    out[f"{key}.running_var"] = _t(s["var"])
    out[f"{key}.num_batches_tracked"] = torch.tensor(0)


def _resnet18(p: Mapping, s: Mapping, out: dict, prefix: str) -> None:
    _conv(p["conv1"], out, f"{prefix}conv1", bias=False)
    _bn(p["bn1"], s["bn1"], out, f"{prefix}bn1")
    for li in range(1, 5):
        for bi in range(2):
            name = f"layer{li}_{bi}"
            bp, bs, t = p[name], s[name], f"{prefix}layer{li}.{bi}"
            _conv(bp["conv1"], out, f"{t}.conv1", bias=False)
            _bn(bp["bn1"], bs["bn1"], out, f"{t}.bn1")
            _conv(bp["conv2"], out, f"{t}.conv2", bias=False)
            _bn(bp["bn2"], bs["bn2"], out, f"{t}.bn2")
            if "downsample_conv" in bp:
                _conv(bp["downsample_conv"], out, f"{t}.downsample.0", bias=False)
                _bn(bp["downsample_bn"], bs["downsample_bn"], out, f"{t}.downsample.1")


def from_jax(tree: Mapping[str, Any], which: str) -> dict[str, torch.Tensor]:
    """JAX parameter tree -> state dict of the port's ``which`` network."""
    params = tree["params"] if "params" in tree else tree
    stats = tree.get("batch_stats", {}) if "params" in tree else {}
    out: dict[str, torch.Tensor] = {}
    if which in _MTCNN:
        convs, n_prelu, denses = _MTCNN[which]
        for c in convs:
            _conv(params[c], out, c)
        for i in range(1, n_prelu + 1):
            out[f"prelu{i}.weight"] = _t(params[f"prelu{i}"]["alpha"])
        for d in denses:
            _dense(params[d], out, d)
    elif which == "arcface":
        _resnet18(params["backbone"], stats["backbone"], out, "backbone.")
        _dense(params["embedding"], out, "embedding")
        _bn(params["bn"], stats["bn"], out, "bn")
        out["arc_weight"] = _t(params["arc_weight"])
    elif which == "baseline":
        for i in (1, 2, 3):
            _conv(params[f"conv{i}"], out, f"conv{i}")
            _bn(params[f"bn{i}"], stats[f"bn{i}"], out, f"bn{i}")
        _dense(params["fc1"], out, "fc1")
        _dense(params["fc2"], out, "fc2")
    else:
        raise ValueError(f"no converter for {which!r}")
    return out
