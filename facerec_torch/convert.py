"""Weight bridge: JAX/Flax parameter trees -> the port's state dicts.

``from_jax(tree, which)`` takes a nested mapping of arrays (numpy or
anything ``np.asarray`` reads) as the JAX package stores it, either a bare
``params`` tree (the MTCNN ``.npz`` files) or ``{"params", "batch_stats"}``
(the embedder, and the models the trainer trains, whose statistics may come
from ``apply(..., mutable=["batch_stats"])``), and returns a
``{key: torch.Tensor}`` state dict for ``which`` in pnet/rnet/onet and the
seven trainable types (baseline, cnn, siamese, attention, arcface, hybrid,
ensemble). Conv kernels go HWIO -> OIHW, dense kernels [in, out] -> [out,
in], LayerNorm ``scale`` -> ``weight``; the attention's [D, H, D/H] and
[H, D/H, D] kernels flatten to [D, D]; ArcFace's class centres
``arc_weight`` [C, D], the hybrid's ``pos_encoding`` and the attention's
``gamma`` carry over as they are. No row permutation is needed before the
R-Net/O-Net/siamese dense layers because the port flattens their feature
maps in NHWC order, as the JAX nets do. A gradient tree has the
parameters' shape, so it carries over the same way.
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


def _layer_norm(p: Mapping, out: dict, key: str) -> None:
    out[f"{key}.weight"] = _t(p["scale"])
    out[f"{key}.bias"] = _t(p["bias"])


def _mha(p: Mapping, out: dict, key: str) -> None:
    """Flax's MultiHeadDotProductAttention: [D, H, D/H] query/key/value
    kernels with [H, D/H] biases and an [H, D/H, D] output kernel, as [D, D]
    ``nn.Linear`` weights (heads major in the projected dim)."""
    for name in ("query", "key", "value"):
        k = np.asarray(p[name]["kernel"], np.float32)
        out[f"{key}.{name}.weight"] = _t(k.reshape(k.shape[0], -1).T)
        out[f"{key}.{name}.bias"] = _t(np.asarray(p[name]["bias"], np.float32).reshape(-1))
    k = np.asarray(p["out"]["kernel"], np.float32)
    out[f"{key}.out.weight"] = _t(k.reshape(-1, k.shape[-1]).T)
    out[f"{key}.out.bias"] = _t(p["out"]["bias"])


def _model(params: Mapping, stats: Mapping, out: dict, which: str, prefix: str = "",
           member_types: list[str] | None = None) -> None:
    """The state dict of one of the seven trainable model types, its keys
    under ``prefix``."""
    if which == "arcface":
        _resnet18(params["backbone"], stats["backbone"], out, f"{prefix}backbone.")
        _dense(params["embedding"], out, f"{prefix}embedding")
        _bn(params["bn"], stats["bn"], out, f"{prefix}bn")
        out[f"{prefix}arc_weight"] = _t(params["arc_weight"])
    elif which == "baseline":
        for i in (1, 2, 3):
            _conv(params[f"conv{i}"], out, f"{prefix}conv{i}")
            _bn(params[f"bn{i}"], stats[f"bn{i}"], out, f"{prefix}bn{i}")
        _dense(params["fc1"], out, f"{prefix}fc1")
        _dense(params["fc2"], out, f"{prefix}fc2")
    elif which in ("cnn", "attention", "hybrid"):
        _resnet18(params["backbone"], stats["backbone"], out, f"{prefix}backbone.")
        _dense(params["fc"], out, f"{prefix}fc")
        if which == "attention":
            a, t = params["attention"], f"{prefix}attention"
            for name in ("query", "key", "value"):
                _conv(a[name], out, f"{t}.{name}")
            out[f"{t}.gamma"] = _t(a["gamma"])
            _conv(a["spatial_attention"]["conv"], out, f"{t}.spatial_attention.conv")
        elif which == "hybrid":
            out[f"{prefix}pos_encoding"] = _t(params["pos_encoding"])
            b, t = params["transformer"], f"{prefix}transformer"
            _layer_norm(b["norm1"], out, f"{t}.norm1")
            _mha(b["attention"], out, f"{t}.attention")
            _layer_norm(b["norm2"], out, f"{t}.norm2")
            _dense(b["ff1"], out, f"{t}.ff1")
            _dense(b["ff2"], out, f"{t}.ff2")
            _layer_norm(params["norm"], out, f"{prefix}norm")
    elif which == "siamese":
        for i in range(6):
            _conv(params[f"conv{i}"], out, f"{prefix}conv{i}")
            _bn(params[f"conv_bn{i}"], stats[f"conv_bn{i}"], out, f"{prefix}conv_bn{i}")
        for i in (1, 2, 3):
            _dense(params[f"fc{i}"], out, f"{prefix}fc{i}")
        for i in (1, 2):
            _bn(params[f"fc_bn{i}"], stats[f"fc_bn{i}"], out, f"{prefix}fc_bn{i}")
    elif which == "ensemble":
        if member_types is None:
            from facerec_torch.models import DEFAULT_ENSEMBLE_MEMBERS

            member_types = DEFAULT_ENSEMBLE_MEMBERS
        for i, t in enumerate(member_types):
            name = f"members_{i}"
            _model(params[name], stats.get(name, {}), out, t, f"{prefix}{name}.")
        if "weights" in params:
            out[f"{prefix}weights"] = _t(params["weights"])
        for name in ("attn1", "attn2"):
            if name in params:
                _dense(params[name], out, f"{prefix}{name}")
    else:
        raise ValueError(f"no converter for {which!r}")


def from_jax(tree: Mapping[str, Any], which: str,
             member_types: list[str] | None = None) -> dict[str, torch.Tensor]:
    """JAX parameter tree -> state dict of the port's ``which`` network. An
    ``ensemble``'s members are converted by their types, ``member_types``
    (default: the default members cnn, attention, arcface)."""
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
    else:
        _model(params, stats, out, which, member_types=member_types)
    return out
