"""Reference and facenet-pytorch checkpoints -> the port's state dicts, and
back (counterpart of ``facerec_tpu/models/convert.py``).

The reference's ``.pth`` files hold PyTorch state dicts of its own models
(``face_models.py``), whose key names differ from the port's where the JAX
package renamed a module: ``resnet.*`` / ``resnet.fc.1`` (cnn),
``cnn.*``, the packed ``in_proj``, ``out_proj`` and ``ff.{0,3}`` (hybrid),
``arcface.weight`` (arcface), the ``conv.{i}`` / ``fc.{i}`` Sequential
indices (siamese). Both sides are NCHW PyTorch layouts, so a tensor changes
its name and, in three places, its shape or order:

  * the hybrid's packed [3D, D] ``in_proj`` is the port's query, key and
    value [D, D] weights stacked, and its [S, 1, D] ``pos_encoding`` is the
    port's [S, D];
  * the siamese ``fc1`` reads a 512 x 6 x 6 map flattened in CHW order in
    the reference and in HWC order in the port (which flattens NHWC, as the
    JAX nets do), so its input columns are permuted;
  * facenet-pytorch's R-Net and O-Net flatten ``x.permute(0, 3, 2, 1)``,
    (W, H, C) order, before ``dense4`` / ``dense5``; the port flattens (H,
    W, C), so those columns are permuted too, over 64 x 3 x 3 and 128 x 3 x
    3 maps.

``convert_checkpoint(path, model_type)`` reads a reference ``.pth``;
``convert_mtcnn_net`` takes facenet-pytorch's ``pnet``/``rnet``/``onet``
state dicts; ``to_reference_state_dict`` is the inverse for the seven model
types, the ensemble included. The facenet-pytorch InceptionResnetV1 needs
no conversion: ``models.facenet`` uses its names and layouts.
"""

from __future__ import annotations

import functools
from pathlib import Path
from typing import Mapping, Sequence

import numpy as np
import torch

StateDict = dict[str, torch.Tensor]

# (port prefix or key, reference prefix or key): the most specific first. A
# key no rule matches has the same name on both sides.
_RENAMES: dict[str, list[tuple[str, str]]] = {
    "baseline": [],
    "cnn": [("fc.", "resnet.fc.1."), ("backbone.", "resnet.")],
    "attention": [],
    "arcface": [("arc_weight", "arcface.weight")],
    "hybrid": [("backbone.", "cnn."), ("transformer.ff1.", "transformer.ff.0."),
               ("transformer.ff2.", "transformer.ff.3."),
               ("transformer.attention.out.", "transformer.attention.out_proj.")],
    "siamese": ([(f"conv{i}.", f"conv.{c}.") for i, c in enumerate((0, 4, 7, 11, 14, 18))]
                + [(f"conv_bn{i}.", f"conv.{c + 1}.") for i, c in enumerate((0, 4, 7, 11, 14, 18))]
                + [("fc1.", "fc.1."), ("fc_bn1.", "fc.2."), ("fc2.", "fc.5."),
                   ("fc_bn2.", "fc.6."), ("fc3.", "fc.8.")]),
}
# reference keys with no counterpart in the port: ArcFace's val_classifier,
# the randomly initialised head the reference's eval used (JAX drops it too)
_DROPPED = {"arcface": ("val_classifier.",)}
_SIAMESE_FC1_CHW = (512, 6, 6)
_MTCNN_DENSE = {"rnet": ("dense4", (64, 3, 3)), "onet": ("dense5", (128, 3, 3))}
_QKV = ("query", "key", "value")


def load_torch_state_dict(path: str | Path) -> StateDict:
    """The state dict in a torch-pickled file, unwrapped from a
    ``state_dict`` or ``model_state_dict`` entry. Only tensors, containers
    and plain values are unpickled (``weights_only``): a file that pickles
    other objects is refused."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, Mapping) and "state_dict" in obj:
        obj = obj["state_dict"]
    if isinstance(obj, Mapping) and "model_state_dict" in obj:
        obj = obj["model_state_dict"]
    if not isinstance(obj, Mapping):
        raise ValueError(f"{path} holds a {type(obj).__name__}, not a state dict")
    return {k: v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
            for k, v in obj.items()}


def _rename(key: str, rules: list[tuple[str, str]]) -> str:
    for src, dst in rules:
        if key == src or (src.endswith(".") and key.startswith(src)):
            return dst + key[len(src):]
    return key


def _hwc_columns(layout: str, c: int, h: int, w: int) -> np.ndarray:
    """Column indices that gather a dense weight whose input columns
    flatten a C x H x W map in ``layout`` order ("chw" or "whc") into the
    port's (H, W, C) order."""
    dims = {"c": c, "h": h, "w": w}
    src = np.arange(c * h * w).reshape([dims[a] for a in layout])
    return src.transpose([layout.index(a) for a in "hwc"]).reshape(-1)


def _permute_columns(w: torch.Tensor, idx: np.ndarray) -> torch.Tensor:
    return w[:, torch.from_numpy(idx)].contiguous()


def _from_reference(sd: Mapping[str, torch.Tensor], model_type: str) -> StateDict:
    rules = [(ref, port) for port, ref in _RENAMES[model_type]]
    dropped = _DROPPED.get(model_type, ())
    out: StateDict = {}
    for k, v in sd.items():
        if k.startswith(dropped):
            continue
        if model_type == "hybrid" and k.startswith("transformer.attention.in_proj_"):
            kind = k.rsplit("_", 1)[1]  # weight or bias
            for name, part in zip(_QKV, v.chunk(3, dim=0)):
                out[f"transformer.attention.{name}.{kind}"] = part.clone()
            continue
        key = _rename(k, rules)
        if model_type == "hybrid" and key == "pos_encoding":
            v = v[:, 0, :]
        elif model_type == "siamese" and key == "fc1.weight":
            v = _permute_columns(v, _hwc_columns("chw", *_SIAMESE_FC1_CHW))
        out[key] = v.clone()
    return out


def _to_reference(sd: Mapping[str, torch.Tensor], model_type: str) -> StateDict:
    out: StateDict = {}
    for k, v in sd.items():
        if model_type == "hybrid" and k.startswith("transformer.attention.query."):
            kind = k.rsplit(".", 1)[1]
            out[f"transformer.attention.in_proj_{kind}"] = torch.cat(
                [sd[f"transformer.attention.{n}.{kind}"] for n in _QKV], dim=0)
            continue
        if model_type == "hybrid" and k.startswith(("transformer.attention.key.",
                                                    "transformer.attention.value.")):
            continue
        if model_type == "hybrid" and k == "pos_encoding":
            v = v[:, None, :]
        elif model_type == "siamese" and k == "fc1.weight":
            v = _permute_columns(v, np.argsort(_hwc_columns("chw", *_SIAMESE_FC1_CHW)))
        out[_rename(k, _RENAMES[model_type])] = v.detach().clone()
    return out


# model type -> ``convert(reference state dict) -> the port's``
CONVERTERS = {t: functools.partial(_from_reference, model_type=t) for t in _RENAMES}


def convert_checkpoint(path: str | Path, model_type: str) -> StateDict:
    """A reference ``.pth`` -> the state dict of the port's ``model_type``."""
    if model_type not in CONVERTERS:
        raise ValueError(f"no converter for {model_type}")
    return CONVERTERS[model_type](load_torch_state_dict(path))


def convert_mtcnn_net(sd: Mapping[str, torch.Tensor], which: str) -> StateDict:
    """A facenet-pytorch ``pnet``/``rnet``/``onet`` state dict -> the port's
    net of the same names, the R-Net and O-Net dense columns from (W, H, C)
    to (H, W, C) order."""
    if which not in ("pnet", "rnet", "onet"):
        raise ValueError(f"no MTCNN net {which!r}")
    out = {k: v.detach().clone() for k, v in sd.items()}
    if which in _MTCNN_DENSE:
        dense, chw = _MTCNN_DENSE[which]
        out[f"{dense}.weight"] = _permute_columns(out[f"{dense}.weight"],
                                                  _hwc_columns("whc", *chw))
    return out


def to_reference_state_dict(state_dict: Mapping[str, torch.Tensor], model_type: str,
                            member_types: Sequence[str] | None = None) -> StateDict:
    """The port's ``model_type`` state dict -> the reference's key layout
    (loads strict into the reference's model). An ensemble's members become
    ``models.{i}.*`` by their types (default: cnn, attention, arcface), and
    its ``weights`` are uniform when the port's method keeps none, as the
    reference registers them for every method."""
    if model_type == "ensemble":
        from facerec_torch.models import DEFAULT_ENSEMBLE_MEMBERS

        types = list(member_types or DEFAULT_ENSEMBLE_MEMBERS)
        out: StateDict = {}
        for i, t in enumerate(types):
            prefix = f"members_{i}."
            member = {k[len(prefix):]: v for k, v in state_dict.items() if k.startswith(prefix)}
            out.update({f"models.{i}.{k}": v for k, v in _to_reference(member, t).items()})
        out["weights"] = (state_dict["weights"].detach().clone() if "weights" in state_dict
                          else torch.full((len(types),), 1.0 / len(types)))
        for port, ref in (("attn1", "attention_net.0"), ("attn2", "attention_net.2")):
            for kind in ("weight", "bias"):
                if f"{port}.{kind}" in state_dict:
                    out[f"{ref}.{kind}"] = state_dict[f"{port}.{kind}"].detach().clone()
        return out
    if model_type not in _RENAMES:
        raise ValueError(f"no reverse converter for {model_type}")
    return _to_reference(state_dict, model_type)

