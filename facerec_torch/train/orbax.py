"""Read a checkpoint tree that orbax wrote (the JAX trainer's
``save_checkpoint``) without JAX, orbax or tensorstore.

Such a directory holds ``_METADATA`` (JSON: each leaf's key path), an OCDBT
key-value store (``facerec_torch.train.ocdbt``) and, in it, one zarr v2
array per leaf: ``<dotted key path>/.zarray`` (JSON) and its chunks under
``<dotted key path>/<i.j.k>`` (``0`` for a 0-d array).

    tree = read_orbax_tree("outputs/checkpoints/arcface_synth/best")
    tree["params"]["arc_weight"]       # numpy float32 [16, 512]

``read_orbax_tree`` returns the nested tree that the JAX package's
``load_checkpoint`` restores without a target: dicts for mapping keys,
lists for sequence keys (an optax state's tuples), numpy arrays at the
leaves, and Python numbers for leaves orbax saved as scalars. A
``bfloat16`` array comes back as a ``torch.bfloat16`` tensor, numpy having
no such dtype.
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Any

import numpy as np
import torch

from facerec_torch.train import ocdbt
from facerec_torch.utils import zstd

METADATA_FILE = "_METADATA"
_KEY_SEQUENCE, _KEY_DICT = 1, 2
_ARRAY_TYPES = {"np.ndarray", "jax.Array"}
_SCALAR_TYPE = "scalar"
_FILLS = {"NaN": math.nan, "Infinity": math.inf, "-Infinity": -math.inf}


def _dtype(name: str, array: str) -> tuple[np.dtype, bool]:
    """The storage dtype of a zarr v2 ``dtype`` field, and whether it is
    bfloat16 (stored as 2-byte words)."""
    if name == "bfloat16":
        return np.dtype("<u2"), True
    try:
        dt = np.dtype(name)
    except TypeError as e:
        raise ValueError(f"{array}: zarr dtype {name!r} is not supported") from e
    if dt.kind not in "biuf" or dt.fields is not None:
        raise ValueError(f"{array}: zarr dtype {name!r} is not supported")
    return dt, False


def read_zarr(store: ocdbt.OcdbtStore, name: str) -> np.ndarray | torch.Tensor:
    """One zarr v2 array of ``store``: C order, a regular chunk grid whose
    edge chunks are stored whole, absent chunks at ``fill_value``, chunks
    raw or zstd-compressed. Filters, other compressors and F order are
    refused with the array's name."""
    meta = json.loads(store.read(f"{name}/.zarray"))
    if meta.get("zarr_format") != 2:
        raise ValueError(f"{name}: zarr format {meta.get('zarr_format')!r}, expected 2")
    if meta.get("filters"):
        raise ValueError(f"{name}: zarr filters {meta['filters']} are not supported")
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise ValueError(f"{name}: zarr compressor {comp.get('id')!r} is not supported")
    if meta.get("order", "C") != "C":
        raise ValueError(f"{name}: zarr order {meta['order']!r} is not supported")
    dtype, bf16 = _dtype(meta["dtype"], name)
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    if len(chunks) != len(shape) or any(c <= 0 for c in chunks):
        raise ValueError(f"{name}: chunks {list(chunks)} do not fit shape {list(shape)}")
    sep = meta.get("dimension_separator", ".")

    fill = meta.get("fill_value")
    fill = _FILLS.get(fill, fill) if fill is not None else 0
    if bf16:  # the fill as a bfloat16 bit pattern
        fill = int(torch.tensor(float(fill), dtype=torch.bfloat16).view(torch.int16)) & 0xFFFF
    out = np.full(shape, fill, dtype=dtype.newbyteorder("="))

    chunk_bytes = math.prod(chunks) * dtype.itemsize
    grid = [math.ceil(s / c) for s, c in zip(shape, chunks)]
    for idx in np.ndindex(*grid):
        key = f"{name}/{sep.join(map(str, idx)) if idx else '0'}"
        if key not in store:
            continue
        data = store.read(key)
        if comp is not None:
            data = zstd.decompress(data, size_hint=chunk_bytes)
        if len(data) != chunk_bytes:
            raise ValueError(f"{key}: chunk holds {len(data)} bytes, expected {chunk_bytes}")
        chunk = np.frombuffer(data, dtype).reshape(chunks)
        dst = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(idx, chunks, shape))
        out[dst] = chunk[tuple(slice(0, d.stop - d.start) for d in dst)]
    if bf16:
        return torch.from_numpy(out.view(np.int16)).view(torch.bfloat16)
    return out


def _nest(node: dict, path: list[tuple[str, int]], value: Any, array: str) -> None:
    for i, (key, kind) in enumerate(path):
        if kind not in (_KEY_SEQUENCE, _KEY_DICT):
            raise ValueError(f"{array}: key type {kind} is not supported")
        k = int(key) if kind == _KEY_SEQUENCE else str(key)
        if i == len(path) - 1:
            node[k] = value
        else:
            node = node.setdefault(k, {})


def _lists(node: Any) -> Any:
    """Sequence levels (integer keys) as lists, in index order."""
    if not isinstance(node, dict):
        return node
    out = {k: _lists(v) for k, v in node.items()}
    if out and all(isinstance(k, int) for k in out):
        return [out[i] for i in sorted(out)]
    return out


def read_orbax_tree(path: str | Path) -> dict:
    """The nested tree of an orbax checkpoint directory (see the module
    docstring)."""
    root = Path(path)
    meta = json.loads((root / METADATA_FILE).read_text())
    store = ocdbt.open(root)
    tree: dict = {}
    for entry in meta["tree_metadata"].values():
        path_keys = [(k["key"], k["key_type"]) for k in entry["key_metadata"]]
        name = ".".join(str(k) for k, _ in path_keys)
        kind = entry.get("value_metadata", {}).get("value_type")
        if kind not in _ARRAY_TYPES and kind != _SCALAR_TYPE:
            raise ValueError(f"{name}: orbax value type {kind!r} is not supported")
        value = read_zarr(store, name)
        if kind == _SCALAR_TYPE:
            value = value.item()
        _nest(tree, path_keys, value, name)
    return _lists(tree)

