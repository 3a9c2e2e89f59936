"""The port's counted CUDA kernels, in one table.

Each entry is one kernel launcher of ``csrc/``: its library (a
``build.SOURCES`` name), symbol and argument types; the name
``torch.profiler`` reports for its kernel (K1's first pass, where it has
two); and its plain twin (``module:function``), which takes the wrapper's
arguments. Adding a kernel is one entry here, its ``.cu`` and its wrapper.

A wrapper launches through ``launch``, which binds the symbol once, checks
the launch and counts it; a CPU tensor takes the plain twin and counts
nothing. ``launches``, ``zero`` and ``advance`` read and move the counts. A
replay of a captured step runs no Python, so the pipeline ``advance``s the
counts by what its capture counted. Each wrapper also hands its arguments
to ``note`` on either route, which keeps them for an open ``recording``
and does nothing otherwise.
"""

from __future__ import annotations

import contextlib
import ctypes
import importlib
from typing import Callable, NamedTuple

import torch

from facerec_torch import build

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


class Kernel(NamedTuple):
    library: str
    symbol: str
    argtypes: tuple
    profiler_name: str
    plain: str


TABLE = {
    "gallery_topk": Kernel(
        "gallery_topk", "gallery_topk_launch", (_P, _P, _I, _P) + (_I,) * 6 + (_P,) * 5,
        "topk_partial", "facerec_torch.ops.gallery:gallery_topk_plain"),
    "shear_rotate": Kernel(
        "shear_rotate", "shear_rotate_launch", (_P,) * 5 + (_I,) * 8 + (_P, _P),
        "shear_rotate", "facerec_torch.ops.warp_fast:rotate_patches"),
    "nms_suppress": Kernel(
        "nms_fixed_point", "nms_suppress_launch", (_P, _P, _P, _I, _I, _F, _I, _P, _P, _P),
        "nms_suppress", "facerec_torch.ops.nms:nms_suppress_plain"),
    "crop_resize": Kernel(
        "crop_resize", "crop_resize_launch", (_P, _I, _P) + (_I,) * 6 + (_P, _I, _P),
        "crop_resize", "facerec_torch.ops.warp_fast:crop_resize_matmul_batched"),
    "iresnet_epilogue": Kernel(
        "iresnet_epilogue", "iresnet_epilogue_launch",
        (_P,) * 4 + (ctypes.c_longlong, _I, ctypes.POINTER(_P), ctypes.POINTER(_F), _P, _P),
        "iresnet_epilogue", "facerec_torch.ops.iresnet_epilogue:iresnet_epilogue_plain"),
}

_counts = dict.fromkeys(TABLE, 0)
_open: dict[str, list[list]] = {}  # kernel -> the call lists of its open recordings


def launch(name: str, *args) -> None:
    """Call kernel ``name``'s launcher with ``args``, raise on a failed
    launch and count it."""
    k = TABLE[name]
    build.check(build.function(k.library, k.symbol, k.argtypes)(*args), name)
    _counts[name] += 1


def launches() -> dict[str, int]:
    """The launches of each kernel so far, by table name."""
    return dict(_counts)


def zero() -> None:
    for name in _counts:
        _counts[name] = 0


def advance(counts: dict[str, int]) -> None:
    """Add ``counts`` (by table name) to the launch counts."""
    for name, n in counts.items():
        _counts[name] += n


def plain(name: str) -> Callable:
    """Kernel ``name``'s plain twin."""
    module, fn = TABLE[name].plain.split(":")
    return getattr(importlib.import_module(module), fn)


def _copy(v):
    return v.detach().clone() if isinstance(v, torch.Tensor) else v


def note(name: str, *args, **kwargs) -> None:
    """A wrapper's call of kernel ``name``: its arguments go to each open
    ``recording`` of it, tensors copied."""
    for calls in _open.get(name, ()):
        calls.append((tuple(_copy(a) for a in args), {k: _copy(v) for k, v in kwargs.items()}))


@contextlib.contextmanager
def recording(name: str):
    """Yields a list that gathers (args, kwargs) of each wrapper call of
    kernel ``name`` in the block, on either route, in call order; the
    launch counts are left as they were before it."""
    calls: list = []
    before = launches()
    _open.setdefault(name, []).append(calls)
    try:
        yield calls
    finally:
        _open[name] = [c for c in _open[name] if c is not calls]
        _counts.update(before)
