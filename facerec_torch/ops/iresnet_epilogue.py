"""Wrapper of the IResNet epilogue kernel ``csrc/iresnet_epilogue.cu``.

One pass over a bf16 channels_last map [N, C, H, W] of an IResNet served in
eval mode (``models/iresnet.py``) applies what the module chain runs between
two convolutions as separate PyTorch kernels, and stores bf16 where it does:

    z  = bn(a)                     the BatchNorm on the conv's output
    z  = prelu(z)                  with ``prelu``
    z  = z + shortcut              with ``shortcut``: the identity, or
         z + shortcut_bn(shortcut) its 1 x 1 conv's output through its BatchNorm
    zn = next_bn(z)                with ``next_bn``: the next block's ``bn1``
                                   (or the head's ``bn2``)

and returns ``(z, zn)``, ``z`` None where ``keep`` is False. Each BatchNorm
is the eval BatchNorm of its module's own parameters and running statistics,
read where they lie at every call. ``iresnet_epilogue_plain`` states the pass
with the functional ops the module chain calls (``F.batch_norm``, ``F.prelu``,
``+``), so it equals the chain bit for bit wherever it runs; the kernel
repeats the card's arithmetic of those ops op by op and equals it there.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn as nn
import torch.nn.functional as F

from facerec_torch.ops import kernels

MAX_CHANNELS = 512  # kMaxC in csrc/iresnet_epilogue.cu
VEC = 8  # bf16 channels of a 16-byte vector: C must be a multiple


def _batch_norm(x: torch.Tensor, bn: nn.BatchNorm2d) -> torch.Tensor:
    return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight, bn.bias, False, 0.0,
                        bn.eps)


def iresnet_epilogue_plain(a: torch.Tensor, bn: nn.BatchNorm2d, *, prelu: nn.PReLU | None = None,
                           shortcut: torch.Tensor | None = None,
                           shortcut_bn: nn.BatchNorm2d | None = None,
                           next_bn: nn.BatchNorm2d | None = None, keep: bool = True
                           ) -> tuple[torch.Tensor | None, torch.Tensor | None]:
    """The pass (module docstring) as the module chain computes it."""
    z = _batch_norm(a, bn)
    if prelu is not None:
        z = F.prelu(z, prelu.weight)
    if shortcut is not None:
        z = z + (shortcut if shortcut_bn is None else _batch_norm(shortcut, shortcut_bn))
    return (z if keep else None), (None if next_bn is None else _batch_norm(z, next_bn))


def _check_map(name: str, t: torch.Tensor, like: torch.Tensor | None = None) -> None:
    if t.dtype != torch.bfloat16:
        raise TypeError(f"{name}: the pass reads bf16 maps, not {t.dtype}")
    if like is not None:
        if t.device != like.device:
            raise ValueError(f"{name} on {t.device}, the map on {like.device}")
        if t.shape != like.shape:
            raise ValueError(f"{name} {tuple(t.shape)} is not the map's {tuple(like.shape)}")
        return
    if t.dim() != 4:
        raise ValueError(f"{name}: a map is [N, C, H, W], not {tuple(t.shape)}")
    if not t.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"{name} must be channels_last and dense")
    c = t.shape[1]
    if c % VEC or not 0 < c <= MAX_CHANNELS:
        raise ValueError(f"the pass takes a multiple of {VEC} channels up to {MAX_CHANNELS}, "
                         f"not {c}")


def _params(name: str, module: nn.Module, a: torch.Tensor) -> list[torch.Tensor]:
    """A module's [C] bf16 tensors the kernel reads: a BatchNorm's weight,
    bias, running mean and variance, or a PReLU's weight."""
    ts = ([module.weight] if isinstance(module, nn.PReLU) else
          [module.weight, module.bias, module.running_mean, module.running_var])
    for t in ts:
        if t is None:
            raise ValueError(f"{name} has no affine parameters or running statistics")
        if t.device != a.device:
            raise ValueError(f"{name} on {t.device}, the map on {a.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: the pass reads bf16 parameters, not {t.dtype}")
        if t.shape != (a.shape[1],) or not t.is_contiguous():
            raise ValueError(f"{name}: {tuple(t.shape)} parameters for a map of {a.shape[1]} "
                             "channels")
    return ts


def iresnet_epilogue(a: torch.Tensor, bn: nn.BatchNorm2d, *, prelu: nn.PReLU | None = None,
                     shortcut: torch.Tensor | None = None,
                     shortcut_bn: nn.BatchNorm2d | None = None,
                     next_bn: nn.BatchNorm2d | None = None, keep: bool = True
                     ) -> tuple[torch.Tensor | None, torch.Tensor | None]:
    """The pass (module docstring): ``a`` a bf16 channels_last map of C
    channels (a multiple of 8, at most 512), ``shortcut`` one like it, the
    modules' parameters bf16 [C] on its device. The CUDA kernel on CUDA
    tensors, ``iresnet_epilogue_plain`` on CPU tensors; either raises on
    any other input."""
    kernels.note("iresnet_epilogue", a, bn, prelu=prelu, shortcut=shortcut,
                 shortcut_bn=shortcut_bn, next_bn=next_bn, keep=keep)
    _check_map("the map", a)
    if shortcut is not None:
        _check_map("the shortcut", shortcut, a)
    elif shortcut_bn is not None:
        raise ValueError("a shortcut BatchNorm without a shortcut")
    if not keep and next_bn is None:
        raise ValueError("the pass would write nothing: keep is False and there is no next_bn")
    mods = {"bn": bn, "prelu": prelu, "shortcut_bn": shortcut_bn, "next_bn": next_bn}
    params = {k: _params(k, m, a) for k, m in mods.items() if m is not None}
    if not a.is_cuda:
        return iresnet_epilogue_plain(a, bn, prelu=prelu, shortcut=shortcut,
                                      shortcut_bn=shortcut_bn, next_bn=next_bn, keep=keep)
    n, c, h, w = a.shape
    z = torch.empty_like(a, memory_format=torch.channels_last) if keep else None
    zn = torch.empty_like(a, memory_format=torch.channels_last) if next_bn is not None else None
    ptrs, eps = [], []
    for k in ("bn", "shortcut_bn", "next_bn"):
        ptrs += [t.data_ptr() for t in params[k]] if k in params else [None] * 4
        eps.append(mods[k].eps if k in params else 0.0)
    for t in (a, shortcut, z, zn):
        if t is not None and t.data_ptr() % 16:
            raise ValueError("the pass reads and writes 16-byte vectors: a map is not aligned")
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    dev = a.device
    with torch.cuda.device(dev):  # the launcher sizes the grid on the current device
        kernels.launch("iresnet_epilogue", ptr(a), ptr(shortcut), ptr(z), ptr(zn), n * h * w, c,
                       (ctypes.c_void_p * 12)(*ptrs), (ctypes.c_float * 3)(*eps),
                       params["prelu"][0].data_ptr() if prelu is not None else None,
                       torch.cuda.current_stream(dev).cuda_stream)
    return z, zn
