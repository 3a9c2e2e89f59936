"""Weights made from the seed, on the device, in a few large calls, in the
type they are served in. The benchmark hands the same tensors to the
program and to the reference.

Every parameter is one slice of one normal draw, scaled by a rule of its
kind: convolution and dense kernels LeCun-normal (deviation 1 / sqrt(fan
in)), then made zero-mean over each output's fan-in; PReLU slopes (a 1-D
``weight`` of a module named ``prelu`` or ``prelu<N>``) 0.25 + 0.05 z,
about ``nn.PReLU``'s initial 0.25, so that no slope comes near 1, where
the PReLU would be the identity; other 1-D ``weight`` leaves, BatchNorm
scales, 1 + 0.1 z and running variances exp(0.2 z); BatchNorm shifts,
running means, other biases and the BatchNorm step counters 0.

The zero means and zero shifts keep a random net's embeddings of different
faces apart: with LeCun kernels alone the common part of the (positive)
activations dominates, and every face of a frame embeds within a cosine of
0.99 of every other."""

from __future__ import annotations

import re

import numpy as np
import torch

# keys of the seed sequence, one a purpose, so that each draw is its own
PURPOSES = ("frames", "embedder", "gallery", "sample", "train_data", "train_model")
PRELU = re.compile(r"prelu\d*")  # the module names of PReLUs (MTCNN's, insightface's IResNet)


def sub_seed(seed: int, purpose: str) -> int:
    """A 63-bit seed for one purpose of one run."""
    ss = np.random.SeedSequence([int(seed) & (2 ** 64 - 1), PURPOSES.index(purpose)])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(seed: int, purpose: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, purpose))


def _rule(name: str, shape: tuple) -> tuple[float, float, bool]:
    """(scale, shift, exponentiate) of a parameter's slice of the draw."""
    module, _, leaf = name.rpartition(".")
    if len(shape) >= 2:
        return float(np.prod(shape[1:])) ** -0.5, 0.0, False
    if leaf == "running_var":
        return 0.2, 0.0, True
    if leaf == "weight" and PRELU.fullmatch(module.rsplit(".", 1)[-1]):  # a PReLU slope
        return 0.05, 0.25, False
    if leaf == "weight":  # a BatchNorm scale
        return 0.1, 1.0, False
    return 0.0, 0.0, False  # shifts, running means, biases


def make_state(shapes: dict[str, tuple], seed: int, device, dtype=torch.bfloat16
               ) -> dict[str, torch.Tensor]:
    """A state dict of the given shapes, drawn from ``seed`` on ``device``."""
    names = [n for n, s in shapes.items() if not n.endswith("num_batches_tracked")]
    sizes = [int(np.prod(shapes[n])) for n in names]
    rules = [_rule(n, shapes[n]) for n in names]
    counts = torch.tensor(sizes, device=device)
    scale = torch.repeat_interleave(torch.tensor([r[0] for r in rules], device=device), counts)
    shift = torch.repeat_interleave(torch.tensor([r[1] for r in rules], device=device), counts)
    expo = torch.repeat_interleave(torch.tensor([r[2] for r in rules], device=device), counts)
    z = torch.randn(int(sum(sizes)), generator=generator(seed, "embedder", device),
                    device=device)
    flat = z * scale + shift
    flat = torch.where(expo, torch.exp(flat), flat)
    off = 0
    for n, size in zip(names, sizes):
        if len(shapes[n]) >= 2:  # zero-mean over each output's fan-in
            rows = flat[off:off + size].view(shapes[n][0], -1)
            rows.sub_(rows.mean(dim=1, keepdim=True))
        off += size
    flat = flat.to(dtype)
    out, off = {}, 0
    for n, size in zip(names, sizes):
        out[n] = flat[off:off + size].view(shapes[n])
        off += size
    for n, s in shapes.items():
        if n.endswith("num_batches_tracked"):
            out[n] = torch.zeros((), dtype=torch.long, device=device)
    return out


def gallery_rows(n: int, dim: int, seed: int, device, chunk: int = 1 << 18):
    """The gallery's ``n`` raw rows, standard normals from ``seed``, in
    chunks of ``chunk`` rows: yields (start, rows [m, dim] f32)."""
    g = generator(seed, "gallery", device)
    for start in range(0, n, chunk):
        m = min(chunk, n - start)
        yield start, torch.randn(m, dim, generator=g, device=device)
