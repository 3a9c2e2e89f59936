"""Gallery matching: cosine top-k against a device-resident gallery.

Counterpart of ``facerec_tpu/ops/gallery.py``. ``gallery_topk_plain`` copies
``gallery_topk_xla``: an f32 matmul, rows at or past ``count`` masked to
-1e30, then a top-k whose ties go to the lower index (a stable descending
sort, since ``torch.topk`` promises no tie order). ``gallery_topk`` launches
the CUDA kernel ``csrc/gallery_topk.cu`` (the port of the Pallas
``_topk_kernel``) on CUDA tensors and takes the plain version only for CPU
tensors.

On the card a bf16 gallery takes the tensor-core kernel, which rounds the
queries to bf16 before the product, as ``gallery_topk_pallas`` casts them to
the gallery's dtype: it computes ``gallery_topk_plain(queries.bfloat16(),
gallery, ...)``. The CPU path keeps f32 queries, as the JAX package's CPU
dispatch (``gallery_topk_xla``) does.
"""

from __future__ import annotations

import functools

import torch

from facerec_torch.ops import kernels

NEG = -1e30
_TQ, _TG = 32, 64  # query tile and row tile of the f32 kernel in csrc/gallery_topk.cu
_BQ, _BG = 128, 128  # query tile and row tile of the bf16 (tensor-core) kernel
_MAXK = 32
_SMS = 132


def topk_stable(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis, descending, ties to the lower index (the
    ``lax.top_k`` order)."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def gallery_topk_plain(queries: torch.Tensor, gallery: torch.Tensor,
                       count: torch.Tensor | int, k: int = 5
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """[B, D] x [G, D] -> (scores f32 [B, k], indices int32 [B, k])."""
    scores = queries.float() @ gallery.float().T
    g = gallery.shape[0]
    count = torch.as_tensor(count, dtype=torch.int32, device=scores.device)
    valid = torch.arange(g, device=scores.device)[None, :] < count
    scores = torch.where(valid, scores, NEG)
    v, i = topk_stable(scores, k)
    return v, i.to(torch.int32)


def _splits(b: int, g: int) -> tuple[int, int]:
    """f32 kernel: (rows per split, splits), enough blocks for ~4 waves over
    the SMs, each split a whole number of score tiles."""
    qtiles = -(-b // _TQ)
    want = max(1, min(-(-g // _TG), -(-4 * _SMS // qtiles)))
    rows = -(-(-(-g // want)) // _TG) * _TG
    return rows, -(-g // rows)


def bf16_splits(b: int, g: int, sms: int = _SMS) -> int:
    """bf16 kernel: gallery splits for one wave of blocks (each block holds
    most of an SM's shared memory, so query tiles x splits <= SMs), at most
    one split per row tile of the capacity. The query tiles of one split
    are neighbours in launch order, so its rows cross HBM once."""
    return max(1, min(-(-g // _BG), sms // -(-b // _BQ)))


def bf16_rows_per_split(count: int, nsplit: int) -> int:
    """Rows of each split of the bf16 kernel for a valid prefix of ``count``
    rows, in whole row tiles, as the kernel computes it on the device."""
    return -(-(-(-count // nsplit)) // _BG) * _BG


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def gallery_topk(queries: torch.Tensor, gallery: torch.Tensor,
                 count: torch.Tensor | int, k: int = 5
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k cosine matches; the CUDA kernel on CUDA tensors (queries
    rounded to bf16 against a bf16 gallery), the plain version on CPU
    tensors. ``count`` may be a device int32 scalar (read by the kernel from
    device memory) or a Python int."""
    kernels.note("gallery_topk", queries, gallery, count, k)
    if not gallery.is_cuda:
        return gallery_topk_plain(queries, gallery, count, k)
    b, d = queries.shape
    g, dg = gallery.shape
    if d != dg:
        raise ValueError(f"query width {d} != gallery width {dg}")
    if not 1 <= k <= min(_MAXK, g):
        raise ValueError(f"k={k} must lie in [1, min({_MAXK}, {g})]")
    if gallery.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"gallery dtype {gallery.dtype} is not bf16 or f32")
    if not gallery.is_contiguous():
        raise ValueError("gallery must be contiguous")
    dev = gallery.device
    q = queries.to(device=dev, dtype=torch.float32).contiguous()
    cnt = torch.as_tensor(count, dtype=torch.int32, device=dev).reshape(())
    bf16 = gallery.dtype == torch.bfloat16
    if bf16:
        if d % 16:
            raise ValueError(f"the bf16 kernel takes widths that are multiples of 16, not {d}")
        if q.data_ptr() % 16 or gallery.data_ptr() % 16:
            raise ValueError("the bf16 kernel needs 16-byte aligned queries and gallery")
        rows, nsplit = 0, bf16_splits(b, g, _sm_count(dev.index or 0))
    else:
        rows, nsplit = _splits(b, g)
    cand_v = torch.empty((b, nsplit, k), dtype=torch.float32, device=dev)
    cand_i = torch.empty((b, nsplit, k), dtype=torch.int32, device=dev)
    out_v = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    kernels.launch("gallery_topk", q.data_ptr(), gallery.data_ptr(), int(bf16), cnt.data_ptr(),
                   b, g, d, k, rows, nsplit, cand_v.data_ptr(), cand_i.data_ptr(),
                   out_v.data_ptr(), out_i.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    return out_v, out_i


def cosine_to_euclidean(cos: torch.Tensor) -> torch.Tensor:
    """Euclidean distance between unit vectors from their cosine similarity."""
    return torch.sqrt(torch.clamp(2.0 - 2.0 * cos, min=0.0))
