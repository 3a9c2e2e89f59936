"""The benchmark's own counts: model FLOPs from layer shapes, the least time
of the two port kernels that the roofline shares read, and the card's
peaks. Nothing here reads the program: the counts stay the same whatever
implements the layers.

A multiply-add counts as 2 FLOPs; ``*_macs`` functions count multiply-adds.
Only convolutions and dense layers are counted (their products are where
the operations are); BatchNorm, activations, pooling and the align's
resampling products are not. An embedder kind's module
(``embedders/<kind>.py``) gives its own count (``macs``, ``train_macs``):
the two kinds here call their counting functions below, and a new kind
computes its count in its own module from ``conv_out`` and ``conv_macs``,
without an edit to this file."""

from __future__ import annotations

import math

PEAK_BF16_FLOPS = 989e12  # H100 SXM, dense bf16 (NVIDIA's data sheet)
PEAK_F32_FLOPS = 67e12  # H100 SXM, f32 outside the tensor cores
PEAK_HBM_BYTES = 3.35e12  # H100 SXM, HBM3


def conv_out(size: int, k: int, stride: int = 1, pad: int = 0) -> int:
    return (size + 2 * pad - k) // stride + 1


def conv_macs(cin: int, cout: int, kh: int, kw: int, oh: int, ow: int) -> int:
    return cin * cout * kh * kw * oh * ow


# ------------------------------------------------------------ embedders
def resnet18_macs(size: int, width: int = 64, fc_out: int = 0, embedding_dim: int = 0) -> int:
    """ResNet-18 at ``size`` px: the trunk, plus a ``fc_out`` classifier or
    an ``embedding_dim`` projection from the pooled 8 * width features."""
    s = conv_out(size, 7, 2, 3)
    macs = conv_macs(3, width, 7, 7, s, s)
    s = conv_out(s, 3, 2, 1)  # max pool
    cin = width
    for li, c in enumerate((width, 2 * width, 4 * width, 8 * width)):
        for bi in range(2):
            stride = 2 if (li > 0 and bi == 0) else 1
            o = conv_out(s, 3, stride, 1)
            macs += conv_macs(cin, c, 3, 3, o, o) + conv_macs(c, c, 3, 3, o, o)
            if stride != 1 or cin != c:
                macs += conv_macs(cin, c, 1, 1, o, o)
            s, cin = o, c
    return macs + cin * fc_out + cin * embedding_dim


def inception_resnet_v1_macs(size: int = 160, repeats=(5, 10, 5), embedding_dim: int = 512
                             ) -> int:
    """InceptionResnetV1 at facenet-pytorch's widths."""
    macs = 0
    s = size

    def conv(cin, cout, kh, kw, s_in, stride=1, ph=0, pw=0):
        oh = (s_in + 2 * ph - kh) // stride + 1
        ow = (s_in + 2 * pw - kw) // stride + 1
        return conv_macs(cin, cout, kh, kw, oh, ow), oh

    for cin, cout, k, stride, pad in ((3, 32, 3, 2, 0), (32, 32, 3, 1, 0), (32, 64, 3, 1, 1)):
        m, s = conv(cin, cout, k, k, s, stride, pad, pad)
        macs += m
    s = conv_out(s, 3, 2)  # max pool
    for cin, cout, k, stride in ((64, 80, 1, 1), (80, 192, 3, 1), (192, 256, 3, 2)):
        m, s = conv(cin, cout, k, k, s, stride)
        macs += m
    # Block35 at 256 channels
    b35 = (conv_macs(256, 32, 1, 1, s, s) * 3 + conv_macs(32, 32, 3, 3, s, s) * 3
           + conv_macs(96, 256, 1, 1, s, s))
    macs += repeats[0] * b35
    # Mixed_6a
    o = conv_out(s, 3, 2)
    macs += (conv_macs(256, 384, 3, 3, o, o) + conv_macs(256, 192, 1, 1, s, s)
             + conv_macs(192, 192, 3, 3, s, s) + conv_macs(192, 256, 3, 3, o, o))
    s = o
    b17 = (conv_macs(896, 128, 1, 1, s, s) * 2 + conv_macs(128, 128, 1, 7, s, s)
           + conv_macs(128, 128, 7, 1, s, s) + conv_macs(256, 896, 1, 1, s, s))
    macs += repeats[1] * b17
    # Mixed_7a
    o = conv_out(s, 3, 2)
    macs += (conv_macs(896, 256, 1, 1, s, s) * 3 + conv_macs(256, 384, 3, 3, o, o)
             + conv_macs(256, 256, 3, 3, o, o) + conv_macs(256, 256, 3, 3, s, s)
             + conv_macs(256, 256, 3, 3, o, o))
    s = o
    b8 = (conv_macs(1792, 192, 1, 1, s, s) * 2 + conv_macs(192, 192, 1, 3, s, s)
          + conv_macs(192, 192, 3, 1, s, s) + conv_macs(384, 1792, 1, 1, s, s))
    macs += (repeats[2] + 1) * b8
    return macs + 1792 * embedding_dim


# ---------------------------------------------------------------- MTCNN
def pnet_macs(h: int, w: int) -> int:
    """P-Net, fully convolutional over an h x w level."""
    h1, w1 = conv_out(h, 3), conv_out(w, 3)
    macs = conv_macs(3, 10, 3, 3, h1, w1)
    h2, w2 = math.ceil((h1 - 2) / 2) + 1, math.ceil((w1 - 2) / 2) + 1  # 2 x 2 pool, ceil
    h3, w3 = conv_out(h2, 3), conv_out(w2, 3)
    macs += conv_macs(10, 16, 3, 3, h3, w3)
    h4, w4 = conv_out(h3, 3), conv_out(w3, 3)
    return macs + conv_macs(16, 32, 3, 3, h4, w4) + conv_macs(32, 6, 1, 1, h4, w4)


RNET_MACS = (conv_macs(3, 28, 3, 3, 22, 22) + conv_macs(28, 48, 3, 3, 9, 9)
             + conv_macs(48, 64, 2, 2, 3, 3) + 576 * 128 + 128 * 6)
ONET_MACS = (conv_macs(3, 32, 3, 3, 46, 46) + conv_macs(32, 64, 3, 3, 21, 21)
             + conv_macs(64, 64, 3, 3, 8, 8) + conv_macs(64, 128, 2, 2, 3, 3)
             + 1152 * 256 + 256 * 16)


def pyramid(h: int, w: int, min_face: int, factor: float = 0.709, oversize: int = 1
            ) -> list[tuple[int, int]]:
    """The level sizes of the served pyramid."""
    m = 12.0 / min_face
    side = min(h, w) * m
    scales = []
    while side >= 12.0:
        scales.append(m)
        m *= factor
        side *= factor
    for _ in range(oversize):
        scales.append(m)
        m *= factor
    return [(max(math.ceil(h * s), 12), max(math.ceil(w * s), 12)) for s in scales]


def mtcnn_macs(det: dict) -> int:
    """The three nets for one frame: P-Net over every level, R-Net on the
    ``k_rnet`` proposals, O-Net on the R-Net survivors plus 4 large-face
    slots."""
    h, w = det["frame_hw"]
    macs = sum(pnet_macs(lh, lw) for lh, lw in pyramid(h, w, det["min_face_size"]))
    rnet_keep = min(2 * det["max_faces"], max(det["k_rnet"], det["max_faces"]))
    return macs + det["k_rnet"] * RNET_MACS + (rnet_keep + 4) * ONET_MACS


def serve_flops(config: dict, batch: int, enrolled: int, embedder_macs: int) -> int:
    """FLOPs one serve batch needs: MTCNN on every frame, the embedder on
    every slot (``embedder_macs`` a crop, its kind's count), the gallery
    product of every slot against the enrolled rows."""
    det, emb = config["detector"], config["embedder"]
    slots = batch * det["max_faces"]
    macs = (batch * mtcnn_macs(det) + slots * embedder_macs
            + slots * enrolled * emb["embedding_dim"])
    return 2 * macs


# --------------------------------------------------------------- kernels
def k1_ops(queries: int, rows: int, dim: int) -> int:
    """The gallery top-k kernel's products: 2 Q N D."""
    return 2 * queries * rows * dim


def k1_bound_s(queries: int, rows: int, dim: int, k: int, row_bytes: int = 2) -> float:
    """Least time of one top-k launch: the larger of its products at the
    bf16 peak and its bytes (rows read once, f32 queries, k f32 scores and
    int32 indices a query) at the HBM peak."""
    nbytes = rows * dim * row_bytes + queries * dim * 4 + queries * k * 8
    return max(k1_ops(queries, rows, dim) / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


def k2_bound_s(patches: int, patch: int, crop: int, channels: int = 3) -> float:
    """Least time of one rotation launch: bf16 patches read once and bf16
    crops written once, plus 4 f32 shear parameters a patch, at the HBM
    peak; or its interpolation, two taps (2 multiply-adds) an output value
    of each shear (the y shear over the patch, the x shear over the crop),
    at the f32 peak."""
    nbytes = patches * (channels * 2 * (patch * patch + crop * crop) + 4 * 4)
    ops = patches * channels * 4 * (patch * patch + crop * crop)
    return max(nbytes / PEAK_HBM_BYTES, ops / PEAK_F32_FLOPS)


def align_patch(crop: int, pad: float = 0.15) -> int:
    """The padded patch the align resamples before its rotation."""
    return int(round(crop * (1 + 2 * pad) / 8)) * 8
