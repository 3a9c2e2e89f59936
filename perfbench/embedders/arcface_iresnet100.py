"""IResNet-100 ArcFace (insightface's ``iresnet100``, the LResNet100E-IR of
Deng et al. 2019) at 64-128-256-512, a 512-d embedding, 112 px crops.
Served only: no training."""

from __future__ import annotations

import torch

from perfbench import flops
from perfbench.reference import iresnet


def shapes(emb: dict) -> dict[str, tuple]:
    return iresnet.param_shapes(tuple(emb["layers"]), emb["embedding_dim"], emb["crop"])


def program(state: dict, emb: dict, device, dtype=torch.bfloat16):
    """The port's served embedder (``build_iresnet_embedder``) with ``state``."""
    from facerec_torch.models.iresnet import build_iresnet_embedder

    return build_iresnet_embedder(state, dtype=dtype, device=device)


def reference(p, state: dict, crops: torch.Tensor) -> torch.Tensor:
    return iresnet.embed(p, state, crops)


def macs(emb: dict) -> int:
    """The stem, every block's two 3 x 3 convs (the first at the block's
    input size, the second strided) and each stage's 1 x 1 shortcut, and
    ``fc``."""
    s = emb["crop"]
    total = flops.conv_macs(3, iresnet.WIDTHS[0], 3, 3, s, s)
    cin = iresnet.WIDTHS[0]
    for n, c in zip(emb["layers"], iresnet.WIDTHS):
        for bi in range(n):
            stride = 2 if bi == 0 else 1
            o = flops.conv_out(s, 3, stride, 1)
            total += flops.conv_macs(cin, c, 3, 3, s, s) + flops.conv_macs(c, c, 3, 3, o, o)
            if bi == 0:
                total += flops.conv_macs(cin, c, 1, 1, o, o)
            s, cin = o, c
    return total + cin * s * s * emb["embedding_dim"]
