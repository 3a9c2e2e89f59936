"""The benchmark's own counts against hand counts and published ones."""

from __future__ import annotations

import pytest
import torch

from perfbench import embedders, flops
from perfbench.reference import facenet, mtcnn, resnet
from perfbench.reference.precision import Precision


class Counting(Precision):
    """f32, counting the multiply-adds of every product and convolution."""

    def __init__(self):
        super().__init__("f32")
        self.macs = 0

    def conv2d(self, x, w, b=None, stride=1, padding=0):
        y = super().conv2d(x, w, b, stride, padding)
        self.macs += y.numel() // y.shape[0] * w[0].numel()
        return y

    def linear(self, x, w, b=None):
        self.macs += w.numel()
        return super().linear(x, w, b)

    def matmul(self, a, b):
        self.macs += a.shape[-1] * b.shape[-1] * (a.numel() // a.shape[-1]) // a.shape[0]
        return super().matmul(a, b)


def _zeros(shapes):
    return {k: torch.zeros(s) if k.endswith("var") is False else torch.ones(s)
            for k, s in shapes.items()}


def test_resnet18_matches_torchvision_published_count():
    # torchvision's ResNet-18 at 224 px with its 1,000-way classifier: 1.814 GMACs
    assert flops.resnet18_macs(224, 64, fc_out=1000) == pytest.approx(1.814e9, rel=0.01)


@pytest.mark.parametrize("size", [64, 160])
def test_resnet18_count_matches_the_reference_forward(size):
    p = Counting()
    resnet.embed(p, _zeros(resnet.param_shapes()), torch.zeros(1, size, size, 3))
    assert flops.resnet18_macs(size, 64, embedding_dim=512) == p.macs


def test_inception_resnet_v1_count_matches_the_reference_forward():
    p = Counting()
    facenet.embed(p, _zeros(facenet.param_shapes()), torch.zeros(1, 160, 160, 3))
    assert flops.inception_resnet_v1_macs(160) == p.macs


@pytest.mark.parametrize("hw", [(144, 192), (13, 18), (12, 13)])
def test_pnet_count_matches_the_reference_forward(hw):
    shapes = {"conv1": (3, 3, 3, 10), "conv2": (3, 3, 10, 16), "conv3": (3, 3, 16, 32),
              "conv4_1": (1, 1, 32, 2), "conv4_2": (1, 1, 32, 4)}
    w = {k: {"kernel": torch.zeros(s), "bias": torch.zeros(s[-1])} for k, s in shapes.items()}
    w.update({f"prelu{i}": {"alpha": torch.zeros(c)} for i, c in ((1, 10), (2, 16), (3, 32))})
    p = Counting()
    mtcnn.pnet(p, w, torch.zeros(1, *hw, 3))
    assert flops.pnet_macs(*hw) == p.macs


def test_k1_operations_are_exactly_2qnd():
    assert flops.k1_ops(384, 1_000_000, 512) == 2 * 384 * 1_000_000 * 512
    # at a million rows the products bound it: 0.3976 ms at 989 TFLOP/s
    assert flops.k1_bound_s(384, 1_000_000, 512, 5) == pytest.approx(
        2 * 384 * 1_000_000 * 512 / 989e12)


def test_k2_bound_counts_patches_read_and_crops_written():
    n, p, s = 384, flops.align_patch(160), 160
    assert p == 208
    assert flops.k2_bound_s(n, p, s) == pytest.approx(
        n * (3 * 2 * (p * p + s * s) + 16) / 3.35e12)


def test_serve_flops_adds_the_three_parts():
    det = {"frame_hw": (480, 640), "min_face_size": 40, "max_faces": 8, "k_pnet": 64,
           "k_rnet": 32}
    emb = {"kind": "arcface_resnet18", "crop": 160, "width": 64, "embedding_dim": 512}
    f = flops.serve_flops({"detector": det, "embedder": emb}, 48, 1_000_000,
                          embedders.get(emb["kind"]).macs(emb))
    assert f == 2 * (48 * flops.mtcnn_macs(det) + 384 * flops.resnet18_macs(160, 64, 0, 512)
                     + 384 * 1_000_000 * 512)
    assert flops.pyramid(480, 640, 40)[0] == (144, 192)
