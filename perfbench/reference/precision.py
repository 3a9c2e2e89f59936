"""The precision the reference computes in.

``f32`` is the reference: plain f32, TF32 off. ``fp8`` is the control, the
step below the bf16 the configurations state: every operand of a matrix
product or a convolution is rounded to float8 e4m3 with one scale per
tensor (its largest magnitude mapped to 448, e4m3's largest value), the
product then taken in f32, as an fp8 GEMM with per-tensor scales and f32
accumulation computes it. In a backward pass the same holds for the
products of the gradients: the gradient arriving at a product's output is
rounded alike before it meets the rounded operands. The training reference
also holds its activations between layers, and their gradients, in the
lower type (``act``), as a mixed-precision step holds them in its compute
type. Arithmetic inside a layer stays f32 in both."""

from __future__ import annotations

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


def no_tf32() -> None:
    """Full f32 matrix products and convolutions on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _fp8(x: torch.Tensor) -> torch.Tensor:
    scale = torch.clamp(x.abs().amax(), min=1e-30) / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class _Round(torch.autograd.Function):
    """fp8 forward; the gradient passes unchanged (a straight-through
    estimate)."""

    @staticmethod
    def forward(ctx, x):
        return _fp8(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _RoundGrad(torch.autograd.Function):
    """Identity forward; the gradient rounded to fp8."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g)


class _RoundBoth(torch.autograd.Function):
    """fp8 forward and fp8 gradient: a tensor stored in fp8 both ways."""

    @staticmethod
    def forward(ctx, x):
        return _fp8(x)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g)


class Precision:
    def __init__(self, name: str = "f32"):
        if name not in ("f32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def q(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` as this precision holds it, in f32."""
        x = x.float()
        return x if self.name == "f32" else _Round.apply(x)

    def out(self, y: torch.Tensor) -> torch.Tensor:
        """A product's output, whose gradient this precision rounds."""
        return y if self.name == "f32" or not y.requires_grad else _RoundGrad.apply(y)

    def act(self, x: torch.Tensor) -> torch.Tensor:
        """An activation between layers, held in this precision, its
        gradient too (the training reference's; a mixed-precision step
        keeps its activations in the compute type)."""
        return x if self.name == "f32" else _RoundBoth.apply(x.float())

    def matmul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.out(torch.matmul(self.q(a), self.q(b)))

    def conv2d(self, x, w, b=None, stride=1, padding=0) -> torch.Tensor:
        y = self.out(F.conv2d(self.q(x), self.q(w), None, stride, padding))
        return y if b is None else y + b.float().view(1, -1, 1, 1)

    def linear(self, x, w, b=None) -> torch.Tensor:
        """``x @ w.T + b`` with a torch-layout [out, in] weight."""
        y = self.out(torch.matmul(self.q(x), self.q(w).T))
        return y if b is None else y + b.float()
