"""The data-parallel BatchNorm of the port (``models/resnet.py``) on the CPU:
its dispatch takes the plain version on CPU tensors (the native fused
kernels it launches on the card, ``torch.batch_norm_stats`` and the rest,
have no CPU kernel), and the plain version's gradients hold against an f64
BatchNorm. The native function is held against the plain one on
the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""

import numpy as np
import pytest
import torch

from facerec_torch.config import MeshConfig
from facerec_torch.models import resnet
from facerec_torch.models.resnet import BatchNorm, global_batch_norm, global_batch_norm_plain
from facerec_torch.parallel.mesh import build_mesh

EPS = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _one_rank():
    return build_mesh(MeshConfig(data_parallel=1), world_size=1, rank=0, device="cpu")


def _inputs(shape, seed: int, offset: float = 0.0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 2.0 + offset).astype(np.float32)
    c = shape[1]
    w = rng.uniform(0.5, 1.5, c).astype(np.float32)
    b = rng.uniform(-0.5, 0.5, c).astype(np.float32)
    up = rng.standard_normal(shape).astype(np.float32)
    return x, w, b, up


@pytest.mark.parametrize("shape", [(8, 6), (4, 6, 5, 5)])
def test_batchnorm_dispatch_takes_the_plain_version_on_the_cpu(monkeypatch, shape):
    """A train-mode ``BatchNorm`` inside a data-parallel region sends a CPU
    tensor to ``global_batch_norm_plain``, never to the native function; its
    output equals the plain version's and its running statistics move by
    Flax's momentum from the plain biased variance."""
    mesh = _one_rank()
    calls = []

    def plain(*args):
        calls.append(args[0].shape)
        return global_batch_norm_plain(*args)

    def native(*args):
        raise AssertionError("the native BatchNorm ran on a CPU tensor")

    monkeypatch.setattr(resnet, "sharded_data_mesh", lambda: mesh)
    monkeypatch.setattr(resnet, "global_batch_norm_plain", plain)
    monkeypatch.setattr(resnet._GlobalBatchNorm, "apply", native)
    x, w, b, _ = _inputs(shape, 0)
    bn = BatchNorm(shape[1], eps=EPS)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(w))
        bn.bias.copy_(torch.from_numpy(b))
    xt = torch.from_numpy(x)
    if xt.ndim == 4:
        xt = xt.contiguous(memory_format=torch.channels_last)
    y = bn(xt)
    assert calls == [xt.shape]
    ref, mean, var = global_batch_norm_plain(xt, bn.weight, bn.bias, EPS, mesh)
    assert torch.equal(y, ref)
    torch.testing.assert_close(bn.running_mean, 0.1 * mean, rtol=0, atol=1e-7)
    torch.testing.assert_close(bn.running_var, 0.9 + 0.1 * var, rtol=0, atol=1e-6)
    with pytest.raises(Exception):  # no CPU kernel: why the CPU takes the plain version
        torch.batch_norm_stats(xt, EPS)
    out = global_batch_norm(xt, bn.weight, bn.bias, EPS, mesh)
    assert torch.equal(out[0], ref)


def _batch_norm_f64(x, w, b):
    """Train-mode BatchNorm over dim 1 in f64: the biased variance about the
    batch mean."""
    dims = [0, *range(2, x.ndim)]
    shape = [1, -1] + [1] * (x.ndim - 2)
    mean = x.mean(dims, keepdim=True)
    var = ((x - mean) ** 2).mean(dims, keepdim=True)
    return (x - mean) / torch.sqrt(var + EPS) * w.view(shape) + b.view(shape)


@pytest.mark.parametrize("offset", [0.0, 100.0])
@pytest.mark.parametrize("shape", [(16, 4), (6, 4, 3, 3)])
def test_plain_global_batch_norm_gradients_match_f64(shape, offset):
    """The plain version's output and its input, weight and bias gradients
    (f32) against an f64 BatchNorm on the same inputs, at a narrow width (4
    channels), also about a mean of 100, where a one-pass variance would
    cancel: within 2e-5 of each tensor's largest magnitude (the f32
    rounding of the inputs about their mean and of sums over at most 54
    values)."""
    mesh = _one_rank()
    x, w, b, up = _inputs(shape, 1, offset)
    out = []
    for dt, fn in ((torch.float32, lambda *a: global_batch_norm_plain(*a, EPS, mesh)[0]),
                   (torch.float64, _batch_norm_f64)):
        xt, wt, bt = (torch.from_numpy(a).to(dt).requires_grad_(True) for a in (x, w, b))
        y = fn(xt, wt, bt)
        assert y.dtype == dt
        (y * torch.from_numpy(up).to(dt)).sum().backward()
        out.append([t.double() for t in (y.detach(), xt.grad, wt.grad, bt.grad)])
    for name, got, ref in zip(("y", "dx", "dw", "db"), *out):
        scale = ref.abs().max().item()
        err = (got - ref).abs().max().item()
        assert err <= 2e-5 * scale, f"{name}: {err} against {scale}"


def test_f64_arcface_step_computes_in_f64():
    """The f64 truth of chip_smoke's ``batchnorm_isolation``: an f64 copy of
    a narrow ArcFace and its loss compute in f64 throughout, forward and
    backward. Only the dropout's uniform draw and the margin schedule's
    scalars (the same f32 constants in every dtype) are not f64."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    from facerec_torch.models import get_criterion
    from facerec_torch.models.arcface import ArcFaceNet
    from facerec_torch.train.steps import _forward

    class NotF64(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.found = set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in tree_leaves(out):
                if (isinstance(t, torch.Tensor) and t.is_floating_point()
                        and t.dtype != torch.float64 and t.ndim > 0
                        and func is not torch.ops.aten.rand.generator):
                    self.found.add(str(func))
            return out

    torch.manual_seed(0)
    model = ArcFaceNet(embedding_dim=16, width=4, num_classes=5).double().train()
    rng = np.random.default_rng(0)
    batch = {"image": torch.from_numpy(rng.uniform(0, 255, (4, 32, 32, 3))),
             "label": torch.tensor([0, 1, 2, 3])}
    mode = NotF64()
    with mode:
        loss = get_criterion("arcface")(
            _forward(model, "arcface", batch, 0.0, torch.Generator().manual_seed(0)), batch)
        grads = torch.autograd.grad(loss, list(model.parameters()))
    assert mode.found == set()
    assert loss.dtype == torch.float64
    assert all(g.dtype == torch.float64 for g in grads)
