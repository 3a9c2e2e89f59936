"""The port's augmentations (``facerec_torch/ops/augment.py``) against the JAX
package's (``facerec_tpu/ops/augment.py``) on the CPU.

The port draws from torch generators, not threefry, so the parity tests feed
``apply_augment`` the draws JAX's ``augment_batch`` makes for a key (the same
split and uniform calls as augment.py:35-65) and compare the images within
1e-5 (f32; the warp's affine and the per-image mean round differently). The
port's own stream is held to determinism, range and gate rates."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facerec_torch.ops.augment import (
    AugmentDraws, AugmentParams, apply_augment, augment_batch, draw_augment, low_data_variants,
)
from facerec_tpu.ops.augment import AugmentParams as JaxAugmentParams
from facerec_tpu.ops.augment import augment_batch as jax_augment_batch
from facerec_tpu.ops.augment import low_data_variants as jax_low_data_variants

ATOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _images(b=4, seed=0):
    return np.random.default_rng(seed).uniform(size=(b, 32, 32, 3)).astype(np.float32)


def jax_draws(key, b: int, p) -> AugmentDraws:
    """The per-image draws ``augment_batch`` makes from ``key``."""
    k_rot, k_scale, _, k_bright, k_contrast, k_prot, k_pflip, k_pcolor = jax.random.split(key, 8)

    def u(k, lo=0.0, hi=1.0):
        return torch.from_numpy(np.array(jax.random.uniform(k, (b,), minval=lo, maxval=hi)))

    return AugmentDraws(
        angle=u(k_rot, -p.rotation_degrees, p.rotation_degrees),
        scale=1.0 + u(k_scale, -p.scale, p.scale),
        geometry=u(k_prot), flip=u(k_pflip), color=u(k_pcolor),
        brightness=u(k_bright, -p.brightness, p.brightness),
        contrast=1.0 + u(k_contrast, -p.contrast, p.contrast))


@pytest.mark.parametrize("seed", [7, 8, 9])
@pytest.mark.parametrize("flip", [True, False], ids=["flip", "noflip"])
def test_apply_augment_matches_jax(seed, flip):
    x = _images(seed=seed)
    jp, tp = JaxAugmentParams(horizontal_flip=flip), AugmentParams(horizontal_flip=flip)
    key = jax.random.key(seed)
    ref = np.asarray(jax_augment_batch(key, jnp.asarray(x), jp))
    got = apply_augment(torch.from_numpy(x), jax_draws(key, 4, jp), tp).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


def test_apply_augment_matches_jax_with_gates_off():
    """p = 0 everywhere: identity geometry, no colour change, as JAX."""
    x = _images(seed=3)
    p = dict(p_geometry=0.0, p_flip=0.0, p_color=0.0)
    key = jax.random.key(3)
    ref = np.asarray(jax_augment_batch(key, jnp.asarray(x), JaxAugmentParams(**p)))
    got = apply_augment(torch.from_numpy(x), jax_draws(key, 4, JaxAugmentParams(**p)),
                        AugmentParams(**p)).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, x, atol=ATOL, rtol=0)


@pytest.mark.parametrize("n", [1, 5])
def test_low_data_variants_matches_jax(n):
    """JAX's variants (geometry and colour forced on) from JAX's draws; the
    port's ``low_data_variants`` is ``apply_augment`` of its own draws with
    the same forcing."""
    img = _images(1, seed=11)[0]
    key = jax.random.key(21)
    ref = np.asarray(jax_low_data_variants(key, jnp.asarray(img), n))
    strong = AugmentParams(p_geometry=1.0, p_color=1.0)
    batch = torch.from_numpy(img)[None].expand(n, *img.shape)
    got = apply_augment(batch, jax_draws(key, n, strong), strong).numpy()
    assert got.shape == ref.shape == (n, 32, 32, 3)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    gen, gen2 = torch.Generator().manual_seed(4), torch.Generator().manual_seed(4)
    mine = low_data_variants(torch.from_numpy(img), n, AugmentParams(), gen)
    assert torch.equal(mine, apply_augment(batch, draw_augment(gen2, n, strong), strong))


def test_augment_batch_deterministic_and_in_range():
    """The counterpart of tests/test_ops.py::test_augment_batch_shapes_and_
    determinism on the port's stream."""
    x = torch.from_numpy(_images())
    p = AugmentParams()
    a = augment_batch(x, p, torch.Generator().manual_seed(7))
    b = augment_batch(x, p, torch.Generator().manual_seed(7))
    c = augment_batch(x, p, torch.Generator().manual_seed(8))
    assert torch.equal(a, b) and not torch.allclose(a, c)
    assert a.shape == x.shape and a.dtype == torch.float32
    assert float(a.min()) >= 0.0 and float(a.max()) <= 1.0
    v = low_data_variants(x[0], 5, p, torch.Generator().manual_seed(7))
    assert v.shape == (5, 32, 32, 3) and float(v.min()) >= 0.0 and float(v.max()) <= 1.0


def test_draws_do_not_depend_on_params_switches():
    """Every draw is taken whatever is switched off, so a flag does not
    shift the stream: flip off changes only the flip, p only the gates."""
    d1 = draw_augment(torch.Generator().manual_seed(1), 16, AugmentParams())
    d2 = draw_augment(torch.Generator().manual_seed(1), 16,
                      AugmentParams(horizontal_flip=False, p_geometry=0.1, p_color=1.0))
    for a, b in zip(d1, d2):
        assert torch.equal(a, b)
    assert all(t.device.type == "cpu" and t.dtype == torch.float32 for t in d1)


@pytest.mark.parametrize("gate,p", [("geometry", 0.7), ("flip", 0.5), ("color", 0.7)])
def test_gate_rates(gate, p):
    """Over 4,096 draws each gate fires at its probability within 3 sigma."""
    n = 4096
    d = draw_augment(torch.Generator().manual_seed(123), n, AugmentParams())
    rate = float((getattr(d, gate) < p).float().mean())
    assert abs(rate - p) <= 3 * np.sqrt(p * (1 - p) / n), rate


def test_draw_ranges():
    p = AugmentParams()
    d = draw_augment(torch.Generator().manual_seed(5), 4096, p)
    assert float(d.angle.abs().max()) <= p.rotation_degrees
    assert float((d.scale - 1).abs().max()) <= p.scale
    assert float(d.brightness.abs().max()) <= p.brightness
    assert float((d.contrast - 1).abs().max()) <= p.contrast
    for g in (d.geometry, d.flip, d.color):
        assert float(g.min()) >= 0.0 and float(g.max()) < 1.0
