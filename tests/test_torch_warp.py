"""Parity of the port's align stage with the JAX package on the CPU
(``facerec_torch.ops.warp_fast`` / ``warp_kernel`` against
``facerec_tpu.ops.warp_fast``), and the rotation kernel's per-line
arithmetic, emulated in PyTorch, against the plain shear chain.

The two frameworks round bf16 at different places (XLA may keep fused
intermediates in f32), so the shear chain agrees within two bf16 ulps at
255 (2.0) at most and far less on average."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import fb8_lines, k2_case, k2_read_mask
from facerec_torch.ops import kernels
from facerec_torch.ops import warp_fast as tw
from facerec_torch.ops.warp_kernel import line_taps, rotate_patches_kernel
from facerec_tpu.ops import warp_fast as jw


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.array(x))


def test_crop_resize_matmul_matches_jax():
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 255, (60, 80, 3)).astype(np.float32)
    boxes = np.array([[5.0, 4.0, 50.0, 44.0], [30.2, 10.7, 79.0, 59.5],
                      [-6.0, -3.0, 20.0, 25.0], [10.0, 10.0, 10.5, 10.2]], np.float32)
    ref = np.asarray(jw.crop_resize_matmul(jnp.asarray(img), jnp.asarray(boxes), 24))
    got = tw.crop_resize_matmul(_t(img), _t(boxes), 24).numpy()
    assert got.shape == ref.shape == (4, 24, 24, 3)
    np.testing.assert_allclose(got, ref, atol=1e-2, rtol=0)
    got_bf = tw.crop_resize_matmul(_t(img), _t(boxes), 24, out_dtype=torch.bfloat16)
    assert got_bf.dtype == torch.bfloat16
    np.testing.assert_array_equal(got_bf.float().numpy(),
                                  torch.from_numpy(got).to(torch.bfloat16).float().numpy())


def _patch_case():
    """The inputs of tests/test_ops.py::test_pallas_rotate_matches_xla_oracle."""
    rng = np.random.default_rng(0)
    n, p = 4, 128
    patches = rng.uniform(0, 255, (n, p, p, 3)).astype(np.float32)
    angles = np.array([0.0, 0.1, -0.2, 0.25], np.float32)
    centers = rng.uniform(p * 0.4, p * 0.6, (n, 2)).astype(np.float32)
    return patches, angles, centers


def test_rotate_patches_matches_jax():
    patches, angles, centers = _patch_case()
    ref = np.asarray(jw.rotate_patches(jnp.asarray(patches), jnp.asarray(angles),
                                       jnp.asarray(centers), 96))
    got = tw.rotate_patches(_t(patches), _t(angles), _t(centers), 96).numpy()
    assert got.shape == ref.shape == (4, 96, 96, 3)
    err = np.abs(got - ref)
    assert err.max() <= 2.0, err.max()
    assert err.mean() < 1e-2, err.mean()


def _rbf(x):
    return x.to(torch.bfloat16).float()


def _emulate_kernel(patches, oy, wy, ox, wx, e):
    """csrc/shear_rotate.cu, written out with tensors: each output pixel is
    two x taps of the y-pass result, each y-pass value two taps of the
    patch, every product and sum rounded to bf16."""
    n, p, _, c = patches.shape
    src = patches.to(torch.bfloat16).float()
    off = (p - e) // 2
    y = torch.arange(off, off + e)[None, :, None]  # [1, E, 1]
    x = torch.arange(off, off + e)[None, None, :]  # [1, 1, E]
    nn_ = torch.arange(n)[:, None, None]

    def patch_at(ys, xs):
        ok = (ys >= 0) & (ys < p) & (xs >= 0) & (xs < p)
        v = src[nn_, ys.clamp(0, p - 1), xs.clamp(0, p - 1)]  # [N, E, E, C]
        return torch.where(ok[..., None], v, 0.0)

    def ypass(xs):
        ok = (xs >= 0) & (xs < p)
        xc = xs.clamp(0, p - 1)
        ys = y + oy[nn_, xc]
        u = wy.float()[nn_, xc]  # [N, E, E, 2]
        t0 = _rbf(u[..., 0:1] * patch_at(ys, xc))
        t1 = _rbf(u[..., 1:2] * patch_at(ys + 1, xc))
        return torch.where(ok[..., None], _rbf(t0 + t1), 0.0)

    o = ox[nn_, y]  # [N, E, 1]
    w = wx.float()[nn_, y]  # [N, E, 1, 2]
    a = _rbf(w[..., 0:1] * ypass(x + o))
    b = _rbf(w[..., 1:2] * ypass(x + o + 1))
    return _rbf(a + b)


def _taps(angles, centers, p):
    """The kernel's per-line taps of both passes, and the count of lines
    whose fine base rounded up to 8 (offset base + 1, weight 0 on the
    second tap)."""
    max_rad = np.radians(15.0)
    phi = torch.clamp(angles, -max_rad, max_rad)
    sy, cy, sx, cx, ky, kx = tw._shear_params(phi, centers, p, max_rad)
    return (line_taps(sy, cy, p, -ky, ky), line_taps(sx, cx, p, -kx, kx),
            fb8_lines(angles, centers, p))


def _angles_centers(case, n, p, rng):
    """Rotation inputs of one edge case (``chip_smoke.k2_case``) from random
    angles about the +-15 degree clamp and centres near the middle."""
    angles = torch.from_numpy(rng.uniform(-0.3, 0.3, n).astype(np.float32))
    centers = torch.from_numpy(rng.uniform(p * 0.3, p * 0.7, (n, 2)).astype(np.float32))
    return k2_case(case, angles, centers, p)


@pytest.mark.parametrize("p,e,case", [
    pytest.param(128, 96, "random", id="128-96"),
    pytest.param(208, 160, "random", id="208-160"),
    *[pytest.param(p, e, case, id=f"{p}-{e}-{case}")
      for p, e in [(128, 96), (208, 160)] for case in ("zero", "tiny", "clamped", "capped")]])
def test_kernel_line_taps_reproduce_plain_shear(p, e, case):
    """The CUDA kernel's reduction of each line to (offset, w0, w1) gives
    the plain one-hot/9-tap chain bit for bit, including angles of 0, lines
    whose fine base rounds up to 8, angles beyond the clamp and centres
    beyond the cap."""
    rng = np.random.default_rng(p)
    n = 6
    patches = torch.from_numpy(rng.uniform(0, 255, (n, p, p, 3)).astype(np.float32))
    angles, centers = _angles_centers(case, n, p, rng)
    (oy, wy), (ox, wx), fb8 = _taps(angles, centers, p)
    assert oy.dtype == torch.int32 and wy.dtype == torch.bfloat16 and wy.shape == (n, p, 2)
    if case == "tiny":
        assert fb8 > 0
    got = _emulate_kernel(patches, oy.long(), wy, ox.long(), wx, e)
    ref = tw.rotate_patches(patches, angles, centers, e).float()
    assert torch.equal(got, ref), (got - ref).abs().max()


def test_kernel_arithmetic_matches_pallas():
    """The kernel's arithmetic against the Pallas kernel it replaces, run in
    interpret mode, within the JAX test's own tolerance
    (tests/test_ops.py::test_pallas_rotate_matches_xla_oracle: last-ulp
    differences, max 1.0 at 0..255)."""
    from facerec_tpu.ops.pallas_warp import rotate_patches_pallas

    patches, angles, centers = _patch_case()
    ref = np.asarray(rotate_patches_pallas(jnp.asarray(patches), jnp.asarray(angles),
                                           jnp.asarray(centers), 96, interpret=True))
    (oy, wy), (ox, wx), _ = _taps(_t(angles), _t(centers), patches.shape[1])
    got = _emulate_kernel(_t(patches), oy.long(), wy, ox.long(), wx, 96).numpy()
    assert got.shape == ref.shape == (4, 96, 96, 3)
    assert np.abs(got - ref.astype(np.float32)).max() <= 1.0


@pytest.mark.parametrize("case", ["random", "zero", "tiny", "clamped", "capped"])
@pytest.mark.parametrize("p,e", [(64, 48), (40, 40)])
def test_read_mask_holds_every_value_the_crop_reads(p, e, case):
    """The patch values ``chip_smoke.k2_read_mask`` leaves out (which the
    kernel's bytes bound does not count) do not change the crop."""
    rng = np.random.default_rng(p + e)
    n = 6
    patches = torch.from_numpy(rng.uniform(0, 255, (n, p, p, 3)).astype(np.float32))
    angles, centers = _angles_centers(case, n, p, rng)
    mask = k2_read_mask(angles, centers, p, e)
    noise = torch.from_numpy(rng.uniform(0, 255, (n, p, p, 3)).astype(np.float32))
    ref = tw.rotate_patches(patches, angles, centers, e)
    got = tw.rotate_patches(torch.where(mask[..., None], patches, noise), angles, centers, e)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("p,e", [(64, 48), (208, 160), (40, 40)])
def test_read_mask_at_angle_zero(p, e):
    """Unrotated, the crop reads its own E + 1 rows and columns (the second
    tap, clipped to the patch)."""
    mask = k2_read_mask(torch.zeros(2), torch.full((2, 2), (p - 1) / 2.0), p, e)
    side = min(e + 1, p)
    assert mask.sum().item() == 2 * side * side


def test_rotate_wrapper_on_cpu_is_plain_version():
    patches, angles, centers = _patch_case()
    before = kernels.launches()
    a = rotate_patches_kernel(_t(patches), _t(angles), _t(centers), 96)
    b = tw.rotate_patches(_t(patches), _t(angles), _t(centers), 96)
    assert kernels.launches() == before
    assert torch.equal(a, b)


def test_rotate_wrapper_on_cpu_empty_batch():
    out = rotate_patches_kernel(torch.zeros(0, 64, 64, 3), torch.zeros(0), torch.zeros(0, 2), 48)
    assert out.shape == (0, 48, 48, 3)


def test_align_batched_matches_jax():
    """The inputs of tests/test_ops.py::test_align_batched_matches_per_frame."""
    rng = np.random.default_rng(2)
    b, f, hw, e = 2, 3, (120, 160), 64
    frames = rng.uniform(0, 255, (b, *hw, 3)).astype(np.float32)
    boxes = np.zeros((b, f, 4), np.float32)
    lmk = np.zeros((b, f, 5, 2), np.float32)
    for i in range(b):
        for j in range(f):
            x1 = rng.uniform(0, 80); y1 = rng.uniform(0, 40); s = rng.uniform(40, 70)
            boxes[i, j] = [x1, y1, x1 + s, y1 + s]
            lmk[i, j] = [[x1 + s * .3, y1 + s * .42], [x1 + s * .7, y1 + s * .38],
                         [x1 + s * .5, y1 + s * .6], [x1 + s * .35, y1 + s * .8],
                         [x1 + s * .65, y1 + s * .8]]
    ref = np.asarray(jw.align_and_crop_fast_batched(
        jnp.asarray(frames), jnp.asarray(boxes), jnp.asarray(lmk), e, use_pallas=False))
    got = tw.align_and_crop_fast_batched(_t(frames), _t(boxes), _t(lmk), e).numpy()
    assert got.shape == ref.shape == (b, f, e, e, 3)
    err = np.abs(got - ref)
    assert err.max() <= 2.0, err.max()
    assert err.mean() < 1e-2, err.mean()
