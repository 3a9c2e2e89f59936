"""The port's detector trainer (``facerec_torch/detect/train.py``), scene
renderer and detector weight saving against the JAX package's on the CPU.

JAX's photo renderer draws the hair style with ``hash()``, the port's with
crc32; the ``crc32_hash`` fixture gives the JAX module a module-level
``hash`` that computes the port's draw, so one seed renders and mines the
same scenes bit for bit. Training is f32 on both sides: per-step losses
within 1e-5 relative, parameters within 1e-5 relative per tensor (the
2-norm of the difference over the 2-norm of the tensor). Element by
element, Adam's first steps divide each gradient by its own magnitude, so
the rounding of a gradient near Adam's eps (1e-8) moves its parameter by a
visible share of the learning rate; the per-tensor norm is the bar that
stays meaningful there."""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import facerec_tpu.data.synthetic as jax_synthetic
from facerec_torch.convert import from_jax, to_jax
from facerec_torch.data.synthetic import render_scene
from facerec_torch.detect import train as tt
from facerec_torch.detect.mtcnn import MTCNN, ONet, PNet, RNet, init_like_flax
from facerec_torch.detect.weights import (
    flatten_tree, load_detector_params_with_source, save_detector_params, thresholds_for_source,
)
from facerec_tpu.detect import mtcnn as jm
from facerec_tpu.detect import train as jt
from facerec_tpu.detect import weights as jw

NETS = {"pnet": (PNet, jm.PNet, 12, False), "rnet": (RNet, jm.RNet, 24, False),
        "onet": (ONet, jm.ONet, 48, True)}
RTOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def crc32_hash(monkeypatch):
    monkeypatch.setattr(jax_synthetic, "hash", lambda s: zlib.crc32(s.encode()), raising=False)


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)


def jax_init(which: str, seed: int) -> dict:
    _, jnet, size, _ = NETS[which]
    return _np_tree(jnet().init(jax.random.key(seed), jnp.zeros((1, size, size, 3)))["params"])


def assert_trees_close(got: dict, ref: dict, rtol: float = RTOL) -> None:
    g, r = flatten_tree(got), flatten_tree(ref)
    assert sorted(g) == sorted(r)
    for k in r:
        assert g[k].shape == r[k].shape, k
        err = np.linalg.norm((g[k] - r[k]).ravel()) / max(np.linalg.norm(r[k].ravel()), 1e-12)
        assert err <= rtol, (k, err)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("style", ["mix", "photo", "flat"])
def test_render_scene_matches_jax(crc32_hash, seed, style):
    for canvas, fr in ((96, (32, 72)), (128, (32, 160))):
        ref = jax_synthetic.render_scene(np.random.default_rng(seed), canvas=canvas,
                                         face_size_range=fr, style=style)
        got = render_scene(np.random.default_rng(seed), canvas=canvas, face_size_range=fr,
                           style=style)
        for a, b in zip(got, ref):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("size", [12, 24, 48])
@pytest.mark.parametrize("landmarks", [False, True], ids=["nolmk", "lmk"])
def test_make_training_samples_matches_jax(crc32_hash, size, landmarks):
    ref = jt.make_training_samples(8, size, seed=size, with_landmarks=landmarks)
    got = tt.make_training_samples(8, size, seed=size, with_landmarks=landmarks)
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_make_training_samples_finetune_mix_matches_jax(crc32_hash):
    """finetune_refiners' sample mix (close-ups, more and larger sub-part
    negatives)."""
    sk = {"closeup_p": 0.5, "subpart_n": 4, "subpart_scale": (0.2, 0.55), "subpart_jitter": 0.35}
    ref = jt.make_training_samples(6, 24, seed=10, **sk)
    got = tt.make_training_samples(6, 24, seed=10, **sk)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_mining_helpers_match_jax():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (64, 80, 3), dtype=np.uint8)
    for box in ([10, 12, 40, 50], [-8, -5, 30, 33], [50, 40, 95, 80], [3.4, 7.6, 3.9, 8.1]):
        box = np.asarray(box, np.float64)
        np.testing.assert_array_equal(tt._crop(img, box, 24), jt._crop(img, box, 24))
        assert tt._iou(box, np.asarray([5, 5, 45, 45.0])) == jt._iou(box, np.asarray([5, 5, 45, 45.0]))
    for seed in range(6):
        patch = tt._crop(img, np.asarray([5, 5, 53, 53.0]), 48)
        np.testing.assert_array_equal(tt._augment_crop(patch, np.random.default_rng(seed)),
                                      jt._augment_crop(patch, np.random.default_rng(seed)))


def _loss_inputs(which: str, seed: int = 0):
    rng = np.random.default_rng(seed)
    n = 16
    shape = (n, 1, 1) if which == "pnet" else (n,)
    out = [rng.uniform(0, 1, shape).astype(np.float32),
           rng.normal(0, 0.3, (*shape, 4)).astype(np.float32)]
    batch = {"cls_label": rng.integers(0, 2, n).astype(np.int32),
             "cls_mask": (rng.uniform(size=n) < 0.7).astype(np.float32),
             "reg_target": rng.normal(0, 0.2, (n, 4)).astype(np.float32),
             "reg_mask": (rng.uniform(size=n) < 0.6).astype(np.float32)}
    out[0].reshape(n)[:2] = [0.0, 1.0]  # the clip at eps
    if which == "onet":
        out.append(rng.normal(0.5, 0.2, (n, 10)).astype(np.float32))
        batch["lmk_target"] = rng.normal(0.5, 0.2, (n, 10)).astype(np.float32)
        batch["lmk_mask"] = (rng.uniform(size=n) < 0.5).astype(np.float32)
    return out, batch


@pytest.mark.parametrize("which", ["pnet", "rnet", "onet"])
def test_net_loss_matches_jax(which):
    out, batch = _loss_inputs(which)
    lm = which == "onet"
    ref = jt._net_loss(tuple(jnp.asarray(o) for o in out),
                       {k: jnp.asarray(v) for k, v in batch.items()}, lm)
    got = tt._net_loss(tuple(torch.from_numpy(o) for o in out),
                       {k: torch.from_numpy(v) for k, v in batch.items()}, lm)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(float(g), float(r), rtol=1e-6, atol=1e-6)


def test_cosine_lr_matches_optax():
    sched = optax.cosine_decay_schedule(1e-3, 120, alpha=0.1)
    for count in (0, 1, 2, 59, 60, 119, 120, 200):
        assert tt.cosine_lr(1e-3, 120, count) == float(sched(count))


def jax_train_steps(which: str, n_scenes: int, steps: int, batch_size: int, seed: int,
                    init_params: dict):
    """JAX's ``train_net`` loop (train.py:311-345) with its per-step losses
    returned; its final parameters are held equal to ``train_net``'s."""
    _, jnet, size, lm = NETS[which]
    net = jnet()
    data = jt.make_training_samples(n_scenes, size, seed, lm)
    n = len(data["image"])
    tx = optax.adam(optax.cosine_decay_schedule(1e-3, steps, alpha=0.1))
    params = jax.tree_util.tree_map(jnp.asarray, init_params)
    opt_state = tx.init(params)

    @jax.jit
    def step(params, opt_state, data_dev, idx):
        batch = {k: v[idx] for k, v in data_dev.items()}

        def loss_fn(p):
            return jt._net_loss(net.apply({"params": p}, batch["image"]), batch, lm)

        (loss, cls), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state2 = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state2, loss, cls

    rng = np.random.default_rng(seed)
    data_dev = jax.device_put(data)
    losses = []
    for _ in range(steps):
        params, opt_state, loss, cls = step(params, opt_state, data_dev,
                                            jnp.asarray(rng.integers(0, n, batch_size)))
        losses.append((float(loss), float(cls)))
    return _np_tree(params), np.asarray(losses)


@pytest.mark.parametrize("which", ["pnet", "rnet", "onet"])
def test_train_net_matches_jax(crc32_hash, which):
    """3 f32 steps from JAX's initial parameters carried across."""
    tnet, jnet, size, lm = NETS[which]
    seed = {"pnet": 0, "rnet": 1, "onet": 2}[which]
    init = jax_init(which, seed)
    ref = _np_tree(jt.train_net(jnet(), size, 8, 3, batch_size=64, seed=seed,
                                with_landmarks=lm, init_params=init))
    ref_loop, ref_losses = jax_train_steps(which, 8, 3, 64, seed, init)
    assert_trees_close(ref_loop, ref, rtol=0.0)  # the replica is JAX's train_net
    stats = {}
    got = tt.train_net(tnet(), size, 8, 3, batch_size=64, seed=seed, with_landmarks=lm,
                       init_params=init, device="cpu", stats=stats)
    assert_trees_close(got, ref)
    np.testing.assert_allclose(stats["losses"], ref_losses[:, 0], rtol=RTOL)
    np.testing.assert_allclose(stats["cls"], ref_losses[:, 1], rtol=RTOL)
    assert stats["samples"] == len(jt.make_training_samples(8, size, seed, lm)["image"])
    assert stats["mining_s"] > 0 and stats["step_ms"] > 0


@pytest.mark.parametrize("which", ["pnet", "rnet", "onet"])
def test_init_like_flax(which):
    """The Flax initialiser's law: truncated LeCun-normal kernels (variance
    1/fan_in, within 2 deviations), zero biases, PReLU 0.25, the same keys
    and shapes as a JAX init; one seed, one draw."""
    tnet = NETS[which][0]
    a = to_jax(init_like_flax(tnet(), torch.Generator().manual_seed(3)).state_dict(), which)
    b = to_jax(init_like_flax(tnet(), torch.Generator().manual_seed(3)).state_dict(), which)
    ref = jax_init(which, 3)
    fa, fr = flatten_tree(a), flatten_tree(ref)
    assert {k: v.shape for k, v in fa.items()} == {k: v.shape for k, v in fr.items()}
    for k, v in fa.items():
        np.testing.assert_array_equal(v, flatten_tree(b)[k])
        if k.endswith("bias"):
            assert not v.any()
        elif k.endswith("alpha"):
            assert (v == 0.25).all()
        else:
            fan_in = int(np.prod(v.shape[:-1]))
            std = fan_in ** -0.5
            assert np.abs(v).max() <= 2 * std / 0.87962566 + 1e-6
            if v.size >= 1000:
                assert abs(v.std() / std - 1) < 0.1, (k, v.std(), std)
                assert abs(fr[k].std() / std - 1) < 0.1


@pytest.mark.parametrize("which", ["pnet", "rnet", "onet"])
def test_to_jax_inverts_from_jax(which):
    ref = jax_init(which, 5)
    back = to_jax(from_jax(ref, which), which)
    fa, fr = flatten_tree(back), flatten_tree(ref)
    assert sorted(fa) == sorted(fr)
    for k in fr:
        np.testing.assert_array_equal(fa[k], fr[k])


@pytest.mark.parametrize("source", ["self-trained", "pretrained"])
def test_npz_files_load_across_packages(tmp_path, source):
    """The port's files load in JAX and JAX's in the port, with the
    ``source.txt`` marker honoured and the extension fallback without it
    (the counterpart of tests/test_detector.py::test_weight_provenance_
    marker)."""
    params = {w: jax_init(w, i) for i, w in enumerate(("pnet", "rnet", "onet"))}
    d = save_detector_params(params, tmp_path / "port", source=source)
    loaded, src = jw.load_detector_params_with_source(d)
    assert src == source and jw.thresholds_for_source(src) == thresholds_for_source(source)
    for w in params:
        assert_trees_close(_np_tree(loaded[w]), params[w], rtol=0.0)
    dj = jw.save_detector_params(params, tmp_path / "jax", source=source)
    mine, src = load_detector_params_with_source(dj)
    assert src == source
    for w in params:
        assert_trees_close(_np_tree(mine[w]), params[w], rtol=0.0)
    for name in ("pnet", "rnet", "onet"):
        with np.load(d / f"{name}.npz") as a, np.load(dj / f"{name}.npz") as b:
            assert sorted(a.files) == sorted(b.files)
    (d / "source.txt").unlink()
    assert load_detector_params_with_source(d)[1] == "self-trained"
    # a detector loads the port's saved trees
    det = MTCNN((64, 64), min_face_size=40, max_faces=4, k_pnet=8, k_rnet=8,
                device="cpu").load_jax_params(load_detector_params_with_source(d)[0])
    assert torch.equal(det.pnet.conv1.weight, from_jax(params["pnet"], "pnet")["conv1.weight"])


@pytest.mark.parametrize("kind", ["refiners", "pnet"])
def test_finetune_matches_jax(crc32_hash, tmp_path, monkeypatch, kind):
    """finetune_refiners keeps P-Net bit for bit and moves the refiners;
    finetune_pnet the other way round; both as JAX's from the same base
    weights (tests/test_detector.py::test_finetune_refiners_smoke)."""
    base = {w: jax_init(w, 3 + i) for i, w in enumerate(("pnet", "rnet", "onet"))}
    monkeypatch.setattr("facerec_tpu.detect.weights.load_detector_params", lambda *a, **k: base)
    monkeypatch.setattr("facerec_torch.detect.weights.load_detector_params", lambda *a, **k: base)
    if kind == "refiners":
        ref_dir = jt.finetune_refiners(tmp_path / "jax", n_scenes=6, steps=2, seed=5)
        out = tt.finetune_refiners(tmp_path / "port", n_scenes=6, steps=2, seed=5, device="cpu")
        kept, moved = ["pnet"], ["rnet", "onet"]
    else:
        ref_dir = jt.finetune_pnet(tmp_path / "jax", n_scenes=6, steps=2, seed=5)
        out = tt.finetune_pnet(tmp_path / "port", n_scenes=6, steps=2, seed=5, device="cpu")
        kept, moved = ["rnet", "onet"], ["pnet"]
    params, source = load_detector_params_with_source(out)
    ref, _ = load_detector_params_with_source(ref_dir)
    assert source == "self-trained"
    for w in kept:
        assert_trees_close(params[w], base[w], rtol=0.0)
    for w in moved:
        assert not np.array_equal(params[w]["conv1"]["kernel"], base[w]["conv1"]["kernel"])
        assert_trees_close(params[w], ref[w])


def test_main_parses_modes(monkeypatch, tmp_path):
    calls = []
    monkeypatch.setattr(tt, "train_detector", lambda out, device: calls.append(("t", out, device)))
    monkeypatch.setattr(tt, "finetune_refiners", lambda out, device: calls.append(("f", out, device)))
    monkeypatch.setattr(tt, "finetune_pnet", lambda out, device: calls.append(("p", out, device)))
    assert tt.main(["--device", "cpu"]) == 0
    assert tt.main(["finetune", str(tmp_path)]) == 0
    assert tt.main(["finetune-pnet", "--device", "cpu"]) == 0
    assert calls == [("t", tt.DEFAULT_DIR, "cpu"), ("f", str(tmp_path), "cuda"),
                     ("p", "outputs/detector_candidate_p", "cpu")]


@pytest.mark.slow
def test_detector_trains_and_detects():
    """tests/test_detector.py::test_detector_trains_and_detects on the
    port, on the CPU: the same three trainings (JAX's initial weights for
    seeds 0, 1 and 2 carried across, the same samples and batches) and the
    same bars. The bars sit low in this configuration's spread (mean IoU
    0.40-0.56 over draws of initial weights and scenes, in both packages),
    so the port's own seeded draw is held on the card by chip_smoke.py's
    detector phase instead."""
    params = {"pnet": tt.train_net(PNet(), 12, 150, 120, seed=0, device="cpu",
                                   init_params=jax_init("pnet", 0)),
              "rnet": tt.train_net(RNet(), 24, 150, 120, seed=1, device="cpu",
                                   init_params=jax_init("rnet", 1)),
              "onet": tt.train_net(ONet(), 48, 150, 120, seed=2, with_landmarks=True,
                                   device="cpu", init_params=jax_init("onet", 2))}
    det = MTCNN((96, 96), min_face_size=24, thresholds=(0.6, 0.7, 0.7), max_faces=4,
                k_pnet=32, k_rnet=16, device="cpu").load_jax_params(params)
    rng = np.random.default_rng(77)
    scenes, boxes = [], []
    for _ in range(16):
        img, box, _ = render_scene(rng, canvas=96, face_size_range=(32, 72))
        scenes.append(img)
        boxes.append(box)
    out = det.detect(torch.from_numpy(np.stack(scenes)).float())
    found, ious = 0, []
    for i in range(16):
        v = out.valid[i].numpy()
        if not v.any():
            continue
        found += 1
        bi = int(np.argmax(out.probs[i].numpy() * v))
        ious.append(tt._iou(out.boxes[i, bi].numpy(), boxes[i]))
    assert found >= 10, f"only detected {found}/16"
    assert np.mean(ious) > 0.4, f"mean IoU {np.mean(ious):.3f}"
