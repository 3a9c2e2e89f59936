"""The port's siamese path against the JAX package's on the CPU: SiameseNet
at full width (64..512 channels, 1024/512/256 head) in eval and train mode
at the three adaptive-pool cases, the pool alone, one contrastive train
step, ``SiamesePairBatcher``'s batches, ``train_model`` end to end with
resume, and ``evaluate_model``'s verification branch on the same weights."""

import csv
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facerec_torch.config import EvalConfig, OptimizerConfig, SchedulerConfig, TrainConfig
from facerec_torch.convert import from_jax
from facerec_torch.data.datasets import ImageFolderIndex, SiamesePairBatcher
from facerec_torch.data.synthetic import write_synthetic_imagefolder
from facerec_torch.eval.engine import evaluate_model
from facerec_torch.eval.metrics import count_parameters
from facerec_torch.models import get_model
from facerec_torch.models.siamese import _adaptive_avg_pool
from facerec_torch.train.checkpoints import save_checkpoint
from facerec_torch.train.engine import train_model
from facerec_tpu.config import EvalConfig as JaxEvalConfig
from facerec_tpu.data import datasets as jax_datasets
from facerec_tpu.eval.engine import evaluate_model as jax_evaluate_model
from facerec_tpu.eval.metrics import count_parameters as jax_count_parameters
from facerec_tpu.models import get_model as jax_get_model
from facerec_tpu.models.siamese import _adaptive_avg_pool as jax_adaptive_avg_pool
from facerec_tpu.train.checkpoints import save_checkpoint as jax_save_checkpoint

import torch_zoo as Z


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def siamese():
    return Z.jax_variables("siamese")


@pytest.mark.parametrize("size", [64, 96, 160])
def test_eval_forward_and_embed_match_jax(siamese, size):
    """The trunk's map is 4x4 at 64 px (pool bins repeat), 6x6 at 96 px
    (no pooling) and 10x10 at 160 px (bins overlap)."""
    jm, v = siamese
    b = Z.batch("siamese", n=2, size=size, seed=size)
    net = Z.port_model("siamese", v).eval()
    with torch.no_grad():
        ea, eb = net(torch.from_numpy(b["image_a"]), torch.from_numpy(b["image_b"]))
        emb = net.embed(torch.from_numpy(b["image_a"]))
    ra, rb = jm.apply(v, b["image_a"], b["image_b"])
    np.testing.assert_allclose(ea.numpy(), np.asarray(ra), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(eb.numpy(), np.asarray(rb), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(emb.numpy(), np.asarray(jm.apply(v, b["image_a"], method=jm.embed)),
                               atol=1e-4, rtol=1e-4)
    assert np.allclose(np.linalg.norm(ea.numpy(), axis=1), 1.0, atol=1e-5)


@pytest.mark.parametrize("hw", [4, 6, 10, 12, 7])
def test_adaptive_pool_matches_jax(hw):
    """JAX's three branches (equal size, reshape-mean when 6 divides, the
    masked-mean products otherwise) against the port's pool on NCHW."""
    x = np.random.default_rng(hw).normal(size=(2, hw, hw + 1 if hw == 7 else hw, 8))
    x = x.astype(np.float32)
    ref = np.asarray(jax_adaptive_avg_pool(jnp.asarray(x), (6, 6)))
    got = _adaptive_avg_pool(torch.from_numpy(x).permute(0, 3, 1, 2), (6, 6))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref, atol=1e-6, rtol=0)


def test_train_forward_matches_jax(siamese):
    """Training mode: both embeddings and the running statistics, which are
    taken over the 2B images of one pass."""
    jm, v = siamese
    b = Z.batch("siamese", n=4, seed=4)
    (ra, rb), mutated = jax.jit(functools.partial(jm.apply, train=True, mutable=["batch_stats"]))(
        v, jnp.asarray(b["image_a"]), jnp.asarray(b["image_b"]))
    net = Z.port_model("siamese", v).train()
    ea, eb = net(torch.from_numpy(b["image_a"]), torch.from_numpy(b["image_b"]))
    np.testing.assert_allclose(ea.detach().numpy(), np.asarray(ra), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(eb.detach().numpy(), np.asarray(rb), atol=1e-4, rtol=1e-4)
    want = from_jax({"params": v["params"], **Z.np_tree(mutated)}, "siamese")
    sd = net.state_dict()
    for k in [k for k in want if k.endswith(("running_mean", "running_var"))]:
        np.testing.assert_allclose(sd[k].numpy(), want[k].numpy(), atol=1e-4, rtol=1e-4, err_msg=k)
    # two separate passes would take other statistics
    two = Z.port_model("siamese", v).train()
    two.embed(torch.from_numpy(b["image_a"]))
    assert not torch.allclose(two.conv_bn0.running_mean, net.conv_bn0.running_mean, atol=1e-4)


def test_one_train_step_matches_jax(siamese, synthetic_imagefolder):
    """One contrastive SGD step (clip 0.5) on the same pair batch: loss,
    grad_norm, the same/different counts and the parameters after it."""
    jm, v = siamese
    net = Z.port_model("siamese", v)
    b = Z.face_batch("siamese", synthetic_imagefolder)
    jmet, _, tm, after = Z.one_step_each(jm, v, net, "siamese", b)
    assert {"same_correct", "same_count", "diff_correct", "diff_count"} <= set(tm)
    assert float(tm["same_count"] + tm["diff_count"]) == float(tm["count"]) == 8
    Z.assert_step_matches(jmet, tm, after, net)


def test_from_jax_and_counts_match(siamese):
    _, v = siamese
    port = get_model("siamese")
    assert set(from_jax(v, "siamese")) == set(port.state_dict())
    assert count_parameters(port) == jax_count_parameters(v["params"])
    assert port.fc1.in_features == 6 * 6 * 512


@pytest.mark.parametrize("fixed,seed", [(True, 0), (True, 3), (False, 0), (False, 3)])
def test_pair_batches_equal_jax(synthetic_imagefolder, fixed, seed):
    """Fixed and random pairs, two seeds, epochs 0 and 1, batch 5 so that
    the last batch is a padded, masked tail."""
    root = synthetic_imagefolder / "train"
    tb = SiamesePairBatcher(ImageFolderIndex.build(root), 5, 24, fixed_pairs=fixed, seed=seed)
    jb = jax_datasets.SiamesePairBatcher(jax_datasets.ImageFolderIndex.build(root), 5, 24,
                                         fixed_pairs=fixed, seed=seed)
    assert tb.get_image_identities() == jb.get_image_identities()
    for epoch in (0, 1):
        got, ref = list(tb.epoch(epoch)), list(jb.epoch(epoch))
        assert len(got) == len(ref) == len(tb)
        assert got[-1]["mask"].sum() < 5
        for a, b in zip(got, ref):
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    labels = np.concatenate([b["pair_label"][b["mask"] > 0] for b in got])
    assert 0 < labels.mean() < 1  # same and different pairs


def _cfg(**kw):
    """A step LR schedule, which does not depend on the epoch count, so that
    a short run is the head of a long one."""
    base = dict(model_type="siamese", batch_size=8, epochs=2, image_size=32, seed=0,
                early_stopping=False, checkpoint_every=0, compute_dtype="float32",
                optimizer=OptimizerConfig(learning_rate=1e-3),
                scheduler=SchedulerConfig(name="step", step_size=1, gamma=0.5))
    return TrainConfig(**{**base, **kw})


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """3 people x 14 faces: 10/2/2 per person."""
    return write_synthetic_imagefolder(tmp_path_factory.mktemp("siamese_tree"), num_classes=3,
                                       per_class=14, size=32, seed=2)


def test_train_siamese_e2e_and_resume(tree, tmp_path):
    """``train_model`` on a siamese net (the counterpart of
    tests/test_train.py::test_train_siamese_short): the artifact set,
    same/diff accuracies in the history, a 2 x 2 confusion matrix of pair
    labels; then a run stopped after 1 epoch and resumed to 2 ends where an
    uninterrupted 2-epoch run does."""
    straight = train_model(_cfg(checkpoint_every=1), tree, checkpoints_root=tmp_path / "a",
                           model_name="s", device="cpu")
    hist = straight["history"]
    assert len(hist) == 2 and all(np.isfinite(r["train_loss"]) for r in hist)
    assert all(0.0 <= r["same_acc"] <= 1.0 and 0.0 <= r["diff_acc"] <= 1.0 for r in hist)
    model_dir = tmp_path / "a" / "s"
    for rel in ("best/state.pt", "final/state.pt", "metrics/training_metrics.csv",
                "metrics/confusion_matrix.json", "model_info.json"):
        assert (model_dir / rel).exists(), rel
    cm = np.asarray(json.loads((model_dir / "metrics/confusion_matrix.json").read_text())["matrix"])
    assert cm.shape == (2, 2) and cm.sum() == 6 * 2  # one same, one different pair per image
    with (model_dir / "metrics" / "training_metrics.csv").open() as f:
        assert len(list(csv.reader(f))) == 3

    train_model(_cfg(epochs=1, checkpoint_every=1), tree, checkpoints_root=tmp_path / "b",
                model_name="s", device="cpu")
    resumed = train_model(_cfg(checkpoint_every=1, resume=True), tree,
                          checkpoints_root=tmp_path / "b", model_name="s", device="cpu")
    assert resumed["history"][0]["epoch"] == 1
    row_s, row_r = straight["history"][1], resumed["history"][0]
    for key in ("train_loss", "val_loss", "same_acc", "diff_acc"):
        assert row_s[key] == pytest.approx(row_r[key], rel=1e-5, abs=1e-6), key
    ps, pr = straight["model"].state_dict(), resumed["model"].state_dict()
    for k in ps:
        torch.testing.assert_close(ps[k], pr[k], atol=1e-6, rtol=0, msg=k)


def test_evaluate_siamese_matches_jax(tree, tmp_path):
    """The same seeded weights through each package's ``evaluate_model``:
    identical pair predictions, equal accuracy, ROC-AUC within 1e-3,
    distances within 1e-4, and the verification artifacts."""
    jm = jax_get_model("siamese")
    x = np.zeros((2, 32, 32, 3), np.float32)
    v = Z.np_tree(jax.jit(functools.partial(jm.init, train=False))(
        {"params": jax.random.key(3), "dropout": jax.random.key(4)}, x, x))
    jax_save_checkpoint(tmp_path / "jck" / "m", "best", v["params"], v["batch_stats"])
    save_checkpoint(tmp_path / "tck" / "m", "best", from_jax(v, "siamese"))
    kw = dict(model_type="siamese", model_name="m", batch_size=8, image_size=32,
              compute_dtype="float32")
    ref = jax_evaluate_model(JaxEvalConfig(**kw), tree, checkpoints_root=tmp_path / "jck",
                             outputs_root=tmp_path / "jout", return_predictions=True)
    got = evaluate_model(EvalConfig(**kw), tree, checkpoints_root=tmp_path / "tck",
                         outputs_root=tmp_path / "tout", return_predictions=True, device="cpu")
    p0, p1 = ref["_predictions"], got["_predictions"]
    np.testing.assert_array_equal(p1["y"], p0["y"])
    np.testing.assert_array_equal(p1["yhat"], p0["yhat"])
    np.testing.assert_allclose(p1["dist"], p0["dist"], atol=1e-4)
    assert got["accuracy"] == ref["accuracy"]
    assert abs(got["roc_auc"] - ref["roc_auc"]) < 1e-3
    assert abs(got["pr_auc"] - ref["pr_auc"]) < 1e-3
    for key in ("same_accuracy", "diff_accuracy", "precision", "recall", "f1"):
        assert got[key] == pytest.approx(ref[key], abs=1e-9), key
    assert got["per_person_accuracy"] == pytest.approx(ref["per_person_accuracy"])
    assert set(got) == set(ref) and got["throughput_pairs_per_sec"] > 0
    for name in ("roc_curve.csv", "person_recognition_matrix.csv", "per_person_accuracy.csv"):
        assert (tmp_path / "tout" / "m" / name).read_text() == (
            tmp_path / "jout" / "m" / name).read_text(), name
