"""The port's ``evaluate_model`` and ``predict_image`` against the JAX
package's, with the same weights (a JAX init, carried over by ``from_jax``)
on the same test split, at f32."""

import json

import jax
import numpy as np
import pytest
import torch

from facerec_torch.config import EvalConfig
from facerec_torch.convert import from_jax
from facerec_torch.data.synthetic import write_synthetic_imagefolder
from facerec_torch.eval.engine import discover_test_dir, evaluate_model, predict_image
from facerec_torch.train.checkpoints import save_checkpoint
from facerec_tpu.config import EvalConfig as JaxEvalConfig
from facerec_tpu.eval.engine import evaluate_model as jax_evaluate_model
from facerec_tpu.eval.engine import predict_image as jax_predict_image
from facerec_tpu.models import get_model as jax_get_model
from facerec_tpu.train.checkpoints import save_checkpoint as jax_save_checkpoint

SIZE = 32
CLASSES = 5


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """5 people x 14 faces: 2 test images each, 10 in all (a full batch of
    8 and a masked tail of 2)."""
    return write_synthetic_imagefolder(tmp_path_factory.mktemp("eval_tree"),
                                       num_classes=CLASSES, per_class=14, size=SIZE, seed=4)


def _jax_variables(model_type):
    model = jax_get_model(model_type, num_classes=CLASSES)
    x = np.zeros((2, SIZE, SIZE, 3), np.float32)
    rngs = {"params": jax.random.key(3), "dropout": jax.random.key(4)}
    if model_type == "arcface":
        v = model.init(rngs, x, labels=np.zeros(2, np.int32), train=True)
    else:
        v = model.init(rngs, x, train=False)
    return jax.tree_util.tree_map(np.asarray, {"params": v["params"],
                                               "batch_stats": v["batch_stats"]})


@pytest.fixture(scope="module", params=["baseline", "arcface"])
def evaluated(request, tree, tmp_path_factory):
    """The same weights saved by each package's checkpointer and evaluated
    by each package's ``evaluate_model``."""
    model_type = request.param
    root = tmp_path_factory.mktemp(f"eval_{model_type}")
    v = _jax_variables(model_type)
    jax_save_checkpoint(root / "jck" / "m", "best", v["params"], v["batch_stats"],
                        metadata={"model_type": model_type})
    save_checkpoint(root / "tck" / "m", "best", from_jax(v, model_type),
                    metadata={"model_type": model_type})
    kw = dict(model_type=model_type, model_name="m", batch_size=8, image_size=SIZE,
              compute_dtype="float32")
    ref = jax_evaluate_model(JaxEvalConfig(**kw), tree, checkpoints_root=root / "jck",
                             outputs_root=root / "jout", return_predictions=True)
    got = evaluate_model(EvalConfig(**kw), tree, checkpoints_root=root / "tck",
                         outputs_root=root / "tout", return_predictions=True, device="cpu")
    return model_type, root, ref, got


def test_evaluate_model_matches_jax(evaluated):
    """Identical argmax on every image, equal accuracy, ROC-AUC within 1e-3
    (tests/test_e2e_parity.py's bar), probabilities within 1e-4."""
    _, _, ref, got = evaluated
    p0, p1 = ref["_predictions"], got["_predictions"]
    assert len(p1["y"]) == got["num_test_images"] == 2 * CLASSES
    np.testing.assert_array_equal(p1["y"], p0["y"])
    np.testing.assert_array_equal(p1["yhat"], p0["yhat"])
    np.testing.assert_allclose(p1["probs"], p0["probs"], atol=1e-4)
    assert got["accuracy"] == ref["accuracy"]
    assert abs(got["roc_auc"] - ref["roc_auc"]) < 1e-3
    assert abs(got["pr_auc"] - ref["pr_auc"]) < 1e-3
    for key in ("precision", "recall", "f1"):
        assert got[key] == pytest.approx(ref[key], abs=1e-9), key
    assert got["confusion"] == ref["confusion"]


def test_evaluate_model_artifacts(evaluated, tree):
    """tests/test_eval.py's artifact contract: the result keys, the JSON, the
    curve CSVs and an experiment summary that appends."""
    model_type, root, ref, got = evaluated
    for key in ("accuracy", "precision", "recall", "f1", "roc_auc", "pr_auc",
                "avg_inference_time_ms", "throughput_imgs_per_sec", "calibration", "per_class",
                "confusion", "model_name", "model_type", "test_dir", "num_test_images"):
        assert key in got, key
    assert set(got) == set(ref)
    assert got["avg_inference_time_ms"] > 0 and got["throughput_imgs_per_sec"] > 0
    out_dir = root / "tout" / "m"
    saved = json.loads((out_dir / f"{model_type}_results.json").read_text())
    assert "_predictions" not in saved and saved["accuracy"] == got["accuracy"]
    for name in ("roc_curves.csv", "pr_curves.csv"):
        assert (out_dir / name).read_text().splitlines()[0] == (
            root / "jout" / "m" / name).read_text().splitlines()[0]
    summary = json.loads((out_dir / "experiment_summary.json").read_text())
    assert len(summary) == 1 and "accuracy" in summary[0]
    evaluate_model(EvalConfig(model_type=model_type, model_name="m", batch_size=8,
                              image_size=SIZE, compute_dtype="float32"),
                   tree / "test", checkpoints_root=root / "tck", outputs_root=root / "tout",
                   device="cpu")
    assert len(json.loads((out_dir / "experiment_summary.json").read_text())) == 2


def test_predict_image_matches_jax(evaluated, tree):
    model_type, root, _, got = evaluated
    names = [f"person_{i:03d}" for i in range(CLASSES)]
    kw = dict(model_type=model_type, model_name="m", image_size=SIZE, compute_dtype="float32")
    for i, img in enumerate(sorted((tree / "test").glob("*/*.jpg"))[:2]):
        ours = predict_image(img, EvalConfig(**kw), names, checkpoints_root=root / "tck",
                             device="cpu")
        ref = jax_predict_image(img, JaxEvalConfig(**kw), names, checkpoints_root=root / "jck")
        assert ours["predicted_class"] == ref["predicted_class"]
        assert ours["predicted_class"] == names[got["_predictions"]["yhat"][i]]
        assert ours["confidence"] == pytest.approx(ref["confidence"], abs=1e-4)
        assert [t["class"] for t in ours["top3"]] == [t["class"] for t in ref["top3"]]


def test_evaluate_model_refuses_siamese(tree, tmp_path):
    """``evaluate_model`` now evaluates a siamese model (its verification
    branch, held against JAX's in tests/test_torch_siamese.py); it only
    needs the checkpoint. ``predict_image`` still refuses one by name: a
    twin model has no classes, and JAX's cannot run it either."""
    with pytest.raises(FileNotFoundError):
        evaluate_model(EvalConfig(model_type="siamese", image_size=SIZE), tree,
                       checkpoints_root=tmp_path, outputs_root=tmp_path, device="cpu")
    with pytest.raises(ValueError, match="siamese"):
        predict_image(next((tree / "test").glob("*/*.jpg")),
                      EvalConfig(model_type="siamese", image_size=SIZE), ["a"],
                      checkpoints_root=tmp_path, device="cpu")


def test_evaluate_model_unknown_name(tree, tmp_path):
    """The verify skill's error path: a clean FileNotFoundError."""
    with pytest.raises(FileNotFoundError):
        evaluate_model(EvalConfig(model_type="baseline", model_name="no_such_model",
                                  image_size=SIZE), tree, checkpoints_root=tmp_path,
                       outputs_root=tmp_path, device="cpu")


def test_discover_test_dir(tree, tmp_path, monkeypatch):
    assert discover_test_dir(tree) == tree / "test"
    assert discover_test_dir(tree / "test") == tree / "test"
    import facerec_torch.eval.engine as eng

    monkeypatch.setattr(eng, "PROC_DATA_DIR", tmp_path)
    with pytest.raises(FileNotFoundError):
        discover_test_dir(None)
    (tmp_path / "ds" / "test").mkdir(parents=True)
    assert discover_test_dir(None) == tmp_path / "ds" / "test"
