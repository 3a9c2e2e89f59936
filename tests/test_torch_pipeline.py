"""The port's whole serve step against the JAX package's on the CPU, and the
port's two promises: it imports nothing of JAX, and its entry points refuse
to fall back to the CPU when no card is present."""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facerec_torch.config import ServeConfig
from facerec_torch.data.synthetic import face_frames
from facerec_torch.detect.mtcnn import MTCNN
from facerec_torch.detect.weights import load_detector_params
from facerec_torch.models.arcface import build_embedder
from facerec_torch.serve.gallery import GalleryStore
from facerec_torch.serve.pipeline import FacePipeline, FaceTracker, calc_iou
from facerec_tpu.config import ServeConfig as JaxServeConfig
from facerec_tpu.detect.mtcnn import MTCNN as JaxMTCNN
from facerec_tpu.detect.weights import load_detector_params as jax_load
from facerec_tpu.models import get_model
from facerec_tpu.serve.pipeline import FacePipeline as JaxFacePipeline
from facerec_tpu.serve.pipeline import FaceTracker as JaxFaceTracker
from facerec_tpu.serve.pipeline import calc_iou as jax_calc_iou

REPO = Path(__file__).resolve().parent.parent
HW = (120, 160)
CFG = dict(max_faces=2, gallery_capacity=16, top_k=3, embed_size=64, detection_threshold=0.0,
           gallery_dtype="float32")
DET = dict(min_face_size=40, max_faces=2, k_pnet=16, k_rnet=8, input_range="255")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def both():
    """The same frames through the jitted JAX step and the port's step, with
    the same detector weights, embedder weights and gallery."""
    frames = face_frames(2, HW, 1, np.random.default_rng(0))
    model = get_model("arcface", num_classes=18)
    v = model.init({"params": jax.random.key(1), "dropout": jax.random.key(2)},
                   jnp.zeros((1, 64, 64, 3)), labels=jnp.zeros(1, jnp.int32), train=True)
    evars = {"params": v["params"], "batch_stats": v["batch_stats"]}
    jpipe = JaxFacePipeline(JaxServeConfig(**CFG), HW, JaxMTCNN(HW, **DET), jax_load(),
                            lambda ev, x: model.apply(ev, x, method="embed"),
                            embed_variables=evars)
    tpipe = FacePipeline(ServeConfig(**CFG), HW,
                         MTCNN(HW, **DET, device="cpu").load_jax_params(load_detector_params()),
                         build_embedder(jax.tree_util.tree_map(np.asarray, evars),
                                        dtype=torch.float32, device="cpu"),
                         device="cpu")
    # gallery: noisy copies of the faces JAX embeds, among random identities
    probe = np.asarray(jpipe.process(frames).embeddings).reshape(-1, 512)
    rng = np.random.default_rng(7)
    gal = rng.normal(size=(10, 512)).astype(np.float32)
    gal[[2, 7, 4, 9]] = probe + 0.02 * rng.normal(size=probe.shape)
    names = [f"id{i}" for i in range(10)]
    jpipe.gallery.add_many(names, gal)
    tpipe.gallery.add_many(names, gal)
    return frames, jpipe, tpipe


def test_serve_step_matches_jax(both):
    frames, jpipe, tpipe = both
    ref = jax.device_get(jpipe.process(frames))
    got = tpipe.process(frames)
    valid = np.asarray(ref.valid)
    assert valid.sum() >= 2
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    e0, e1 = np.asarray(ref.embeddings)[valid], got.embeddings.numpy()[valid]
    assert np.all(np.sum(e0 * e1, axis=-1) > 0.999)
    np.testing.assert_array_equal(got.match_indices.numpy()[valid][:, 0],
                                  np.asarray(ref.match_indices)[valid][:, 0])
    np.testing.assert_allclose(got.match_scores.numpy()[valid], np.asarray(ref.match_scores)[valid],
                               atol=2e-3)
    np.testing.assert_array_equal(got.is_match.numpy(), np.asarray(ref.is_match))
    assert got.match_distances.shape == (2, 2, 3) and got.embeddings.shape == (2, 2, 512)


def test_identify_matches_jax(both):
    frames, jpipe, tpipe = both
    ref, got = jpipe.identify(frames), tpipe.identify(frames)
    assert [[f["name"] for f in fr] for fr in got] == [[f["name"] for f in fr] for fr in ref]
    assert all(f["name"] != "Unknown" for fr in got for f in fr)
    assert got[0][0]["embedding"].shape == (512,)


def test_tracker_and_iou_match_jax():
    a, b, c = [0, 0, 10, 10], [5, 5, 15, 15], [40, 40, 50, 50]
    assert calc_iou(a, b) == jax_calc_iou(a, b) and calc_iou(a, c) == 0.0
    t, jt = FaceTracker(), JaxFaceTracker()
    for boxes in ([a, c], [c, [1, 1, 11, 11]], [b]):
        assert t.update(boxes) == jt.update(boxes)


def test_port_imports_no_jax():
    """Every facerec_torch module and chip_smoke import with jax, flax and
    facerec_tpu made unimportable (optax too, which the JAX trainers use,
    and tensorstore and zstandard, which read orbax trees there).
    ``serve.app_ui`` imports streamlit, which is not installed: a stub
    stands in."""
    mods = sorted(".".join(p.relative_to(REPO).with_suffix("").parts)
                  for p in (REPO / "facerec_torch").rglob("*.py"))
    mods = [m.removesuffix(".__init__") for m in mods] + ["chip_smoke"]
    code = ("import sys, importlib\n"
            "for name in ('jax', 'jaxlib', 'flax', 'optax', 'facerec_tpu', 'tensorstore',"
            " 'zstandard'):\n"
            "    sys.modules[name] = None\n"
            "import types\n"
            "st = sys.modules['streamlit'] = types.ModuleType('streamlit')\n"
            "st.cache_resource = lambda f: f\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "leaked = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'optax',"
            " 'facerec_tpu', 'tensorstore', 'zstandard')"
            " and sys.modules[m] is not None]\n"
            "assert not leaked, leaked\n"
            "print(len(sys.argv) and 'ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert "facerec_torch.ops.gallery" in mods and "facerec_torch.serve.pipeline" in mods
    assert {"facerec_torch.ops.augment", "facerec_torch.data.preprocess",
            "facerec_torch.detect.train", "facerec_torch.utils.profiling",
            "facerec_torch.cli.interactive", "facerec_torch.models.facenet",
            "facerec_torch.models.convert", "facerec_torch.models.fold",
            "facerec_torch.utils.zstd", "facerec_torch.train.ocdbt", "facerec_torch.train.orbax",
            "facerec_torch.data.download", "facerec_torch.serve.app_ui"} <= set(mods)


@pytest.mark.parametrize("entry", ["pipeline", "mtcnn", "embedder", "gallery", "evaluate_model",
                                   "predict_image", "build_default_pipeline", "find_optimal_lr",
                                   "run_cross_validation", "run_hyperparameter_tuning",
                                   "generate_visualization_report", "compare_all_models",
                                   "cli_train", "process_raw_data", "batch_preprocessor",
                                   "train_net", "train_detector", "interactive",
                                   "cli_preprocess", "facenet_embedder", "exported_embedder",
                                   "folded_arcface", "folded_facenet", "orbax_embedder",
                                   "run_demo", "cli_demo"])
def test_entry_points_refuse_cpu_fallback(entry, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the refusal is for machines without one")
    from facerec_torch.cli.compare import compare_all_models
    from facerec_torch.cli.interactive import interactive_menu
    from facerec_torch.cli.main import main as cli_main
    from facerec_torch.config import PreprocessingConfig
    from facerec_torch.data.preprocess import BatchPreprocessor, process_raw_data
    from facerec_torch.detect.mtcnn import PNet
    from facerec_torch.detect.train import train_detector, train_net
    from facerec_torch.config import EvalConfig, TrainConfig, TuningConfig
    from facerec_torch.eval.engine import evaluate_model, predict_image
    from facerec_torch.eval.visualizer import generate_visualization_report
    from facerec_torch.models import ArcFaceNet, get_model
    from facerec_torch.models.facenet import InceptionResnetV1, build_facenet_embedder
    from facerec_torch.models.fold import folded_arcface, folded_facenet
    from facerec_torch.serve.app import build_default_pipeline, run_demo
    from facerec_torch.train.cross_validation import run_cross_validation
    from facerec_torch.train.lr_finder import find_optimal_lr
    from facerec_torch.train.state import create_train_state
    from facerec_torch.train.tuning import run_hyperparameter_tuning

    def lr_finder():
        model = get_model("baseline", num_classes=2)
        state = create_train_state(model, TrainConfig(), "baseline", torch.device("cpu"))
        return find_optimal_lr(model, "baseline", state, batcher=None)

    build = {
        "pipeline": lambda: FacePipeline(ServeConfig(**CFG), HW, None, None),
        "mtcnn": lambda: MTCNN(HW),
        "embedder": lambda: build_embedder(),
        "gallery": lambda: GalleryStore(),
        "evaluate_model": lambda: evaluate_model(EvalConfig(), tmp_path,
                                                 checkpoints_root=tmp_path,
                                                 outputs_root=tmp_path),
        "predict_image": lambda: predict_image(tmp_path / "a.jpg", EvalConfig(), ["a"],
                                               checkpoints_root=tmp_path),
        "build_default_pipeline": lambda: build_default_pipeline(HW),
        "find_optimal_lr": lr_finder,
        "run_cross_validation": lambda: run_cross_validation(TrainConfig(), tmp_path,
                                                             checkpoints_root=tmp_path),
        "run_hyperparameter_tuning": lambda: run_hyperparameter_tuning(
            TuningConfig(n_trials=1), tmp_path, output_dir=tmp_path, objective_fn=lambda c, r: [0.5]),
        "generate_visualization_report": lambda: generate_visualization_report(
            get_model("baseline", num_classes=2), "baseline", tmp_path, out_dir=tmp_path),
        "compare_all_models": lambda: compare_all_models(tmp_path, model_types=["baseline"],
                                                         checkpoints_root=tmp_path,
                                                         outputs_root=tmp_path),
        "cli_train": lambda: cli_main(["train", "--dataset", str(tmp_path)]),
        "process_raw_data": lambda: process_raw_data(tmp_path, tmp_path / "out"),
        "batch_preprocessor": lambda: BatchPreprocessor(PreprocessingConfig(use_mtcnn=False)),
        "train_net": lambda: train_net(PNet(), 12, 1, 1),
        "train_detector": lambda: train_detector(tmp_path, n_scenes=1, steps=1),
        "interactive": lambda: interactive_menu(),
        "cli_preprocess": lambda: cli_main(["preprocess", "--raw-dir", str(tmp_path),
                                            "--no-mtcnn"]),
        "facenet_embedder": lambda: build_facenet_embedder(),
        "exported_embedder": lambda: build_embedder(checkpoint=tmp_path / "final"),
        "folded_arcface": lambda: folded_arcface(ArcFaceNet(num_classes=2).state_dict()),
        "folded_facenet": lambda: folded_facenet(InceptionResnetV1((1, 1, 1)).state_dict()),
        "orbax_embedder": lambda: build_embedder(
            checkpoint=REPO / "outputs" / "checkpoints" / "arcface_synth" / "best"),
        "run_demo": lambda: run_demo(),
        "cli_demo": lambda: cli_main(["demo"]),
    }[entry]
    with pytest.raises(RuntimeError, match="CUDA"):
        build()
