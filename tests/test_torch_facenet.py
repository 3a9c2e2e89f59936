"""The port's InceptionResnetV1 (``facerec_torch.models.facenet``) against the
JAX package's on the CPU, with JAX's weights carried by ``from_jax``; the
facenet-pytorch state-dict path; and the serve step with the FaceNet
embedder against the JAX serve step with JAX's FaceNet ``embed_fn``.

The JAX side is ``JaxFaceNetPublished`` (tests/torch_facenet.py): JAX's
net with its last Block8 at facenet-pytorch's scale 1.0, which the port
follows. ``test_unmodified_jax_last_block8_differs`` pins the difference."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facerec_torch.config import ServeConfig
from facerec_torch.convert import from_jax
from facerec_torch.data.synthetic import face_frames
from facerec_torch.detect.mtcnn import MTCNN
from facerec_torch.detect.weights import load_detector_params
from facerec_torch.models.facenet import InceptionResnetV1, build_facenet_embedder, fixed_standardize
from facerec_torch.serve.pipeline import FacePipeline
from facerec_tpu.config import ServeConfig as JaxServeConfig
from facerec_tpu.detect.mtcnn import MTCNN as JaxMTCNN
from facerec_tpu.detect.weights import load_detector_params as jax_load
from facerec_tpu.models.facenet import InceptionResnetV1 as JaxInceptionResnetV1
from facerec_tpu.models.facenet import fixed_standardize as jax_fixed_standardize
from facerec_tpu.serve.pipeline import FacePipeline as JaxFacePipeline
from torch_facenet import JaxFaceNetPublished, facenet_pytorch_replica, seeded_variables

SMALL = (1, 1, 1)
FULL = (5, 10, 5)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def small_vars():
    return seeded_variables(SMALL, 0)


@pytest.fixture(scope="module")
def full_vars():
    return seeded_variables(FULL, 1)


def _crops(n, seed=0, size=160):
    return np.random.default_rng(seed).uniform(0, 255, (n, size, size, 3)).astype(np.float32)


def _jax_embed(net, variables, crops):
    return np.asarray(jax.jit(net.apply)(variables, jax_fixed_standardize(jnp.asarray(crops))))


def _port_embed(variables, crops, dtype=torch.float32):
    net = build_facenet_embedder(from_jax(variables, "facenet"), dtype=dtype, device="cpu")
    with torch.no_grad():
        return net.embed(torch.from_numpy(crops)).numpy()


def _one_minus_cos(a, b):
    return 1.0 - np.sum(a * b, axis=-1) / np.linalg.norm(a, axis=-1) / np.linalg.norm(b, axis=-1)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 1e-2)])
def test_facenet_matches_jax(small_vars, dtype, tol):
    crops = _crops(3)
    ref = _jax_embed(JaxFaceNetPublished(repeats=SMALL, dtype=getattr(jnp, dtype)), small_vars,
                     crops)
    got = _port_embed(small_vars, crops, getattr(torch, dtype))
    assert got.shape == ref.shape == (3, 512) and got.dtype == np.float32
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)
    assert np.all(_one_minus_cos(got, ref) < tol), _one_minus_cos(got, ref)
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, atol=2e-4)


def test_full_width_facenet_matches_jax(full_vars):
    crops = _crops(2, seed=1)
    ref = _jax_embed(JaxFaceNetPublished(repeats=FULL), full_vars, crops)
    got = _port_embed(full_vars, crops)
    assert sum(p.numel() for p in InceptionResnetV1(FULL).parameters()) == 23_482_624
    assert np.all(_one_minus_cos(got, ref) < 1e-4), _one_minus_cos(got, ref)
    np.testing.assert_allclose(got, ref, atol=2e-4)


def test_unmodified_jax_last_block8_differs(small_vars):
    """JAX's InceptionResnetV1 scales its last Block8 by 0.20 where
    facenet-pytorch scales it by 1.0 (ROADMAP section 3): on the same
    weights it computes another function."""
    crops = _crops(2, seed=2)
    published = _jax_embed(JaxFaceNetPublished(repeats=SMALL), small_vars, crops)
    jax_net = _jax_embed(JaxInceptionResnetV1(repeats=SMALL), small_vars, crops)
    got = _port_embed(small_vars, crops)
    assert np.all(_one_minus_cos(got, published) < 1e-4)
    assert np.all(_one_minus_cos(got, jax_net) > 1e-2), _one_minus_cos(got, jax_net)
    assert InceptionResnetV1(SMALL).block8.scale == 1.0
    assert [b.scale for b in InceptionResnetV1((1, 1, 3)).repeat_3] == [0.20] * 3


def test_from_jax_covers_every_tensor(small_vars):
    sd = from_jax(small_vars, "facenet")
    assert set(sd) == set(InceptionResnetV1(SMALL).state_dict())
    assert sd["repeat_1.0.branch1.1.conv.weight"].shape == (32, 32, 3, 3)
    assert sd["mixed_7a.branch2.2.conv.weight"].shape == (256, 256, 3, 3)
    assert sd["last_linear.weight"].shape == (512, 1792)
    np.testing.assert_array_equal(sd["repeat_2.0.branch1.2.bn.running_var"].numpy(),
                                  small_vars["batch_stats"]["repeat_2_0"]["branch1_2"]["bn"]["var"])


def test_facenet_pytorch_state_dict_loads_strict(tmp_path):
    """A state dict with facenet-pytorch's names and a classification head,
    as its VGGFace2 file has, loads strict from a ``.pt`` file; the
    embedding equals the replica's within 1e-5."""
    torch.manual_seed(0)
    tm = facenet_pytorch_replica(SMALL)
    tm.logits = torch.nn.Linear(512, 7)
    gen = torch.Generator().manual_seed(1)
    for m in tm.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean.uniform_(-0.4, 0.4, generator=gen)
            m.running_var.uniform_(0.6, 1.4, generator=gen)
            m.weight.data.uniform_(0.5, 1.5, generator=gen)
            m.bias.data.uniform_(-0.3, 0.3, generator=gen)
    tm.eval()
    torch.save({"state_dict": tm.state_dict()}, tmp_path / "facenet.pt")
    net = build_facenet_embedder(tmp_path / "facenet.pt", dtype=torch.float32, device="cpu")
    assert [len(net.repeat_1), len(net.repeat_2), len(net.repeat_3)] == list(SMALL)
    assert not net.training and "logits.weight" in net.state_dict()
    crops = _crops(2, seed=3)
    with torch.no_grad():
        expect = tm(fixed_standardize(torch.from_numpy(crops)).permute(0, 3, 1, 2))
        got = net.embed(torch.from_numpy(crops))
        logits = net.logits(torch.from_numpy(crops))
    np.testing.assert_allclose(got.numpy(), expect.numpy(), atol=1e-5)
    assert logits.shape == (2, 7)
    with pytest.raises(RuntimeError, match="Missing key"):
        InceptionResnetV1(FULL).load_state_dict(tm.state_dict())


def test_seeded_facenet_embedder_is_reproducible():
    crops = torch.from_numpy(_crops(2, seed=4, size=96))
    a, b, c = (build_facenet_embedder(repeats=SMALL, dtype=torch.float32, seed=s, device="cpu")
               for s in (5, 5, 6))
    with torch.no_grad():
        assert torch.equal(a.embed(crops), b.embed(crops))
        assert not torch.equal(a.embed(crops), c.embed(crops))
    with pytest.raises(ValueError, match="no classification head"):
        a.logits(crops)


HW = (120, 160)
CFG = dict(max_faces=2, gallery_capacity=16, top_k=3, embed_size=96, detection_threshold=0.0,
           gallery_dtype="float32")
DET = dict(min_face_size=40, max_faces=2, k_pnet=16, k_rnet=8, input_range="255")


def test_facenet_serve_step_matches_jax(small_vars):
    """The serve step with the FaceNet embedder against JAX's serve step
    with JAX's FaceNet ``embed_fn`` (serve/app.py's, on the repaired net):
    the same valid slots and top-k rows, scores within 2e-3."""
    frames = face_frames(2, HW, 1, np.random.default_rng(0))
    jnet = JaxFaceNetPublished(repeats=SMALL)
    jpipe = JaxFacePipeline(JaxServeConfig(**CFG), HW, JaxMTCNN(HW, **DET), jax_load(),
                            lambda v, x: jnet.apply(v, jax_fixed_standardize(x)),
                            embed_variables=small_vars)
    tpipe = FacePipeline(ServeConfig(**CFG), HW,
                         MTCNN(HW, **DET, device="cpu").load_jax_params(load_detector_params()),
                         build_facenet_embedder(from_jax(small_vars, "facenet"),
                                                dtype=torch.float32, device="cpu"),
                         device="cpu")
    probe = np.asarray(jpipe.process(frames).embeddings).reshape(-1, 512)
    rng = np.random.default_rng(7)
    gal = rng.normal(size=(10, 512)).astype(np.float32)
    gal[[2, 7, 4, 9]] = probe + 0.02 * rng.normal(size=probe.shape)
    names = [f"id{i}" for i in range(10)]
    jpipe.gallery.add_many(names, gal)
    tpipe.gallery.add_many(names, gal)

    ref = jax.device_get(jpipe.process(frames))
    got = tpipe.process(frames)
    valid = np.asarray(ref.valid)
    assert valid.sum() >= 2
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    e0, e1 = np.asarray(ref.embeddings)[valid], got.embeddings.numpy()[valid]
    assert np.all(np.sum(e0 * e1, axis=-1) > 0.999)
    np.testing.assert_array_equal(got.match_indices.numpy()[valid],
                                  np.asarray(ref.match_indices)[valid])
    np.testing.assert_allclose(got.match_scores.numpy()[valid],
                               np.asarray(ref.match_scores)[valid], atol=2e-3)
    np.testing.assert_array_equal(got.is_match.numpy(), np.asarray(ref.is_match))


def test_default_pipeline_builds_facenet_from_env(tmp_path, monkeypatch):
    """``FACEREC_FACENET_WEIGHTS`` naming a facenet-pytorch ``.pt`` makes
    ``build_default_pipeline`` embed with InceptionResnetV1 in bf16, as the
    JAX demo does; the file's weights are the ones served."""
    from facerec_torch.serve import app

    net = build_facenet_embedder(repeats=SMALL, dtype=torch.float32, seed=3, device="cpu")
    torch.save(net.state_dict(), tmp_path / "vggface2.pt")
    monkeypatch.setenv("FACEREC_FACENET_WEIGHTS", str(tmp_path / "vggface2.pt"))
    monkeypatch.setattr(app, "FACE_REFERENCES_DIR", tmp_path / "refs")
    pipe = app.build_default_pipeline((96, 96), ServeConfig(embed_size=96), device="cpu")
    assert isinstance(pipe.embedder, InceptionResnetV1)
    assert pipe.embedder.last_linear.weight.dtype == torch.bfloat16
    torch.testing.assert_close(pipe.embedder.conv2d_1a.conv.weight.float(),
                               net.conv2d_1a.conv.weight.bfloat16().float())
