"""The port's reader of the JAX trainer's orbax checkpoints, on the CPU:
``facerec_torch.utils.zstd`` against ``zstandard``, ``facerec_torch.train.
ocdbt`` against tensorstore's OCDBT driver (the committed tree, a tree with
interior B+tree nodes, and corrupted structure files), ``facerec_torch.
train.orbax.read_orbax_tree`` against the JAX package's ``load_checkpoint``
(the committed ``arcface_synth/best`` and a fresh tree with several dtypes,
a 0-d array, a list and an array sharded over the 8 virtual CPU devices,
which orbax writes as 8 chunks), zarr's edge and absent chunks against
tensorstore's zarr driver, and ``load_checkpoint``, ``build_embedder``,
``build_default_pipeline`` and ``evaluate_model`` serving the committed
tree as the JAX package does."""

import json
import logging
import shutil
import struct
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import tensorstore as ts
import torch
import zstandard
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import facerec_torch.serve.app as app
import facerec_tpu.train.checkpoints as jax_checkpoints
from facerec_torch.config import EvalConfig, ServeConfig
from facerec_torch.convert import from_jax
from facerec_torch.eval.engine import evaluate_model
from facerec_torch.models.arcface import ArcFaceNet, build_embedder
from facerec_torch.train import ocdbt
from facerec_torch.train.checkpoints import (
    is_orbax_checkpoint,
    load_checkpoint,
    restore_into,
    save_checkpoint,
)
from facerec_torch.train.orbax import read_orbax_tree, read_zarr
from facerec_torch.utils import zstd
from facerec_tpu.data.synthetic import write_synthetic_imagefolder
from facerec_tpu.models import get_model

REPO = Path(__file__).resolve().parent.parent
MODEL_DIR = REPO / "outputs" / "checkpoints" / "arcface_synth"
BEST = MODEL_DIR / "best"


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flat(v, path + (i,))
    else:
        yield path, tree


def _assert_trees_equal(got: dict, ref: dict) -> int:
    """Leaf for leaf: ``np.array_equal`` with equal dtypes and shapes
    (bfloat16 leaves, torch tensors on the port's side, by their bits).
    Returns the number of leaves."""
    fg, fr = dict(_flat(got)), dict(_flat(ref))
    assert fg.keys() == fr.keys()
    for k, r in fr.items():
        g = fg[k]
        if not isinstance(r, (np.ndarray, jax.Array)):
            assert type(g) is type(r) and g == r, k
            continue
        r = np.asarray(r)
        if r.dtype.name == "bfloat16":
            assert isinstance(g, torch.Tensor) and g.dtype == torch.bfloat16, k
            assert tuple(g.shape) == r.shape, k
            assert np.array_equal(g.view(torch.int16).numpy().view(np.uint16), r.view(np.uint16)), k
        else:
            assert isinstance(g, np.ndarray) and g.dtype == r.dtype and g.shape == r.shape, k
            assert np.array_equal(g, r), k
    return len(fr)


def _ts_store(path: Path):
    return ts.KvStore.open({"driver": "ocdbt", "base": f"file://{path}/"}).result()


# -- zstd -----------------------------------------------------------------------------------------

def _real_bytes() -> bytes:
    """64 KiB of a committed weight chunk (decoded by zstandard)."""
    store = ocdbt.open(BEST)
    frame = store.read("params.backbone.layer1_0.conv1.kernel/0.0.0.0")
    return zstandard.ZstdDecompressor().decompressobj().decompress(frame)[:65536]


@pytest.mark.parametrize("level", [1, 3, 19])
@pytest.mark.parametrize("checksum", [False, True])
@pytest.mark.parametrize("kind", ["random", "real"])
def test_zstd_matches_zstandard(level, checksum, kind):
    data = (np.random.default_rng(level).bytes(30000) + b"\0" * 20000 if kind == "random"
            else _real_bytes())
    assert zstandard.__version__ == "0.25.0"
    for size in (True, False):  # with and without the content size in the header
        frame = zstandard.ZstdCompressor(level=level, write_checksum=checksum,
                                         write_content_size=size).compress(data)
        assert zstd.decompress(frame) == data
        assert zstd.decompress(frame, size_hint=7) == data  # grows past a small hint


def test_zstd_reads_the_committed_frames():
    """Every chunk of the committed tree is a zstd frame without its content
    size: the same bytes as zstandard's streaming decoder."""
    store = ocdbt.open(BEST)
    keys = [k for k in store.keys() if not k.endswith(".zarray")]
    assert len(keys) == 106
    for k in keys[:12]:
        frame = store.read(k)
        assert frame[:4] == b"\x28\xb5\x2f\xfd"
        assert zstd.decompress(frame) == zstandard.ZstdDecompressor().decompressobj().decompress(
            frame)


def test_zstd_refuses_bad_frames(monkeypatch):
    with pytest.raises(ValueError, match="not a zstd frame"):
        zstd.decompress(b"not a frame at all")
    frame = bytearray(zstandard.ZstdCompressor(write_checksum=True).compress(b"x" * 1000))
    frame[-1] ^= 1
    with pytest.raises(ValueError, match="checksum"):
        zstd.decompress(bytes(frame))
    monkeypatch.setattr(zstd, "MAX_BYTES", 100)
    with pytest.raises(ValueError, match="more than 100 bytes"):
        zstd.decompress(zstandard.ZstdCompressor(write_content_size=False).compress(b"y" * 4000))


def test_zstd_names_a_missing_library(monkeypatch):
    def no_lib(name):
        raise OSError(f"{name}: cannot open shared object file")

    monkeypatch.setattr(zstd, "_lib", None)
    monkeypatch.setattr(zstd.ctypes, "CDLL", no_lib)
    with pytest.raises(RuntimeError, match="libzstd.so.1"):
        zstd.decompress(b"\x28\xb5\x2f\xfd")


# -- OCDBT ----------------------------------------------------------------------------------------

def test_crc32c_check_value():
    assert ocdbt.crc32c(b"123456789") == 0xE3069283  # the CRC-32C check value
    assert ocdbt.crc32c(b"") == 0


@pytest.mark.parametrize("sub", ["", "ocdbt.process_0"])
def test_ocdbt_keys_and_values_match_tensorstore(sub):
    """All 212 keys of the committed tree, and each value's bytes, from the
    root database (one leaf, values in ocdbt.process_0/d/) and from the
    process's own (six versions, the newest read)."""
    root = BEST / sub
    ref = _ts_store(root)
    keys = [k.decode() for k in ref.list().result()]
    store = ocdbt.open(root)
    assert store.keys() == sorted(keys) and len(keys) == 212
    for k in keys:
        assert store.read(k) == ref.read(k).result().value, k
    with pytest.raises(KeyError):
        store.read("params.nope/0")


@pytest.fixture(scope="module", params=[{"id": "zstd", "level": 5}, None], ids=["zstd5", "raw"])
def deep_store(request, tmp_path_factory):
    """A tensorstore OCDBT database with 600-byte nodes (a B+tree three
    levels deep), values inline up to 40 bytes and in data files above,
    compressed with zstd or not at all, written over 20 commits."""
    root = tmp_path_factory.mktemp("ocdbt")
    config = {"max_decoded_node_bytes": 600, "max_inline_value_bytes": 40,
              "compression": request.param}
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{root}/", "config": config}).result()
    rng = np.random.default_rng(0)
    for _ in range(20):
        with ts.Transaction() as txn:
            for i in range(30):
                key = f"group{rng.integers(0, 5)}/arr{rng.integers(0, 200):04d}/{i}"
                kv.with_transaction(txn)[key] = rng.bytes(int(rng.integers(0, 120)))
    return root


def test_ocdbt_walks_interior_nodes(deep_store):
    ref = _ts_store(deep_store)
    dump = ts.ocdbt.dump(ts.KvStore.open(f"file://{deep_store}/").result()).result()
    assert dump["versions"][-1]["root_height"] >= 2 and dump["version_tree_nodes"]
    compressed = (deep_store / "manifest.ocdbt").read_bytes()[13]  # the header's method
    assert compressed == (dump["config"].get("compression") is not None)
    keys = [k.decode() for k in ref.list().result()]
    store = ocdbt.open(deep_store)
    assert store.keys() == sorted(keys) and len(keys) > 500
    for k in keys:
        assert store.read(k) == ref.read(k).result().value, k


def _copy_best(tmp_path: Path) -> Path:
    dst = tmp_path / "best"
    shutil.copytree(BEST, dst)
    return dst


LEAF = "d/be382de1fd772411974a1ef9e3d9ec69"


@pytest.mark.parametrize("target,offset,match", [
    ("manifest.ocdbt", 40, "CRC-32C"),
    ("manifest.ocdbt", -2, "CRC-32C"),  # in the footer itself
    (LEAF, 20000, "CRC-32C"),
    ("manifest.ocdbt", 0, "magic"),
    ("manifest.ocdbt", 4, "frame says"),
])
def test_ocdbt_refuses_a_corrupted_structure_file(tmp_path, target, offset, match):
    root = _copy_best(tmp_path)
    path = root / target
    buf = bytearray(path.read_bytes())
    buf[offset] ^= 0x10
    path.write_bytes(bytes(buf))
    with pytest.raises(ocdbt.FormatError, match=match):
        ocdbt.open(root)


def test_ocdbt_refuses_a_truncated_node(tmp_path):
    root = _copy_best(tmp_path)
    leaf = root / LEAF
    leaf.write_bytes(leaf.read_bytes()[:-100])
    with pytest.raises(ocdbt.FormatError, match="past the end"):
        ocdbt.open(root)


def test_ocdbt_unframe_layout():
    """A frame built by hand: magic, length, version 0, no compression, the
    body, and the CRC-32C of what precedes it."""
    body = b"hello"
    head = struct.pack(">I", ocdbt.BTREE_MAGIC) + struct.pack("<Q", 12 + 2 + len(body) + 4)
    frame = head + b"\x00\x00" + body
    frame += struct.pack("<I", ocdbt.crc32c(frame))
    assert ocdbt.unframe(frame, ocdbt.BTREE_MAGIC, "t") == body
    with pytest.raises(ocdbt.FormatError, match="magic"):
        ocdbt.unframe(frame, ocdbt.MANIFEST_MAGIC, "t")


# -- orbax trees ----------------------------------------------------------------------------------

@pytest.fixture(scope="module")
def committed_trees():
    """The committed tree read once by each side (the port's reader and JAX's
    ``load_checkpoint``)."""
    ref = jax_checkpoints.load_checkpoint(MODEL_DIR, "best")
    meta = ref.pop("metadata")
    return read_orbax_tree(BEST), ref, meta


def test_read_orbax_tree_matches_jax_on_the_committed_tree(committed_trees):
    got, ref, meta = committed_trees
    assert _assert_trees_equal(got, ref) == 106
    assert sorted(got) == ["batch_stats", "params"] and meta["model_type"] == "arcface"
    assert got["params"]["arc_weight"].shape == (16, 512)
    n = sum(v.size for _, v in _flat(got["params"]))
    assert n == json.loads((MODEL_DIR / "model_info.json").read_text())["parameters"]["total"]


@pytest.fixture(scope="module")
def fresh_tree(tmp_path_factory):
    """A tree JAX's ``save_checkpoint`` writes with float32/16/64, bfloat16,
    int32/64, uint8 and bool leaves, 0-d arrays, an optax-like tuple (a
    list when restored without a target) and an array sharded over the 8
    virtual CPU devices, saved as a ``jax.Array`` (``_to_saveable``, which
    gathers every leaf to numpy, is bypassed for it) so orbax writes one
    chunk per shard."""
    rng = np.random.default_rng(0)
    devices = np.array(jax.devices()[:8])
    assert devices.size == 8
    sharded = jax.device_put(rng.standard_normal((16, 12), dtype=np.float32),
                             NamedSharding(Mesh(devices, ("data",)), P("data")))
    params = {
        "w": rng.standard_normal((5, 7)).astype(np.float32),
        "b16": jax.numpy.asarray(rng.standard_normal((3, 4)), jax.numpy.bfloat16),
        "i": np.arange(-5, 5, dtype=np.int32),
        "s": np.float32(3.5),
        "s0": np.array(7, np.int64),
        "sh": sharded,
        "u8": np.arange(6, dtype=np.uint8).reshape(2, 3),
        "f16": np.linspace(-2, 2, 9).astype(np.float16),
        "bl": np.array([True, False, True]),
        "f64": np.array([1.5, -2.25]),
        "nested": {"deep": {"x": rng.standard_normal((2, 2, 2)).astype(np.float32)}},
    }
    opt_state = (np.ones(2, np.float32), {"count": np.int32(3)})
    root = tmp_path_factory.mktemp("fresh")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_checkpoints, "_to_saveable", lambda tree: tree)
        jax_checkpoints.save_checkpoint(root, "best", params,
                                        batch_stats={"m": np.zeros(4, np.float32)},
                                        opt_state=opt_state, metadata={"model_type": "x"})
    return root / "best"


def test_read_orbax_tree_matches_jax_on_a_fresh_tree(fresh_tree):
    ref = jax_checkpoints.load_checkpoint(fresh_tree.parent, "best")
    ref.pop("metadata")
    got = read_orbax_tree(fresh_tree)
    assert _assert_trees_equal(got, ref) == 14
    assert isinstance(got["opt_state"], list) and got["params"]["s"].shape == ()
    sharded = [k for k in ocdbt.open(fresh_tree).keys() if k.startswith("params.sh/")]
    assert sharded == ["params.sh/.zarray"] + [f"params.sh/{i}.0" for i in range(8)]


def test_read_orbax_tree_reads_python_scalars(tmp_path):
    """Leaves saved as Python numbers (orbax's ``scalar`` type) come back
    as Python numbers, as JAX's restore gives them."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_checkpoints, "_to_saveable", lambda tree: tree)
        jax_checkpoints.save_checkpoint(tmp_path, "best", {"f": 2.5, "n": 7, "a": np.ones(3)})
    ref = jax_checkpoints.load_checkpoint(tmp_path, "best")
    ref.pop("metadata")
    got = read_orbax_tree(tmp_path / "best")
    assert _assert_trees_equal(got, ref) == 3 and got["params"]["n"] == 7


@pytest.mark.parametrize("dtype,fill", [("<f4", 1.5), ("<i2", -3), ("bfloat16", -0.75),
                                         ("<f8", "NaN"), ("|u1", None)])
def test_read_zarr_edge_and_absent_chunks(tmp_path, dtype, fill):
    """An array whose chunks do not divide its shape (stored edge chunks are
    whole), some chunks never written (read as ``fill_value``, 0 for null),
    through tensorstore's zarr driver on an OCDBT store."""
    spec = {"driver": "zarr", "kvstore": {"driver": "ocdbt", "base": f"file://{tmp_path}/"},
            "path": "params.x",
            "metadata": {"shape": [7, 5, 3], "chunks": [3, 2, 3], "dtype": dtype,
                         "fill_value": fill, "compressor": {"id": "zstd", "level": 3}}}
    arr = ts.open(spec, create=True).result()
    rng = np.random.default_rng(1)
    data = (rng.standard_normal((7, 5, 3)) * 50).astype(arr.dtype.numpy_dtype)
    arr[:3, :, :] = data[:3]  # chunk rows 0; rows 3..6 stay absent but one block
    arr[6:, 4:, :] = data[6:, 4:]
    ref = arr.read().result()
    got = read_zarr(ocdbt.open(tmp_path), "params.x")
    if dtype == "bfloat16":
        assert got.dtype == torch.bfloat16
        got, ref = got.view(torch.int16).numpy().view(np.uint16), np.asarray(ref).view(np.uint16)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    assert np.array_equal(got, ref, equal_nan=got.dtype.kind == "f")
    keys = ocdbt.open(tmp_path).keys()
    assert "params.x/2.2.0" in keys and "params.x/1.0.0" not in keys


def _raw_store(root: Path, zarray: dict, chunk: bytes = b"\0" * 16) -> ocdbt.OcdbtStore:
    kv = _ts_store(root)
    kv["a.b/.zarray"] = json.dumps(zarray).encode()
    kv["a.b/0"] = chunk
    return ocdbt.open(root)


@pytest.mark.parametrize("change,match", [
    ({"filters": [{"id": "delta", "dtype": "<f4"}]}, "filters"),
    ({"compressor": {"id": "blosc", "cname": "lz4"}}, "compressor 'blosc'"),
    ({"order": "F"}, "order 'F'"),
    ({"dtype": "<c8"}, "dtype '<c8'"),
    ({"dtype": "|O"}, "dtype '|O'"),
    ({"zarr_format": 3}, "format 3"),
])
def test_read_zarr_refuses_what_it_does_not_handle(tmp_path, change, match):
    zarray = {"chunks": [4], "compressor": None, "dtype": "<f4", "fill_value": None,
              "filters": None, "order": "C", "shape": [4], "zarr_format": 2}
    store = _raw_store(tmp_path, {**zarray, **change})
    with pytest.raises(ValueError, match=match) as e:
        read_zarr(store, "a.b")
    assert "a.b" in str(e.value)


def test_read_zarr_uncompressed_chunk(tmp_path):
    zarray = {"chunks": [4], "compressor": None, "dtype": ">f4", "fill_value": None,
              "filters": None, "order": "C", "shape": [4], "zarr_format": 2}
    want = np.array([1.0, -2.0, 3.5, 0.25], ">f4")
    got = read_zarr(_raw_store(tmp_path, zarray, want.tobytes()), "a.b")
    assert got.dtype == np.float32 and np.array_equal(got, want)
    with pytest.raises(ValueError, match="holds 3 bytes"):
        read_zarr(_raw_store(tmp_path / "short", zarray, b"abc"), "a.b")


# -- the port's checkpoint loaders ----------------------------------------------------------------

def test_load_checkpoint_converts_the_committed_tree(committed_trees):
    _, ref, meta = committed_trees
    ck = load_checkpoint(MODEL_DIR)  # best, then final
    assert is_orbax_checkpoint(BEST) and ck["metadata"] == meta and "opt_state" not in ck
    want = from_jax({"params": ref["params"], "batch_stats": ref["batch_stats"]}, "arcface")
    assert ck["model"].keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(ck["model"][k], v), k


def test_load_checkpoint_order_and_payload_precedence(tmp_path):
    """``best`` before ``final`` (an exported ``final`` beside the orbax
    ``best`` is not taken); a directory with ``state.pt`` is the port's."""
    (tmp_path / "m").mkdir()
    (tmp_path / "m" / "best").symlink_to(BEST)
    net = ArcFaceNet(512, 8, num_classes=3)
    save_checkpoint(tmp_path / "m", "final", net.state_dict())
    assert load_checkpoint(tmp_path / "m")["model"]["arc_weight"].shape == (16, 512)
    assert load_checkpoint(tmp_path / "m", "final")["model"]["arc_weight"].shape == (3, 512)
    assert not is_orbax_checkpoint(tmp_path / "m" / "final")


def test_restore_into_refuses_the_optimizer_of_a_jax_run(tmp_path):
    (tmp_path / "m").mkdir()
    (tmp_path / "m" / "best").symlink_to(BEST)
    net = ArcFaceNet(num_classes=16)
    with pytest.raises(ValueError, match="does not resume its optimizer"):
        restore_into(tmp_path / "m", "best", net, opt_state=object())
    _, meta = restore_into(tmp_path / "m", "best", net)
    assert meta["num_classes"] == 16 and net.arc_weight.shape == (16, 512)


def test_orbax_tree_without_model_type_is_refused(tmp_path, fresh_tree):
    dst = tmp_path / "m" / "best"
    shutil.copytree(fresh_tree, dst)
    (dst / "metadata.json").write_text("{}")
    with pytest.raises(ValueError, match="model_type"):
        load_checkpoint(tmp_path / "m")


def _jax_embed(params, stats, crops):
    n_cls = int(params["arc_weight"].shape[0])
    return np.asarray(jax.jit(lambda v, x: get_model("arcface", num_classes=n_cls).apply(
        v, x, method="embed"))({"params": params, "batch_stats": stats}, crops))


def test_build_embedder_on_the_orbax_tree_matches_jax(committed_trees):
    """f32 embeddings of the committed weights, as tests/test_torch_export.py
    holds the exported copy."""
    _, ref, _ = committed_trees
    crops = np.random.default_rng(0).uniform(0, 255, (4, 96, 96, 3)).astype(np.float32)
    want = _jax_embed(ref["params"], ref["batch_stats"], crops)
    net = build_embedder(checkpoint=BEST, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        got = net.embed(torch.from_numpy(crops)).numpy()
    cos = np.sum(got * want, axis=1) / np.linalg.norm(want, axis=1)
    assert np.all(1.0 - cos < 1e-4), 1.0 - cos


def test_default_pipeline_serves_the_committed_tree(committed_trees, tmp_path, monkeypatch,
                                                    caplog):
    """``build_default_pipeline(device="cpu")`` with the committed files
    alone: no warning, 16 class centres equal to JAX's tree cast to bf16,
    and its embeddings (the bf16 embedder, in f32) within 1 - cos < 1e-4 of
    JAX's ``ArcFaceNet.embed`` on the same weights."""
    _, ref, _ = committed_trees
    (tmp_path / "ck" / "arcface_synth").mkdir(parents=True)
    (tmp_path / "ck" / "arcface_synth" / "best").symlink_to(BEST)
    monkeypatch.setattr(app, "CHECKPOINTS_DIR", tmp_path / "ck")
    monkeypatch.setattr(app, "FACE_REFERENCES_DIR", tmp_path / "refs")
    monkeypatch.delenv("FACEREC_FACENET_WEIGHTS", raising=False)
    with caplog.at_level(logging.WARNING, logger="facerec_torch"):
        pipe = app.build_default_pipeline((96, 96), ServeConfig(max_faces=2), device="cpu")
    assert not any("random-init" in r.getMessage() for r in caplog.records)
    want_w = torch.from_numpy(np.asarray(ref["params"]["arc_weight"])).to(torch.bfloat16)
    assert pipe.embedder.arc_weight.shape == (16, 512)
    assert torch.equal(pipe.embedder.arc_weight.detach(), want_w)
    crops = np.random.default_rng(1).uniform(0, 255, (3, 64, 64, 3)).astype(np.float32)
    want = _jax_embed(ref["params"], ref["batch_stats"], crops)
    f32 = pipe.embedder.float()
    with torch.no_grad():
        got = f32.embed(torch.from_numpy(crops)).numpy()
    cos = np.sum(got * want, axis=1) / np.linalg.norm(want, axis=1)
    assert np.all(1.0 - cos < 1e-4), 1.0 - cos


def test_evaluate_model_on_the_orbax_tree_equals_the_export(tmp_path):
    """``evaluate_model`` on ``arcface_synth`` read from the orbax tree
    gives the metrics of the same model read from the exported port
    checkpoint (``tools/export_embedder.py``), on 16 classes at 32 px."""
    sys.path.insert(0, str(REPO / "tools"))
    from export_embedder import export_embedder

    data = write_synthetic_imagefolder(tmp_path / "ds", num_classes=16, per_class=7, size=32,
                                       seed=3)
    (tmp_path / "orbax" / "arcface_synth").mkdir(parents=True)
    (tmp_path / "orbax" / "arcface_synth" / "best").symlink_to(BEST)
    export_embedder(BEST, tmp_path / "export" / "arcface_synth")
    cfg = EvalConfig(model_type="arcface", model_name="arcface_synth", image_size=32,
                     batch_size=8)
    res = [evaluate_model(cfg, data, checkpoints_root=tmp_path / kind,
                          outputs_root=tmp_path / f"out_{kind}", return_predictions=True,
                          device="cpu") for kind in ("orbax", "export")]
    a, b = (r.pop("_predictions") for r in res)
    for k in a:
        assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k
    num = [{k: v for k, v in r.items() if isinstance(v, (int, float)) and "time" not in k
            and "ms" not in k and "per_s" not in k} for r in res]
    assert num[0] == num[1] and "accuracy" in num[0]



def test_predict_and_the_ensemble_loader_read_the_committed_tree(tmp_path):
    """``predict_image`` (the CLI's ``predict --model-name arcface_synth``)
    and ``create_pretrained_ensemble`` load the orbax tree as they load the
    export: the same answer, the same member weights."""
    sys.path.insert(0, str(REPO / "tools"))
    from export_embedder import export_embedder

    from facerec_torch.eval.engine import predict_image
    from facerec_torch.models.ensemble import create_pretrained_ensemble

    (tmp_path / "orbax" / "arcface_synth").mkdir(parents=True)
    (tmp_path / "orbax" / "arcface_synth" / "best").symlink_to(BEST)
    export_embedder(BEST, tmp_path / "export" / "arcface_synth")
    data = write_synthetic_imagefolder(tmp_path / "ds", num_classes=2, per_class=3, size=32,
                                       seed=1)
    image = sorted((data / "train").rglob("*.jpg"))[0]
    names = [f"person_{c:03d}" for c in range(16)]
    cfg = EvalConfig(model_type="arcface", model_name="arcface_synth", image_size=32)
    got = [predict_image(image, cfg, names, checkpoints_root=tmp_path / kind, device="cpu")
           for kind in ("orbax", "export")]
    assert got[0] == got[1] and got[0]["predicted_class"] in names
    ens = [create_pretrained_ensemble({"arcface": "arcface_synth"}, 16,
                                      checkpoints_root=tmp_path / kind)
           for kind in ("orbax", "export")]
    a, b = (e.members[0].state_dict() for e in ens)
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def test_chip_smoke_digests_match_jax(committed_trees):
    """``chip_smoke.TRAINED_DIGESTS``, which the card run holds the port's
    read against, are the digests of JAX's restore."""
    import chip_smoke

    _, ref, _ = committed_trees
    got = {".".join(k): chip_smoke._digest(np.asarray(v)) for k, v in _flat(ref)}
    assert got == chip_smoke.TRAINED_DIGESTS


def test_identification_figure_matches_jax(committed_trees):
    """``chip_smoke.JAX_ID_CORRECT``: JAX's f32 embedder on the CPU, one
    fresh render of each of the 16 identities enrolled, the 384 renders of
    ``make_synthetic_arrays(16, 24, 160, seed 0)`` queried (ImageNet-
    normalised); the port's f32 embedder on the CPU answers the same."""
    import chip_smoke
    from facerec_torch.data.datasets import _imagenet_normalize
    from facerec_torch.data.synthetic import _identity_params, make_synthetic_arrays, render_face

    _, ref, _ = committed_trees
    n, per, size, seed = (chip_smoke.ID_CLASSES, chip_smoke.ID_RENDERS, chip_smoke.ID_SIZE,
                          chip_smoke.ID_SEED)
    renders, labels = make_synthetic_arrays(n, per, size, seed)
    rng = np.random.default_rng(seed)
    ids = [_identity_params(rng, skin_lum_range=(0.25, 1.0)) for _ in range(n)]
    fresh = np.stack([render_face(p, size, np.random.default_rng(chip_smoke.ID_ENROLL_SEED + c))
                      for c, p in enumerate(ids)])
    xq, xg = _imagenet_normalize(renders), _imagenet_normalize(fresh)

    def correct(eq, eg):
        return int((np.argmax(eq @ eg.T, axis=1) == labels).sum())

    jax_q = np.concatenate([_jax_embed(ref["params"], ref["batch_stats"], xq[i:i + 96])
                            for i in range(0, len(xq), 96)])
    jax_correct = correct(jax_q, _jax_embed(ref["params"], ref["batch_stats"], xg))
    assert jax_correct == chip_smoke.JAX_ID_CORRECT
    net = build_embedder(checkpoint=BEST, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        port_q = np.concatenate([net.embed(torch.from_numpy(xq[i:i + 96])).numpy()
                                 for i in range(0, len(xq), 96)])
        port_g = net.embed(torch.from_numpy(xg)).numpy()
    assert correct(port_q, port_g) == jax_correct
