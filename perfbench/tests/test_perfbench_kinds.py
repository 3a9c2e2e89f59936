"""An embedder kind's module (``embedders/<kind>.py``) is all that the
serve and train drivers know of an architecture.

The four cells read what they read before the architecture moved into the
kinds' modules: their FLOPs counts, their drawn weights and the one-card
train cell's CPU comparison equal values recorded from the harness before
the move. A stub kind, a tiny convolution + BatchNorm + PReLU trunk under
ArcFace's head whose module lives only in this file, runs through both
drivers to a correct result line, as a new architecture's module would."""

from __future__ import annotations

import hashlib
import json
import sys
import time
import types

import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

from perfbench import embedders, flops, harness, weights
from perfbench.drivers import serve, train
from perfbench.reference import optim, resnet, train_arcface
from perfbench.tests.small import small

SEED = 2 ** 31 + 91
STUB = "stub_prelu"

# recorded from the harness before the architecture moved into the kinds' modules
PARENT_FLOPS = {"arcface_r18.serve_b48_f8": 1141992864768,
                "facenet_irv1.serve_b48_f8": 1519936232448,
                "arcface_r18.train_b256": 5553291264,
                "arcface_r18.train_dp4_b256": 5553291264}
WEIGHTS_SEED = 2 ** 31 + 4242
PARENT_WEIGHTS = {
    "arcface_r18": "de9bb69784c2f4c10a44531b3eab76824c48e3ca56f4009acb1a981e43480572",
    "facenet_irv1": "d5ad5128fdea22ff561bee0d0ae80a76209c60e1eb56c8022be2411fb21d3f80",
    "arcface_r18.train": "8bbdd2737023178809bb8ab074fa2bf211a465cc145facaa18075f232f7f0327"}
PARENT_TRAIN_NUMBERS = {  # small("arcface_r18.train_b256") at SEED, four threads
    "loss_gap_first": 0.00025365405867743213, "loss_gap": 0.012324073919638844,
    "grad_norm_gap_first": 0.011981949828226389, "grad_gap_median": 0.006464899481995607,
    "grad_gap": 0.12590495271474098, "change_gap_median": 0.005150230062529792,
    "change_gap": 0.04460103791160092, "stats_gap_median": 0.0018159819406959714,
    "stats_gap": 0.0265754047481359, "silent_leaves": 0.0}


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", sorted(PARENT_FLOPS))
def test_each_cell_counts_the_flops_it_counted_before(name):
    c = harness.cell(name)
    if c["traffic"]["driver"] == "serve":
        assert serve.flops_per_request(c["config"], c["traffic"]) == PARENT_FLOPS[name]
    else:
        t = c["config"]["train"]
        assert train.flops_per_image(train.kind(c["config"]), t, c["traffic"]) == PARENT_FLOPS[name]


def _digest(state: dict) -> str:
    h = hashlib.sha256()
    for n, v in state.items():
        h.update(n.encode())
        h.update(v.contiguous().view(torch.uint8).numpy().tobytes() if v.dtype == torch.bfloat16
                 else v.contiguous().numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("name", sorted(PARENT_WEIGHTS))
def test_each_shape_set_draws_the_weights_it_drew_before(name):
    config = harness.read_json(harness.HERE / "configs" / f"{name.split('.')[0]}.json")
    if name.endswith(".train"):
        shapes = train.kind(config).train_shapes(config["train"])
        dtype = torch.float32
    else:
        emb = config["embedder"]
        shapes, dtype = embedders.get(emb["kind"]).shapes(emb), torch.bfloat16
    assert _digest(weights.make_state(shapes, WEIGHTS_SEED, "cpu", dtype)) == PARENT_WEIGHTS[name]


def test_the_train_cell_compares_what_it_compared_before():
    out = train.run(small("arcface_r18.train_b256"), SEED, 0.3, False, time.perf_counter(), "cpu")
    assert out["numbers"] == PARENT_TRAIN_NUMBERS


def test_prelu_slopes_are_drawn_about_a_quarter():
    shapes = {"net.prelu.weight": (4096,), "pnet.prelu1.weight": (4096,), "net.bn.weight": (4096,),
              "net.preludes.weight": (4096,)}
    w = weights.make_state(shapes, 7, "cpu", torch.float32)
    for name in ("net.prelu.weight", "pnet.prelu1.weight"):
        assert abs(float(w[name].mean()) - 0.25) < 0.005
        assert abs(float(w[name].std()) - 0.05) < 0.005
    for name in ("net.bn.weight", "net.preludes.weight"):  # BatchNorm scales
        assert abs(float(w[name].mean()) - 1.0) < 0.01


# ------------------------------------------------------------- the stub kind
class TinyTrunk(nn.Module):
    """The stub's trunk in the program: a 3 x 3 stride-2 convolution,
    BatchNorm, PReLU, the mean over pixels."""

    def __init__(self, channels: int):
        super().__init__()
        from facerec_torch.models.resnet import BatchNorm

        self.conv = nn.Conv2d(3, channels, 3, stride=2, padding=1, bias=False)
        self.bn = BatchNorm(channels, eps=1e-5)
        self.prelu = nn.PReLU(channels)

    def pooled(self, x_nhwc: torch.Tensor) -> torch.Tensor:
        return self.prelu(self.bn(self.conv(x_nhwc.permute(0, 3, 1, 2)))).mean(dim=(2, 3))


def _net(sizes: dict, num_classes: int, **head):
    """The port's ArcFace head over the stub's trunk."""
    from facerec_torch.models.arcface import ArcFaceNet

    net = ArcFaceNet(sizes["embedding_dim"], sizes["width"], num_classes=num_classes, **head)
    net.backbone = TinyTrunk(8 * sizes["width"])
    return net


def _bn(prefix: str, c: int) -> dict:
    return {f"{prefix}.{leaf}": (c,) for leaf in ("weight", "bias", "running_mean", "running_var")
            } | {f"{prefix}.num_batches_tracked": ()}


def stub_shapes(sizes: dict, num_classes: int = 18) -> dict:
    c, d = 8 * sizes["width"], sizes["embedding_dim"]
    return {"backbone.conv.weight": (c, 3, 3, 3), **_bn("backbone.bn", c),
            "backbone.prelu.weight": (c,), "embedding.weight": (d, c), **_bn("bn", d),
            "arc_weight": (num_classes, d)}


def stub_program(state, emb, device, dtype=torch.bfloat16):
    net = _net(emb, 18)
    net.load_state_dict(state)
    return net.to(device=device, dtype=dtype).eval()


def stub_reference(p, w, crops):
    x = p.conv2d(crops.float().permute(0, 3, 1, 2), w["backbone.conv.weight"], stride=2, padding=1)
    x = F.prelu(resnet.batch_norm(x, w, "backbone.bn", 1e-5), w["backbone.prelu.weight"].float())
    x = resnet.batch_norm(p.linear(x.mean(dim=(2, 3)), w["embedding.weight"]), w, "bn", 1e-5)
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-12)


def stub_macs(emb, size=None):
    s, c = flops.conv_out(size or emb["crop"], 3, 2, 1), 8 * emb["width"]
    return flops.conv_macs(3, c, 3, 3, s, s) + c * emb["embedding_dim"]


def stub_train_program(t, optimizer, batch, seed, device, mesh=None):
    from facerec_torch.config import TrainConfig
    from facerec_torch.train.state import create_train_state
    from facerec_torch.train.steps import make_train_step

    net = _net(t, t["num_classes"], dropout_rate=t["dropout"], margin=t["margin"],
               scale=t["scale"], warmup_epochs=t["warmup_epochs"])
    cfg = TrainConfig(model_type="arcface", batch_size=batch, num_classes=t["num_classes"],
                      seed=seed, compute_dtype=t["compute_dtype"], optimizer=optimizer)
    return (create_train_state(net, cfg, "arcface", torch.device(device)),
            make_train_step("arcface", t["compute_dtype"], mesh))


def stub_train_loss(p, w, images, labels, keep, t, epoch=0.0, mask=None, stats=None):
    st = {} if stats is None else stats
    x = p.act(images.float().permute(0, 3, 1, 2))
    x = train_arcface.conv_bn(p, x, w, "backbone.conv.weight", "backbone.bn", st, 2, 1)
    x = F.prelu(x, w["backbone.prelu.weight"])
    return train_arcface.margin_loss(p, w, x.mean(dim=(2, 3)), labels, keep, t, epoch, mask, st)


@pytest.fixture
def stub(monkeypatch):
    """The stub kind's module, found by ``embedders.get`` under its name."""
    mod = types.ModuleType(f"perfbench.embedders.{STUB}")
    mod.shapes, mod.program, mod.reference, mod.macs = (stub_shapes, stub_program,
                                                        stub_reference, stub_macs)
    mod.train_shapes = lambda t: stub_shapes(t, t["num_classes"])
    mod.train_param_names = lambda t: [n for n in stub_shapes(t, t["num_classes"])
                                       if n.rsplit(".", 1)[-1] not in train_arcface.BUFFERS]
    mod.train_program, mod.train_loss = stub_train_program, stub_train_loss
    mod.update_running = train_arcface.update_running
    mod.train_macs = lambda t, image: stub_macs(t, image)
    monkeypatch.setitem(sys.modules, mod.__name__, mod)
    return mod


def _result_line(c: dict, out: dict, capsys, monkeypatch) -> dict:
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "a card")
    assert harness.emit(c, out, traced=False) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


STUB_EMB = {"kind": STUB, "width": 2, "embedding_dim": 64, "crop": 160}


def test_a_new_kind_serves_through_the_serve_driver(stub, capsys, monkeypatch):
    c = small("arcface_r18.serve_b48_f8")
    c["config"] = {**c["config"], "embedder": STUB_EMB}
    torch.manual_seed(0)
    out = serve.run(c, SEED, 0.5, False, time.perf_counter(), "cpu")
    line = _result_line(c, out, capsys, monkeypatch)
    assert line["correct"], line["checks"]
    traffic = c["traffic"]
    assert out["ctx"]["flops_per_request"] == flops.serve_flops(
        {**c["config"], "detector": {**c["config"]["detector"], "frame_hw": traffic["frame_hw"]}},
        traffic["batch"], traffic["enrolled"], stub_macs(STUB_EMB))
    assert harness.read_metric("serve.mfu", out["ctx"]) > 0


def test_a_program_that_skips_its_prelus_is_caught(stub, monkeypatch):
    monkeypatch.setattr(TinyTrunk, "pooled", lambda self, x: self.bn(self.conv(
        x.permute(0, 3, 1, 2))).mean(dim=(2, 3)))
    c = small("arcface_r18.serve_b48_f8")
    c["config"] = {**c["config"], "embedder": STUB_EMB}
    torch.manual_seed(0)
    out = serve.run(c, SEED, 0.5, False, time.perf_counter(), "cpu")
    assert not harness.decide(c["limits"], out["numbers"], out["failed"])[0], out["numbers"]


@pytest.mark.parametrize("opt", [
    {"name": "adam", "learning_rate": 0.001, "beta1": 0.9, "beta2": 0.999, "clip_norm": 0.3},
    {"name": "sgd", "learning_rate": 0.05, "momentum": 0.9, "clip_norm": 0.3}],
    ids=lambda o: o["name"])
def test_a_new_kind_trains_through_the_train_driver(stub, capsys, monkeypatch, opt):
    c = small("arcface_r18.train_b256")
    c["config"] = {**c["config"], "embedder": STUB_EMB,
                   "train": {**c["config"]["train"], "num_classes": 6, "width": 2,
                             "embedding_dim": 64, "compute_dtype": "float32", "optimizer": opt}}
    out = train.run(c, SEED, 0.3, False, time.perf_counter(), "cpu")
    line = _result_line(c, out, capsys, monkeypatch)
    assert line["correct"], line["checks"]
    assert out["ctx"]["flops_per_image"] == 6 * stub_macs(c["config"]["train"], 64)


def test_the_reference_sgd_is_the_port_sgd():
    from facerec_torch.config import OptimizerConfig, TrainConfig
    from facerec_torch.train.state import create_train_state

    opt = {"name": "sgd", "learning_rate": 0.05, "momentum": 0.9, "clip_norm": 0.3}
    cfg = TrainConfig(optimizer=OptimizerConfig(name="sgd", learning_rate=0.05, momentum=0.9,
                                                grad_clip_norm=0.3))
    state = create_train_state(nn.Sequential(nn.Linear(5, 4), nn.Linear(4, 3)), cfg, "baseline",
                               torch.device("cpu"))
    port = list(state.model.parameters())
    params = [q.detach().clone() for q in port]
    ref = optim.make(params, opt)
    g = torch.Generator().manual_seed(3)
    for _ in range(3):
        grads = [torch.randn(q.shape, generator=g) for q in params]
        assert float(ref.step(params, [x.clone() for x in grads])) > opt["clip_norm"]
        state.opt_state.step([x.clone() for x in grads])
        torch.testing.assert_close([q.detach() for q in port], params, rtol=1e-6, atol=1e-7)


def test_unknown_kinds_and_optimizers_fail_at_set_up():
    c = small("arcface_r18.serve_b48_f8")
    c["config"] = {**c["config"], "embedder": {**STUB_EMB, "kind": "no_such_kind"}}
    with pytest.raises(ValueError, match="no_such_kind"):
        serve.run(c, SEED, 0.3, False, time.perf_counter(), "cpu")
    c = small("arcface_r18.train_b256")
    facenet = harness.read_json(harness.HERE / "configs" / "facenet_irv1.json")["embedder"]
    c["config"] = {**c["config"], "embedder": facenet}
    with pytest.raises(ValueError, match="'facenet_inception_resnet_v1' does not train"):
        train.run(c, SEED, 0.3, False, time.perf_counter(), "cpu")
    c = small("arcface_r18.train_b256")
    c["config"] = {**c["config"], "train": {**c["config"]["train"],
                                            "optimizer": {"name": "lion", "clip_norm": 0.3}}}
    with pytest.raises(ValueError, match="'lion'"):
        train.main(c, SEED, 0.3, False, time.perf_counter())
