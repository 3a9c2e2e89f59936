"""The harness on the CPU: what it finds by name, its result line, its
traffic, and its refusal to run without a card."""

from __future__ import annotations

import json
import re

import numpy as np
import pytest
import torch

from perfbench import harness, render, run
from perfbench.drivers import serve

SPEC = harness.load_spec()
CELLS = [w["name"] for w in SPEC["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


@pytest.mark.parametrize("name", CELLS)
def test_each_cell_finds_its_files_by_name(name):
    c = harness.cell(name)
    assert c["config"]["name"] == c["workload"]["config"]
    assert harness.driver(c["traffic"]).main
    assert c["limits"], "every cell has the limits of its comparison"
    e2e = {m["name"] for m in c["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c["per_layer"]
    assert {m["moves"] for m in c["per_layer"]} <= e2e


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["per_layer"]])
def test_each_per_layer_metric_has_a_reader(metric):
    import importlib.util

    path = harness.HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(metric, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert callable(mod.read)


def test_names_and_units_keep_to_the_benchmark_format():
    names = ([c["name"] for c in SPEC["configs"]] + CELLS
             + [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]])
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert re.match(r"^[A-Za-z0-9_/%.\-]{1,16}$", m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    layers = {m["layer"] for m in SPEC["per_layer"]}
    assert all("\n" not in x and len(x) <= 200 for x in layers)


def test_a_reader_with_nothing_to_read_returns_nothing():
    ctx = {"spans": __import__("perfbench.trace", fromlist=["Spans"]).Spans(),
           "window": {"requests": 0, "seconds": 1.0}, "traffic": {}, "config": {}, "chips": 1}
    for m in SPEC["per_layer"]:
        assert harness.read_metric(m["name"], ctx) is None


def test_the_result_line_has_its_keys_and_checks_last(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "a card")
    c = harness.cell(CELLS[0])
    out = {"attempted": 3, "failed": 0, "memory_peak_bytes": 7,
           "frames_per_s": 1.5, "latency_p95_ms": 2.5, "setup_s": 3.5, "ctx": {},
           "numbers": {k: 0.0 for k in c["limits"]}}
    assert harness.emit(c, out, traced=False) == 0
    captured = capsys.readouterr()
    line = json.loads(captured.out.strip().splitlines()[-1])
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is True
    assert set(line["metrics"]) == {m["name"] for m in c["end_to_end"]}
    assert line["device"] == {"platform": "gpu", "kind": "a card", "count": 1,
                              "memory_peak_bytes": 7}
    assert set(line["checks"]) == set(c["limits"])
    assert captured.err.strip().splitlines()[-1].startswith("check ")


def test_a_number_over_its_limit_or_missing_is_not_correct(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "a card")
    c = harness.cell(CELLS[0])
    first = next(iter(c["limits"]))
    for bad in (c["limits"][first] * 2 + 1, float("nan"), float("inf")):
        out = {"attempted": 3, "failed": 0, "memory_peak_bytes": 7, "frames_per_s": 1.5,
               "latency_p95_ms": 2.5, "setup_s": 3.5, "ctx": {},
               "numbers": {**{k: 0.0 for k in c["limits"]}, first: bad}}
        harness.emit(c, out, traced=False)
        line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert line["correct"] is False


def test_a_run_that_loaded_jax_prints_no_result(capsys, monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "facerec_tpu.ops", types.ModuleType("facerec_tpu.ops"))
    c = harness.cell(CELLS[0])
    assert harness.emit(c, {"ctx": {}}, traced=False) != 0
    captured = capsys.readouterr()
    assert captured.out == "" and "facerec_tpu.ops" in captured.err


def test_a_run_whose_ranks_loaded_jax_prints_no_result(capsys):
    c = harness.cell(CELLS[0])
    assert harness.emit(c, {"ctx": {}, "forbidden": ["jaxlib"]}, traced=False) != 0
    captured = capsys.readouterr()
    assert captured.out == "" and "jaxlib" in captured.err


SMALL = {"batch": 2, "frame_hw": [120, 320], "faces_per_frame": 2, "pool_batches": 2}


def test_traffic_is_the_same_for_the_same_seed():
    big = 2 ** 31 + 12345
    a, b = serve.frame_pool(SMALL, big), serve.frame_pool(SMALL, big)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    c = serve.frame_pool(SMALL, big + 1)
    assert not np.array_equal(a[0], c[0])
    assert not np.array_equal(a[0], a[1])  # the pool's batches differ
    assert a[0].dtype == np.uint8 and a[0].shape == (2, 120, 320, 3)


def test_salted_requests_differ_and_are_rebuilt_exactly():
    pool = serve.frame_pool(SMALL, 7)
    sent = serve.salt(pool[1], 3).copy()
    assert np.array_equal(serve.request_frames(pool, 3), sent)
    assert not np.array_equal(serve.request_frames(pool, 5), sent)


def test_the_renderer_copy_gives_the_port_s_frames():
    from facerec_torch.data.synthetic import face_frames

    for seed in (0, 2 ** 31 + 5):
        a = render.face_frames(2, (120, 320), 2, np.random.default_rng(seed))
        b = face_frames(2, (120, 320), 2, np.random.default_rng(seed))
        assert np.array_equal(a, b)


def test_p95_is_taken_over_all_requests():
    # 100 requests: 94 at 1 ms, 6 at 50 ms. Medians of chunks of 10 would all
    # read 1 ms; the 95th of all reads 50.
    lat = [1.0] * 94 + [50.0] * 6
    assert serve.percentile(lat, 95) == 50.0
    assert serve.percentile([1.0] * 95 + [50.0] * 5, 95) == 1.0
    assert serve.percentile([3.0], 95) == 3.0


def test_the_run_fails_without_a_card(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", CELLS[0], "--seed", str(2 ** 31 + 3), "--seconds", "1",
                   "--trace", "0"])
    captured = capsys.readouterr()
    assert rc != 0 and captured.out == ""
    assert "CUDA card" in captured.err


def test_the_run_refuses_a_cell_asking_for_more_cards(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1",
                     "--trace", "0"]) != 0
    assert capsys.readouterr().out == ""
