"""A train run on the CPU at a small size, driven as on the card but for
the look for a card, with the timed path broken underneath: each fault
that a train cell can have makes ``correct`` false. A four-card cell runs
as four gloo ranks on the CPU."""

from __future__ import annotations

import time

import pytest
import torch

from perfbench import harness
from perfbench.drivers import train
from perfbench.tests.small import small

SPEC = harness.load_spec()
CELLS = [w["name"] for w in SPEC["workloads"]
         if harness.cell(w["name"])["traffic"]["driver"] == "train" and w["chips"] == 1]
MESH_CELLS = [w["name"] for w in SPEC["workloads"]
              if harness.cell(w["name"])["traffic"]["driver"] == "train" and w["chips"] > 1]
SEED = 2 ** 31 + 91


def correct_after_run(c: dict, target=None) -> tuple[bool, dict]:
    if c["traffic"].get("ranks", 1) > 1:
        out = train.spawn(c, [SEED], 0.3, False, time.perf_counter(), "gloo", target)[SEED]
    else:
        out = train.run(c, SEED, 0.3, False, time.perf_counter(), "cpu")
    return harness.decide(c["limits"], out["numbers"], out["failed"])[0], out["numbers"]


def _no_exchange_rank(*args):
    """A rank whose step leaves out the exchange between ranks: BatchNorm
    over its own slice, its own gradient."""
    from facerec_torch.models import resnet
    from facerec_torch.train import steps

    resnet.sharded_data_mesh = lambda: None
    steps._psum_grads = lambda grads, mesh: grads
    train._rank_main(*args)


def _rank_that_loads_the_jax_package(rank, *args):
    """A rank that has the JAX package loaded once its window has closed."""
    import sys
    import types

    if rank == 1:
        sys.modules["facerec_tpu"] = types.ModuleType("facerec_tpu")
    train._rank_main(rank, *args)


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", CELLS)
def test_a_step_that_leaves_the_state_unchanged_is_caught(monkeypatch, name):
    from facerec_torch.train import state

    monkeypatch.setattr(state.OptaxChain, "step", lambda self, grads: None)
    ok, numbers = correct_after_run(small(name))
    assert not ok and numbers["change_gap_median"] > 0.9


@pytest.mark.parametrize("name", CELLS)
def test_half_the_batch_left_out_is_caught(monkeypatch, name):
    from facerec_torch.train import steps

    orig = steps.get_criterion

    def half(model_type):
        loss_fn = orig(model_type)

        def masked(outputs, batch, mask=None):
            m = torch.zeros(outputs.shape[0], device=outputs.device)
            m[: outputs.shape[0] // 2] = 1.0
            return loss_fn(outputs, batch, m)
        return masked
    monkeypatch.setattr(steps, "get_criterion", half)
    assert not correct_after_run(small(name))[0]


@pytest.mark.parametrize("name", CELLS + MESH_CELLS)
def test_a_sound_run_is_correct(name):
    ok, numbers = correct_after_run(small(name))
    assert ok, numbers


@pytest.mark.parametrize("name", CELLS + MESH_CELLS)
def test_the_program_in_f32_agrees_with_the_reference_on_step_one(name):
    c = small(name)
    c["config"]["train"]["compute_dtype"] = "float32"
    numbers = correct_after_run(c)[1]
    assert numbers["grad_gap"] < 1e-4 and numbers["grad_norm_gap_first"] < 1e-5, numbers


@pytest.mark.parametrize("name", MESH_CELLS)
def test_the_exchange_between_ranks_left_out_is_caught(name):
    assert not correct_after_run(small(name), _no_exchange_rank)[0]


@pytest.mark.parametrize("name", MESH_CELLS)
def test_a_rank_that_loaded_the_jax_package_prints_no_result(capsys, name):
    c = small(name)
    out = train.spawn(c, [SEED], 0.3, False, time.perf_counter(), "gloo",
                      _rank_that_loads_the_jax_package)[SEED]
    assert out["forbidden"] == ["facerec_tpu"]
    assert harness.emit(c, out, traced=False) != 0
    captured = capsys.readouterr()
    assert captured.out == "" and "facerec_tpu" in captured.err
