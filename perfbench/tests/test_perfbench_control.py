"""The control, the plain reference put in the program's place and
computed in fp8 (the step below the configurations' bf16), comes out not
correct: at a small size on the CPU, and on one card at each cell's own
size on three seeds (marked ``cuda``; it skips without a card). The
control runs the reference only, so a four-card cell's reads on one card
too. The train cells' planted faults likewise come out not correct."""

from __future__ import annotations

import pytest
import torch

from perfbench import control, harness
from perfbench.tests.small import small

SPEC = harness.load_spec()
SERVE = [w["name"] for w in SPEC["workloads"]
         if harness.cell(w["name"])["traffic"]["driver"] == "serve"]
TRAIN = [w["name"] for w in SPEC["workloads"]
         if harness.cell(w["name"])["traffic"]["driver"] == "train"]


def _numbers(cell: dict, seed: int, device, **kw) -> dict:
    if cell["traffic"]["driver"] == "train":
        return control.train_control_numbers(cell, seed, device, **kw)
    return control.control_numbers(cell, seed, device)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.parametrize("name", SERVE + TRAIN)
def test_the_control_is_not_correct_at_a_small_size(name):
    torch.set_num_threads(4)
    c = small(name)
    ok, checks = harness.decide(c["limits"], _numbers(c, 2 ** 31 + 17, "cpu"), 0)
    assert not ok, checks


@pytest.mark.parametrize("name", TRAIN)
@pytest.mark.parametrize("fault", ["half_batch", "no_exchange"])
def test_a_planted_fault_is_not_correct_at_a_small_size(name, fault):
    torch.set_num_threads(4)
    c = small(name)
    if fault == "no_exchange" and c["traffic"].get("ranks", 1) == 1:
        pytest.skip("one rank exchanges nothing")
    ok, checks = harness.decide(c["limits"], _numbers(c, 2 ** 31 + 19, "cpu", fault=fault), 0)
    assert not ok, checks


@pytest.mark.cuda
@pytest.mark.parametrize("name", SERVE + TRAIN)
@pytest.mark.parametrize("seed", [5000000001, 5000000002, 5000000003])
def test_the_control_is_not_correct_at_the_cell_size(card, name, seed):
    c = harness.cell(name)
    ok, checks = harness.decide(c["limits"], _numbers(c, seed, card), 0)
    assert not ok, checks
