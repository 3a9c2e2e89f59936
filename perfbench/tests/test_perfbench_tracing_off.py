"""An untraced run leaves the program's tracing registry
(``facerec_torch.utils.profiling``) off: it never enables it and records
nothing, so the graphs it replays hold no stamp."""

from __future__ import annotations

import time

import pytest
import torch

from perfbench import harness
from perfbench.drivers import serve, train
from perfbench.tests.small import small

SPEC = harness.load_spec()
CELLS = [w["name"] for w in SPEC["workloads"] if w["chips"] == 1]
SEED = 2 ** 31 + 19


@pytest.mark.parametrize("name", CELLS)
def test_an_untraced_run_never_enables_the_registry(monkeypatch, name):
    from facerec_torch.utils import profiling

    def refuse(self):
        raise AssertionError("an untraced run enabled tracing")

    monkeypatch.setattr(profiling.Registry, "enable", refuse)
    profiling.reset()
    torch.set_num_threads(2)
    c = small(name)
    drv = serve if c["traffic"]["driver"] == "serve" else train
    out = drv.run(c, SEED, 0.3, False, time.perf_counter(), "cpu")
    assert out["attempted"] > 0
    assert not profiling.enabled()
    assert profiling.snapshot() == {"spans": [], "counts": []}
