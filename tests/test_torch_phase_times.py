"""``facerec_torch.phase_times``: seconds per phase of a chip_smoke run, from
the time its lines arrive."""

import json
import sys

import pytest

from facerec_torch.phase_times import PHASES, main, phase_seconds


def test_phase_seconds_from_the_last_line_of_each_phase():
    stamped = [(1.0, "card: x\n"), (2.0, "build: 2 kernels in 1.0 s\n"),
               (2.5, "build: the JPEG loader did not build\n"), (4.0, "K1 near-tie slots: 0\n"),
               (5.0, "K1 time: {}\n"), (6.0, "K1 time: {}\n"), (9.0, "rendered 48 frames\n"),
               (10.0, "K1 serve: B=384\n"), (12.0, "serve: {}\n"),
               (13.0, "serve_facenet beside serve: {}\n"), (20.0, "tune: phase 3.0 s\n"),
               (21.0, "script: 21.0 s\n")]
    got = phase_seconds(stamped, 22.5)
    assert got == {"build": 2.5, "k1_checks": 1.5, "k1_times": 2.0, "k2_checks_and_render": 3.0,
                   "serve": 3.0, "train_eval_zoo_tune": 8.0, "kernel_rows": 1.0, "rest": 1.5,
                   "total": 22.5}
    assert list(got)[:-2] == [n for n, _ in PHASES if n in got]


def test_phase_seconds_of_the_serve_trained_path():
    """serve_trained ends at its beside-serve line, after the identification
    it prints (its serve line comes first and ends nothing)."""
    stamped = [(1.0, "serve_facenet: {}\n"), (2.0, "serve_trained read: {}\n"),
               (5.0, "serve_trained: {}\n"), (6.0, "serve_trained identify: {}\n"),
               (6.5, "serve_trained beside serve: {}\n"), (9.0, "mesh: phase 2.0 s\n")]
    got = phase_seconds(stamped, 10.0)
    assert got == {"serve_facenet": 1.0, "serve_trained": 5.5, "mesh": 2.5, "rest": 1.0,
                   "total": 10.0}


def test_phase_seconds_of_a_run_that_printed_no_phase():
    assert phase_seconds([(0.5, "card: x\n")], 3.0) == {"rest": 3.0, "total": 3.0}


@pytest.mark.parametrize("rc", [0, 3])
def test_main_passes_the_output_and_exit_code_through(rc, tmp_path, capsys):
    code = ("import sys; print('build: 2 kernels'); print('noise', file=sys.stderr); "
            f"print('rendered 1'); print('script: 1 s'); sys.exit({rc})")
    assert main(["--log", str(tmp_path / "run.log"), "--", sys.executable, "-c", code]) == rc
    out = capsys.readouterr().out.splitlines()
    assert out[:4] == ["build: 2 kernels", "noise", "rendered 1", "script: 1 s"]
    assert (tmp_path / "run.log").read_text().splitlines() == out[:4]
    phases = json.loads(out[4].removeprefix("phases: "))
    assert out[4].startswith("phases: ") and phases["rc"] == rc
    assert set(phases) == {"build", "k2_checks_and_render", "kernel_rows", "rest", "total", "rc"}
    assert phases["total"] >= phases["build"] + phases["k2_checks_and_render"]
