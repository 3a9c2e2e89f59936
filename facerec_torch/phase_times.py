"""Seconds per phase of a ``chip_smoke.py`` run, from the time each line of
its output arrives.

    python -m facerec_torch.phase_times [--log FILE] -- python3 chip_smoke.py

Runs the command (standard error merged into standard output, Python's
output unbuffered), passes every line through, to FILE too, and then prints
one ``phases:`` JSON line: for each phase the seconds from the end of the
phase before it to the last line that belongs to it, and the command's
total. A line belongs to a phase by its prefix (``PHASES``); a phase that
an older version of the script lacks is absent, so two versions run in one
call can be set side by side. Exits with the command's exit code. Imports
nothing of the package, so it can time a checkout of another version by
its path.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

# (phase, prefix of the lines that end it), in the order the script runs them;
# the train, eval, zoo and tune phases print their lines together at the end
# of the four (``tune: phase`` is the last), and report their own seconds.
PHASES = (
    ("build", "build: "),
    ("k1_checks", "K1 near-tie slots"),
    ("k1_times", "K1 time:"),
    ("k2_checks_and_render", "rendered "),
    ("serve", "serve: {"),
    ("serve_1048576", "serve_1048576: {"),
    ("serve_precise", "serve_precise: {"),
    ("serve_facenet", "serve_facenet: {"),
    ("serve_trained", "serve_trained beside serve: "),
    ("mesh", "mesh: phase"),
    ("fold", "fold: phase"),
    ("train_eval_zoo_tune", "tune: phase"),
    ("prep_and_detector", "prep + detector:"),
    ("demo", "demo: {"),
    ("kernel_rows", "script: "),
)


def phase_seconds(stamped: list[tuple[float, str]], total: float) -> dict:
    """``stamped``: (seconds since the start, line). Each phase ends at the
    last line with its prefix; it lasts from the end of the phase before."""
    ends = {}
    for t, line in stamped:
        for name, prefix in PHASES:
            if line.startswith(prefix):
                ends[name] = t
    out, before = {}, 0.0
    for name, t in sorted(ends.items(), key=lambda kv: kv[1]):
        out[name] = round(t - before, 2)
        before = t
    out["rest"] = round(total - before, 2)
    out["total"] = round(total, 2)
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--log", help="also write the command's output here")
    ap.add_argument("command", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    cmd = args.command[1:] if args.command[:1] == ["--"] else args.command
    if not cmd:
        ap.error("no command given")
    log = open(args.log, "w") if args.log else None
    t0 = time.perf_counter()
    stamped = []
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            env=os.environ | {"PYTHONUNBUFFERED": "1"})
    for line in proc.stdout:
        stamped.append((time.perf_counter() - t0, line))
        sys.stdout.write(line)
        if log:
            log.write(line)
    rc = proc.wait()
    total = time.perf_counter() - t0
    if log:
        log.close()
    print("phases: " + json.dumps(phase_seconds(stamped, total) | {"rc": rc}), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
