"""The benchmark of the PyTorch and CUDA port (``facerec_torch``).

    python3 -m perfbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout, on a machine with as many CUDA cards as
the cell asks for. The last line of standard output is one JSON object
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` also ``breakdown``; ``checks`` last: each number the
comparison read, beside its limit). With ``--trace 0`` the metrics are the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics. The
numbers compared are also the last lines of standard error. With no card,
or fewer than the cell asks for, it prints no result and exits 2.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()  # set-up is timed from here

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "build" / "perfbench_cache"


def _pin_caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout (the
    port's own kernels build into its ``build/``)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda_jit")):
        os.environ[var] = str(CACHE / sub)


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python3 -m perfbench.run", description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    _pin_caches()
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from perfbench import harness

    cell = harness.cell(args.workload)
    import torch

    chips = int(cell["workload"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: {args.workload} needs {chips} CUDA card(s), this machine has {have}",
              file=sys.stderr)
        return 2
    drv = harness.driver(cell["traffic"])
    return drv.main(cell, args.seed, args.seconds, bool(args.trace), T0)


if __name__ == "__main__":
    sys.exit(main())
