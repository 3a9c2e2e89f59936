"""The NMS of the PyTorch port (``facerec_torch``) on one CUDA card: the
whole call at each of the serve step's five sites and the serve step around
it, for the package of a checkout; or the kernel at forced block sizes.

    python3 tools/torch_nms_times.py [--root DIR] [--out FILE]
    python3 tools/torch_nms_times.py --warps 1,2,4,8,16,32 [--out FILE]

Builds the checkout's kernels, prepares ``bench``'s pipeline and frames
(``facerec_torch.bench.prepare``: 48 frames of 480 x 640, 8 faces each),
records the arguments of the five ``nms`` calls of one eager detect of the
frames, and prints one JSON line: for each call its rows, boxes and mode,
the device ms of the whole call (torch.profiler over 10 calls: every kernel
from the overlap to the keep and the top-k after it) and the kernels it
launches, with its CUDA-event ms; their sums per step; the captured serve
step's device ms (torch.profiler over 3 replays); and ``bench``'s faces/s and
device ms per step (``bench.measure``). The card's name and power limit go
in the line. It imports the package only from ``--root`` (default: the
checkout holding this file), so run it by its path to time two checkouts
in one call, in turns (parent, change, change, parent).

``--warps``: this checkout's NMS kernel at each of the five calls, built
once more from an edited copy of ``csrc/nms_fixed_point.cu`` for each block
size (its launcher's rule, then the given warps a block, clamped to [W, 32]
as the launcher clamps; into ``build/nms_warps/``, which ``.gitignore``
covers), each launch held bit for bit against the plain version; one JSON
line a site with the kernel's device ms (profiler, 20 calls) at the
launcher's choice and at each forced size.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
SITES = ("per_scale", "cross_scale", "rnet", "large_face", "final")
CALLS = 10  # profiled calls of each site's nms
# the launcher's last clamps: an edited copy forces the block size just before them
CLAMP = "  if (warps > 32) warps = 32;\n"


def _import_from(root: Path) -> None:
    """Put ``root`` first on the path, and this file's directory off it."""
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
    sys.path.insert(0, str(root))


def _device_ms(fn, calls: int, name: str = "") -> tuple[float, float]:
    """(device ms per call, kernels per call) over ``calls`` calls of ``fn``,
    of the CUDA kernels whose names contain ``name``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and name in e.key]
    return (sum(e.self_device_time_total for e in kernels) / calls / 1e3,
            sum(e.count for e in kernels) / calls)


def _event_ms(fn, iters: int = 50) -> float:
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def run(root: Path) -> dict:
    import torch

    from facerec_torch import bench, build
    from facerec_torch.detect import mtcnn

    if not torch.cuda.is_available():
        raise RuntimeError("nms_times measures the card: no CUDA card here")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build()
    pipe, frames = bench.prepare(device="cuda")
    x = pipe.upload(frames)

    calls, real = [], mtcnn.nms

    def recording(*args, **kwargs):
        calls.append((tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args),
                      kwargs))
        return real(*args, **kwargs)

    mtcnn.nms = recording
    try:
        with torch.no_grad():
            pipe.detector.detect(x)
    finally:
        mtcnn.nms = real
    if len(calls) != len(SITES):
        raise AssertionError(f"the detect made {len(calls)} nms calls, not {len(SITES)}")

    sites = []
    for site, (args, kwargs) in zip(SITES, calls):
        def fn(args=args, kwargs=kwargs):
            return real(*args, **kwargs)

        device_ms, kernels = _device_ms(fn, CALLS)
        valid = args[2]
        sites.append({"site": site, "rows": valid.numel() // valid.shape[-1],
                      "boxes": valid.shape[-1], "mode": args[4] if len(args) > 4 else "union",
                      "device_ms": device_ms, "kernels_per_call": kernels,
                      "event_ms": _event_ms(fn)})
    out, note = bench.measure(pipe, frames)
    serve_ms, _ = _device_ms(lambda: pipe.run_step(x), 3)
    return {"root": str(root), "card": bench.card_label(pipe.device), "sites": sites,
            "nms_device_ms_per_step": sum(s["device_ms"] for s in sites),
            "nms_event_ms_per_step": sum(s["event_ms"] for s in sites),
            "nms_kernels_per_step": sum(s["kernels_per_call"] for s in sites),
            "serve_device_ms_per_step": serve_ms,
            "bench_faces_per_sec": out["value"], "bench_detected": out["detected"],
            "bench_device_ms_per_step": note["device_ms_per_step"]}


def _forced_launchers(root: Path, warps: list[int]) -> dict:
    """``nms_suppress_launch`` of an edited copy of the checkout's kernel
    source for each forced block size, all built at once."""
    import ctypes
    import subprocess

    from facerec_torch import build

    src = (root / "facerec_torch" / "csrc" / "nms_fixed_point.cu").read_text()
    if src.count(CLAMP) != 1:
        raise RuntimeError("the launcher's block-size clamp is not where this tool edits it")
    out = root / "build" / "nms_warps"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for w in warps:
        cu, lib = out / f"nms_w{w}.cu", out / f"libnms_w{w}.so"
        cu.write_text(src.replace(CLAMP, f"  warps = {w};\n" + CLAMP))
        procs[w] = (lib, subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
                                           str(cu)], stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
    launchers = {}
    for w, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the copy at {w} warps:\n{log}")
        fn = ctypes.CDLL(str(lib)).nms_suppress_launch
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, i, i, ctypes.c_float, i, p, p, p]
        fn.restype = i
        launchers[w] = fn
    return launchers


def sweep(root: Path, warps: list[int]) -> list[dict]:
    import torch

    from facerec_torch import bench, build
    from facerec_torch.multichip import record_nms
    from facerec_torch.ops.nms import MODES, nms_suppress, nms_suppress_plain

    if not torch.cuda.is_available():
        raise RuntimeError("the sweep measures the card: no CUDA card here")
    build.build()
    launchers = _forced_launchers(root, warps)
    pipe, frames = bench.prepare(device="cuda")
    calls = record_nms(pipe, pipe.upload(frames))
    if len(calls) != len(SITES):
        raise AssertionError(f"the detect made {len(calls)} nms calls, not {len(SITES)}")
    card = bench.card_label(pipe.device)
    rows = []
    for site, (boxes, s0, valid, threshold, mode) in zip(SITES, calls):
        m, n = s0.shape
        ref = nms_suppress_plain(boxes, s0, valid, threshold, mode)

        def forced(launch, boxes=boxes, s0=s0, valid=valid, threshold=threshold, mode=mode):
            keep = torch.empty((m, n), dtype=torch.bool, device=boxes.device)
            rounds = torch.empty((m,), dtype=torch.int32, device=boxes.device)
            err = launch(boxes.data_ptr(), s0.data_ptr(), valid.data_ptr(), m, n,
                         float(threshold), MODES.index(mode), keep.data_ptr(),
                         rounds.data_ptr(), torch.cuda.current_stream().cuda_stream)
            build.check(err, "nms_suppress (forced block size)")
            return keep, rounds

        variants = {"launcher": lambda args=(boxes, s0, valid, threshold, mode):
                    nms_suppress(*args)}
        variants |= {str(w): lambda fn=fn: forced(fn) for w, fn in launchers.items()}
        times = {}
        for key, fn in variants.items():
            keep, rounds = fn()
            if not (torch.equal(keep, ref[0]) and torch.equal(rounds, ref[1])):
                raise AssertionError(f"the NMS kernel at {key} warps a block disagrees ({site})")
            times[key] = _device_ms(fn, 20, "nms_suppress")[0]
        rows.append({"site": site, "rows": m, "boxes": n, "mode": mode,
                     "device_ms_by_warps": times, "card": card})
    return rows


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="python3 tools/torch_nms_times.py",
                                description="the NMS calls and the serve step of a checkout")
    p.add_argument("--root", default=str(HERE.parent), help="the checkout to time")
    p.add_argument("--warps", default=None,
                   help="comma-separated warps a block: time the kernel at each instead")
    p.add_argument("--out", default=None, help="also append the JSON lines to this file")
    args = p.parse_args(argv)
    root = Path(args.root).resolve()
    _import_from(root)
    t0 = time.perf_counter()
    if args.warps:
        results = sweep(root, [int(w) for w in args.warps.split(",")])
    else:
        results = [run(root)]
        results[0]["seconds"] = time.perf_counter() - t0
    lines = [json.dumps(r) for r in results]
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            f.write("".join(line + "\n" for line in lines))
    for line in lines:
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
