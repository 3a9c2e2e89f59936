"""Where the time of the gallery top-k kernel goes, on the card.

    python -m facerec_torch.k1_breakdown

Builds two versions of ``csrc/gallery_topk.cu``: as shipped, and with the
per-tile epilogue of the bf16 kernel skipped (its results are then wrong:
it times the copies and products alone). Times both with CUDA events at
384 unit queries, k 5, bf16 galleries of 1,024 / 131,072 / 1,048,576 rows
half filled, and prints one JSON line per size with the card's name and
power limit. Needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import json
import subprocess

import torch

from facerec_torch import build
from facerec_torch.ops import kernels
from facerec_torch.ops.gallery import bf16_splits

EPILOGUE_START = "    wgmma_wait<0>();\n"
SIZES = ((1024, 512), (131072, 65536), (1 << 20, 524288))


def _variants() -> dict[str, str]:
    src = (build.CSRC / "gallery_topk.cu").read_text()
    if src.count(EPILOGUE_START) != 1:
        raise RuntimeError("gallery_topk.cu no longer has the epilogue this tool skips")
    return {"shipped": src,
            "no_epilogue": src.replace(EPILOGUE_START,
                                       EPILOGUE_START + "    if (count >= 0) continue;\n")}


def _compile(variants: dict[str, str]) -> dict:
    out = build.BUILD_DIR / "k1_breakdown"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in variants.items():
        (out / f"{name}.cu").write_text(text)
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", str(out / f"lib{name}.so"),
               str(out / f"{name}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        k1 = kernels.TABLE["gallery_topk"]
        libs[name] = build.function(out / f"lib{name}.so", k1.symbol, k1.argtypes)
    return libs


def _time_ms(fn, iters: int) -> float:
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


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("k1_breakdown measures the CUDA card and none is present")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    launchers = _compile(_variants())
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def unit(rows: int) -> torch.Tensor:
        x = torch.randn(rows, 512, generator=gen, device=dev)
        return x / x.norm(dim=1, keepdim=True)

    q = unit(384)
    gallery = torch.empty(SIZES[-1][0], 512, dtype=torch.bfloat16, device=dev)
    for r in range(0, gallery.shape[0], 1 << 17):
        gallery[r:r + (1 << 17)] = unit(1 << 17).to(torch.bfloat16)
    b, k = q.shape[0], 5
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    stream = torch.cuda.current_stream(dev).cuda_stream
    for rows, count in SIZES:
        nsplit = bf16_splits(b, rows, sms)
        cnt = torch.tensor(count, dtype=torch.int32, device=dev)
        cand_v = torch.empty(b, nsplit, k, device=dev)
        cand_i = torch.empty(b, nsplit, k, dtype=torch.int32, device=dev)
        out_v = torch.empty(b, k, device=dev)
        out_i = torch.empty(b, k, dtype=torch.int32, device=dev)
        row = {"rows": rows, "count": count, "queries": b, "k": k, "card": card}
        for name, fn in launchers.items():
            def call(fn=fn):
                build.check(fn(q.data_ptr(), gallery.data_ptr(), 1, cnt.data_ptr(), b, rows,
                               512, k, 0, nsplit, cand_v.data_ptr(), cand_i.data_ptr(),
                               out_v.data_ptr(), out_i.data_ptr(), stream), name)
            row[f"{name}_ms"] = _time_ms(call, 50 if rows <= 1024 else 20)
        row["epilogue_share"] = 1.0 - row["no_epilogue_ms"] / row["shipped_ms"]
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
