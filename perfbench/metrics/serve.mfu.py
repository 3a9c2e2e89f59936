"""serve.mfu: the whole serve step's share of the card's bf16 peak, %: the
FLOPs a batch needs (``flops.serve_flops``: MTCNN's three nets, the
embedder on every slot, the gallery product) times the window's answered
requests, over the window's seconds times 989 TFLOP/s."""

from perfbench import flops


def read(ctx):
    f = ctx.get("flops_per_request")
    w = ctx["window"]
    if f is None or w["requests"] == 0:
        return None
    return 100.0 * f * w["requests"] / (w["seconds"] * ctx["chips"] * flops.PEAK_BF16_FLOPS)
