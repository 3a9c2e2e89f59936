"""train.mfu: the train step's share of the cards' bf16 peak, %: 3 x the
forward FLOPs of the model an image (the embedder kind's ``train_macs``,
the benchmark's own count) x the window's images, over the window's
seconds x the cards x 989 TFLOP/s."""

from perfbench import flops


def read(ctx):
    f = ctx.get("flops_per_image")
    w = ctx["window"]
    if f is None or not w.get("images"):
        return None
    return 100.0 * f * w["images"] / (w["seconds"] * ctx["chips"] * flops.PEAK_BF16_FLOPS)
