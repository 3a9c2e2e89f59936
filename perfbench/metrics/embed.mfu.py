"""embed.mfu: the embed stage's share of the card's bf16 peak, %: the
embedder's FLOPs on every slot of one window batch (2 x its kind's
``macs`` x ``batch`` x ``max_faces``) over the stage's eager time on that
batch (``stages_ms["embed"]``, the serve driver's ``stage_ms``) at 989
TFLOP/s. Null where the run timed no stage."""

from perfbench import embedders, flops


def read(ctx):
    ms = ctx.get("stages_ms", {}).get("embed")
    if not ms:
        return None
    emb = ctx["config"]["embedder"]
    slots = ctx["traffic"]["batch"] * ctx["config"]["detector"]["max_faces"]
    f = 2 * embedders.get(emb["kind"]).macs(emb) * slots
    return 100.0 * f / (ms * 1e-3 * flops.PEAK_BF16_FLOPS)
