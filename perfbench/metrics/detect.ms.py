"""detect.ms: the detect stage run eagerly on one window batch, ms a call by
CUDA events (the serve driver's ``stage_ms``)."""


def read(ctx):
    return ctx.get("stages_ms", {}).get("detect")
