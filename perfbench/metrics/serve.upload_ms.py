"""serve.upload_ms: the mean host-clock span of ``FacePipeline.upload`` over
the window's requests (the frames' copy into pinned memory and the queued
copy to the card)."""


def read(ctx):
    v = ctx["spans"].mean("serve.upload")
    return None if v is None else v * 1e3
