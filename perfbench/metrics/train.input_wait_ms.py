"""train.input_wait_ms: the mean host-clock span of ``next()`` on
``prefetch_to_device`` over the window's steps: how long the step waited
for its batch."""


def read(ctx):
    v = ctx["spans"].mean("train.input_wait")
    return None if v is None else v * 1e3
