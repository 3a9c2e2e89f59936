"""k2.roofline: the align's rotation kernel's share of its roofline, % of
its least time (``flops.k2_bound_s``: the bf16 patches read and crops
written at the HBM peak) over its device time a launch (torch.profiler,
kernels named ``shear_rotate``). Null where no such kernel ran."""

from perfbench import flops, trace


def read(ctx):
    prof = ctx.get("profile")
    if prof is None:
        return None
    secs, n = trace.device_seconds(prof, "shear_rotate")
    if n == 0 or secs <= 0:
        return None
    t, c = ctx["traffic"], ctx["config"]
    crop = c["embedder"]["crop"]
    bound = flops.k2_bound_s(t["batch"] * c["detector"]["max_faces"], flops.align_patch(crop),
                             crop)
    return 100.0 * bound / (secs / n)
