"""k1.roofline: the gallery top-k kernel's share of its roofline, % of
its least time (``flops.k1_bound_s``: 2 Q N D products at the bf16 peak, or
the enrolled rows, queries and answers at the HBM peak) over its device
time a launch (its partial and merge kernels, torch.profiler). Null where
no such kernel ran."""

from perfbench import flops, trace


def read(ctx):
    prof = ctx.get("profile")
    if prof is None:
        return None
    secs, n = trace.device_seconds(prof, "topk_partial", "topk_merge")
    if n == 0 or secs <= 0:
        return None
    t, c = ctx["traffic"], ctx["config"]
    q = t["batch"] * c["detector"]["max_faces"]
    bound = flops.k1_bound_s(q, t["enrolled"], c["embedder"]["embedding_dim"],
                             c["serve"]["top_k"])
    return 100.0 * bound / (secs / n)
