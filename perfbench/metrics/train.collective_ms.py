"""train.collective_ms: device ms a step in NCCL's kernels on the slowest
rank (the most device time outside NCCL's kernels: the rank the others
wait for; torch.profiler, kernels whose names hold ``nccl``) over the
profiled steps. Null where no NCCL kernel ran."""

from perfbench import trace


def read(ctx):
    prof = ctx.get("profile")
    if prof is None:
        return None
    secs, n = trace.device_seconds(prof, "nccl")
    if n == 0:
        return None
    return 1e3 * secs / ctx["traffic"]["profiled_steps"]
