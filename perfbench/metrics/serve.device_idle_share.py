"""serve.device_idle_share: % of the profiled window in which no operation
ran on the card (one minus the union of the device operations' intervals
over the window's wall time, torch.profiler)."""


def read(ctx):
    prof = ctx.get("profile")
    if prof is None or prof["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
