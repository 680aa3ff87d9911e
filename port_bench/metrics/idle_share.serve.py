"""idle_share.serve: the share of the traced window in which no operation
ran on the device, in %."""


def read(ctx):
    if ctx.trace is None or not hasattr(ctx.obs, "requests"):
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
