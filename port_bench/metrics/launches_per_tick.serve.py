"""launches_per_tick.serve: device operations (kernels, copies, sets) in the
traced window over the scheduler ticks in it."""


def read(ctx):
    obs = getattr(ctx, "obs", None)
    if ctx.trace is None or not hasattr(obs, "ticks"):
        return None
    ticks = sum(1 for a, _ in obs.ticks if obs.in_window(a))
    return ctx.trace.launches() / ticks if ticks else None
