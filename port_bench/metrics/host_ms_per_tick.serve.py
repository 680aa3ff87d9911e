"""host_ms_per_tick.serve: host milliseconds inside ``PipelinedScheduler.tick``
(the benchmark's span around each call) over the ticks of the window."""


def read(ctx):
    obs = getattr(ctx, "obs", None)
    if not hasattr(obs, "ticks"):
        return None
    ticks = [b - a for a, b in obs.ticks if obs.in_window(a)]
    return 1e3 * sum(ticks) / len(ticks) if ticks else None
