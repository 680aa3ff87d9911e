"""ttft_p50_ms.serve: the median (nearest rank) of the time from a
client's submit to its first token, over the requests whose first token
came in the window (the scheduler's queue wait and chunked admission)."""

from port_bench.yardstick import percentile


def read(ctx):
    obs = getattr(ctx, "obs", None)
    if not hasattr(obs, "requests"):
        return None
    ttft = [r.times[0] - r.submit for r in obs.requests if r.times and obs.in_window(r.times[0])]
    return 1e3 * percentile(ttft, 50) if ttft else None
