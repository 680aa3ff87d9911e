"""itl_p95_ms: the 95th percentile (nearest rank) of every gap between two
successive tokens of one request, as its client received them, over all
gaps that end in the window.

Every decoding request gets its token in the same tick, so the gaps are
the ticks' lengths, each counted once a request it served: with a prefill
chunk beside every tick, the top twentieth lies among the ticks beside a
chunk over a long context (about a third of the ticks), and spans some
of the window's slowest ticks rather than the one slowest."""

from port_bench.yardstick import percentile


def read(ctx):
    obs = getattr(ctx, "obs", None)
    if not hasattr(obs, "requests"):
        return None
    gaps = [b - a for r in obs.requests for a, b in zip(r.times, r.times[1:])
            if obs.in_window(b)]
    return 1e3 * percentile(gaps, 95) if gaps else None
