"""mfu.serve: the least time of each modelled call of the window, summed,
over the traced window, in %.  A call's least time (yardstick
``serve_call_least_s``) counts its useful rows only: a prefill chunk's real
prompt rows and their kept (query, key) pairs, a decode tick's rows of
requests that are decoding and the cached rows they read; the
projections at the int8 peak, attention and the LM head at the bf16 peak,
each weight, cached row and activation read once at 3.35 TB/s."""

from port_bench.yardstick import attention_pairs, serve_call_least_s


def read(ctx):
    obs = getattr(ctx, "obs", None)
    if ctx.trace is None or not hasattr(obs, "chunks"):
        return None
    m = ctx.cell.cfg["model"]
    least = 0.0
    for t, _, real, pos0 in obs.chunks:
        if obs.in_window(t):
            least += serve_call_least_s(m, real, attention_pairs(real, pos0), pos0, 1)
    for t, _, live, cached in obs.decodes:
        if obs.in_window(t) and live:
            least += serve_call_least_s(m, live, cached, cached, live)
    return 100.0 * least / ctx.trace.window_s
