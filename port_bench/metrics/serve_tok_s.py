"""serve_tok_s: prompt tokens prefilled (the real rows of every prefill
chunk dispatched in the window) plus tokens generated (every token a
client received in the window), over the window."""


def read(ctx):
    obs = getattr(ctx, "obs", None)
    if not hasattr(obs, "requests"):
        return None
    prompt = sum(real for t, _, real, _ in obs.chunks if obs.in_window(t))
    out = sum(1 for r in obs.requests for t in r.times if obs.in_window(t))
    return (prompt + out) / ctx.window_s
