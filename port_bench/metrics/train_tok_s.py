"""train_tok_s: tokens of the optimizer steps run in the window (a whole
number of steps, each ended by a device synchronisation), over the
window."""


def read(ctx):
    steps = getattr(ctx.obs, "steps", None)
    if not steps:
        return None
    return sum(n for _, _, n in steps) / ctx.window_s
