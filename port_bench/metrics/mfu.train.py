"""mfu.train: 6 N D of the steps in the traced window at the bf16 peak
(989 TFLOP/s), over the window, in % (the planner's model FLOPs)."""

from port_bench.yardstick import PEAK_BF16, train_flops


def read(ctx):
    steps = getattr(ctx.obs, "steps", None)
    if ctx.trace is None or not steps:
        return None
    flops = train_flops(ctx.cell.cfg["model"], sum(n for _, _, n in steps))
    return 100.0 * flops / PEAK_BF16 / ctx.trace.window_s
