"""ssd_scan_roofline: kernels 8, 8b and 8c (``ssd_*_kernel`` in the trace)
together: the least time of the scan's forward and backward, once a layer
and microbatch of every step in the traced window, over their device
time, in %.  The least time counts the chunked scan's logical float32
operations at the bf16 peak and its inputs and outputs at 3.35 TB/s
(yardstick ``ssd_fwd_bwd``); a forward run again by recomputation is
device time, not work."""

from port_bench.yardstick import least_s, ssm_dims, ssd_fwd_bwd


def read(ctx):
    steps = getattr(ctx.obs, "steps", None)
    if ctx.trace is None or not steps:
        return None
    _, secs = ctx.trace.matching("ssd_", "_kernel")
    if not secs:
        return None
    m, tr = ctx.cell.cfg["model"], ctx.cell.traffic
    s = m["ssm"]
    _, heads, _ = ssm_dims(m)
    mb = tr["microbatch"] or tr["global_batch"]
    one = least_s(*ssd_fwd_bwd(mb, tr["seq_len"], heads, s["head_dim"], s["state_dim"],
                               s["ngroups"]))
    calls = len(steps) * m["num_layers"] * (tr["global_batch"] // mb)
    return 100.0 * calls * one / secs
