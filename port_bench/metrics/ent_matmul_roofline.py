"""ent_matmul_roofline: kernel 1 (``ent_matmul_packed_fused``: bf16 X over
two packed digit planes, its int8 tensor-core loop ``tc_kernel`` and its
split-K stream ``stream_kernel`` in the trace), the least time of the
window's work over the device time of all its launches, in %.

The work is counted from the calls the window made, never from the
launches: each prefill chunk's real prompt rows (not the rows padding its
window to the chunk grid) and each decode tick's rows of requests that
are decoding, through every quantized projection of every layer.  A
projection's least time is one logical w8a8 product, 2 M K N at the int8
peak, or its bytes (bf16 X, one byte a weight, the scales, the f32
output) at 3.35 TB/s, whichever is longer.  So fusing projections,
splitting one over more launches, or moving rows between the two loops
leaves the count as it is."""

from port_bench.yardstick import dense_projections, least_s, w8a8_matmul

KERNEL1 = ("tc_kernel<__nv_bfloat16, 2, 4,", "stream_kernel<__nv_bfloat16, 2, 4,")


def read(ctx):
    obs = getattr(ctx, "obs", None)
    if ctx.trace is None or not hasattr(obs, "chunks"):
        return None
    secs = sum(ctx.trace.matching(name)[1] for name in KERNEL1)
    m = ctx.cell.cfg["model"]
    projs = dense_projections(m)
    rows = ([real for t, _, real, _ in obs.chunks if obs.in_window(t)]
            + [live for t, _, live, _ in obs.decodes if obs.in_window(t) and live])
    if not secs or not rows:
        return None
    least = sum(least_s(*w8a8_matmul(r, k, n)) for r in rows for k, n in projs)
    return 100.0 * m["num_layers"] * least / secs
