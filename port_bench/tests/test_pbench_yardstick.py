"""The frozen arithmetic against hand-worked shapes, and the window
arithmetic of the metric readers on planted observations."""

import math
from types import SimpleNamespace

import pytest

from port_bench import cell as cells, serve, train, yardstick as Y
from port_bench.trace import Trace

QWEN = cells.load("qwen-ent.longdoc").cfg["model"]
MAMBA = cells.load("mamba2.train4k").cfg["model"]


def test_w8a8_is_one_logical_product():
    ops, nbytes = Y.w8a8_matmul(4096, 2048, 11008)
    assert ops == {"int8": 2 * 4096 * 2048 * 11008}          # not one a digit plane
    assert nbytes == 4096 * 2048 * 2 + 2048 * 11008 + 4 * (4096 + 11008) + 4096 * 11008 * 4
    # compute-bound at a chunk, memory-bound at a decode row
    assert Y.least_s(ops, nbytes) == pytest.approx(ops["int8"] / 1979e12)
    ops1, nb1 = Y.w8a8_matmul(1, 2048, 11008)
    assert Y.least_s(ops1, nb1) == pytest.approx(nb1 / 3.35e12)


def test_qwen_projections_and_params():
    projs = Y.dense_projections(QWEN)
    assert projs == [(2048, 2048), (2048, 256), (2048, 256), (2048, 2048),
                     (2048, 11008), (2048, 11008), (11008, 2048)]
    per_layer = sum(k * n for k, n in projs)
    assert per_layer == 77_070_336
    from repro_torch.configs.base import ModelConfig

    port = ModelConfig(**QWEN)
    assert Y.param_count(QWEN) == port.param_count()


def test_mamba2_params_match_the_planner():
    from repro_torch.configs.base import ModelConfig, SSMConfig

    port = ModelConfig(**dict(MAMBA, ssm=SSMConfig(**MAMBA["ssm"])))
    assert Y.param_count(MAMBA) == port.active_param_count()
    assert Y.train_flops(MAMBA, 32768) == 6 * port.active_param_count() * 32768


def test_ssd_counts_by_hand():
    ops, nbytes = Y.ssd_fwd_bwd(4, 4096, 32, 64, 128)
    q, nc, pairs = 128, 32, 128 * 129 // 2
    fwd = 4 * 32 * nc * (2 * pairs * (128 + 64) + 4 * q * 64 * 128)
    bst = 4 * 32 * (nc - 1) * 2 * q * 64 * 128
    bch = 4 * 32 * nc * (2 * pairs * (2 * 64 + 3 * 128) + 6 * q * 64 * 128)
    assert ops == {"bf16": fwd + bst + bch}
    xb, dtb, bcb, st = 4 * 4096 * 32 * 64, 4 * 4096 * 32, 4 * 4096 * 128, 4 * 32 * nc * 64 * 128
    assert nbytes == 4 * ((2 * xb + dtb + 32 + 2 * bcb + st) + (dtb + 32 + bcb + xb + st)
                          + (3 * xb + 2 * dtb + 64 + 4 * bcb + 2 * st))
    # the program's own count is three split-bf16 passes of the same products
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    import torch

    x = torch.empty((4, 4096, 32, 64), device="meta")
    dt = torch.empty((4, 4096, 32), device="meta")
    b = torch.empty((4, 4096, 1, 128), device="meta")
    a = torch.empty((32,), device="meta")
    prog = ssd_ops.cost("ssd_scan", x, dt, a, b, b)
    assert prog[0][1]["bf16"] == 3 * fwd


def test_attention_pairs():
    assert Y.attention_pairs(4, 0) == 10
    assert Y.attention_pairs(4096, 4096) == 4096 * 4096 + 4096 * 4097 // 2


def test_percentile_nearest_rank():
    xs = list(range(1, 101))
    assert Y.percentile(xs, 95) == 95 and Y.percentile(xs, 50) == 50
    assert Y.percentile([3.0], 95) == 3.0


# --- window arithmetic ------------------------------------------------------------

def _serve_ctx(stall: float = 0.0):
    """Four clients, tokens every 0.1 s over a 10 s window opening at t=100
    (with a stall of ``stall`` s planted at t=105), a chunk of 1,000 real
    rows a second."""
    cell = cells.load("qwen-ent.longdoc")
    obs = serve.Observed(t_open=100.0, t_close=110.0 + stall)
    for c in range(4):
        r = serve.Req(c, [1] * 100, 1000, submit=99.0)
        t = 99.5
        while t < 110.0 + stall:
            r.times.append(t)
            t += 0.1 + (stall if 105.0 <= t < 105.1 else 0.0)
        obs.requests.append(r)
    obs.chunks = [(100.0 + i, 4096, 1000, 0) for i in range(10)]
    obs.ticks = [(100.0 + 0.1 * i, 100.05 + 0.1 * i) for i in range(100)]
    return SimpleNamespace(cell=cell, obs=obs, trace=None, setup_s=1.0, peak_bytes=2**30,
                           window_s=obs.t_close - obs.t_open)


def test_rate_is_all_work_over_all_the_window():
    ctx = _serve_ctx()
    tokens = sum(1 for r in ctx.obs.requests for t in r.times if 100.0 <= t < 110.0)
    assert cells.reader("serve_tok_s")(ctx) == pytest.approx((10 * 1000 + tokens) / 10.0)


def test_tail_is_over_all_gaps_and_a_stall_moves_both():
    calm, stalled = _serve_ctx(), _serve_ctx(stall=3.0)
    itl = cells.reader("itl_p95_ms")
    rate = cells.reader("serve_tok_s")
    assert itl(calm) == pytest.approx(100.0, rel=1e-6)
    # one 3 s gap a client is 4 of ~520 gaps: under the 95th percentile ...
    assert itl(stalled) == pytest.approx(100.0, rel=1e-6)
    # ... and the window's rate falls by the stall's share
    assert rate(stalled) < 0.8 * rate(calm)
    # a stall on every 10th token moves the tail too
    ctx = _serve_ctx()
    for r in ctx.obs.requests:
        r.times = [t + 0.5 * (i // 10) for i, t in enumerate(r.times)]
    assert itl(ctx) == pytest.approx(600.0, rel=1e-6)


def test_train_rate_and_mfu():
    cell = cells.load("mamba2.train4k")
    obs = train.Observed(t_open=0.0, t_close=10.0, steps=[(i * 2.5, (i + 1) * 2.5, 32768)
                                                          for i in range(4)])
    tr = Trace(busy_s=9.5, window_s=10.0, kernels={"ssd_states_kernel<false>": [10, 1.0]})
    ctx = SimpleNamespace(cell=cell, obs=obs, trace=tr, setup_s=1.0, peak_bytes=1,
                          window_s=10.0)
    assert cells.reader("train_tok_s")(ctx) == pytest.approx(4 * 32768 / 10.0)
    mfu = cells.reader("mfu.train")(ctx)
    assert mfu == pytest.approx(100 * Y.train_flops(cell.cfg["model"], 4 * 32768) / 989e12 / 10)
    assert cells.reader("idle_share.train")(ctx) == pytest.approx(5.0)
    ssd = cells.reader("ssd_scan_roofline")(ctx)
    one = Y.least_s(*Y.ssd_fwd_bwd(4, 4096, 32, 64, 128))
    assert ssd == pytest.approx(100 * 4 * 48 * 2 * one / 1.0)


def test_readers_read_nothing_outside_their_cells():
    ctx = _serve_ctx()
    for name in ("train_tok_s", "mfu.train", "ssd_scan_roofline", "idle_share.train"):
        assert cells.reader(name)(ctx) is None
    for name in ("mfu.serve", "ent_matmul_roofline", "launches_per_tick.serve"):
        assert cells.reader(name)(ctx) is None      # untraced


TC = "void ent_tc::tc_kernel<__nv_bfloat16, 2, 4, float>(__nv_bfloat16 const*, ...)"
STREAM = "void ent_stream::stream_kernel<__nv_bfloat16, 2, 4, 8, float>(__nv_bfloat16 const*, ...)"


def test_kernel1_roofline_counts_the_work_not_the_launches():
    """Ten chunks of 1,000 real rows and 100 decode ticks of 4 live rows:
    the same work read the same however many launches carry it, on
    whichever loop, and however far the chunks were padded."""
    ctx = _serve_ctx()
    ctx.obs.decodes = [(100.05 + 0.1 * i, 16, 4, 1600) for i in range(100)]
    projs = Y.dense_projections(QWEN)
    least = 36 * sum(10 * Y.least_s(*Y.w8a8_matmul(1000, k, n))
                     + 100 * Y.least_s(*Y.w8a8_matmul(4, k, n)) for k, n in projs)
    secs = 4 * least
    kernel4 = "void ent_tc::tc_kernel<signed char, 2, 4, float>(signed char const*, ...)"
    traces = [{TC: [7 * 36 * 110, secs]},                       # a launch a projection
              {TC: [4 * 36 * 110, secs]},                       # QKV and gate / up fused
              {TC: [14 * 36 * 110, secs]},                      # each split in two
              {TC: [7 * 36 * 10, 0.8 * secs], STREAM: [7 * 36 * 100, 0.2 * secs]},
              {TC: [7 * 36 * 110, secs], kernel4: [99, 5.0]}]   # not kernel 1
    reader = cells.reader("ent_matmul_roofline")
    for kernels in traces:
        ctx.trace = Trace(busy_s=5.0, window_s=10.0, kernels=kernels)
        assert reader(ctx) == pytest.approx(25.0)
    ctx.obs.chunks = [(t, 2048, real, pos0) for t, _, real, pos0 in ctx.obs.chunks]
    assert reader(ctx) == pytest.approx(25.0)
    assert math.isfinite(cells.reader("mfu.serve")(ctx))
