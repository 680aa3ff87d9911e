#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases (each prints its seconds; any failure exits non-zero):

1. the card (``nvidia-smi`` name and power limit) and torch/CUDA versions;
2. build the three CUDA kernels from ``src/repro_torch/csrc`` (one nvcc
   per source, all at once);
3. hold each kernel against its plain PyTorch version on the card at the
   main path's shapes (kernel 1 bit for bit; kernels 2 and 3 in bf16 and
   float32 within limits derived from the data, see TOL_BF16), check that
   planted faults (a wrong plane code, a wrong mask argument) fail those
   checks, and time kernel, plain version and a library yardstick with
   CUDA events (L2 flushed before every launch);
4. serve 16 ragged greedy requests (prompts 256..512 tokens, 32 new
   tokens each) on EN-T-quantized qwen2.5-3b at full width (36 layers,
   random weights from a seed) through ``repro_torch.launch.serve``'s
   code, asserting every kernel launched and no plain version ran, and
   profile full-batch decode ticks; then one prefill + 4 decode ticks of
   the same widths at 2 layers with the kernels and with the plain
   versions, compared (bf16 and float32 with EN-T weights, float32 with
   float weights), and with planted mask faults that the limits must
   reject;
5. a ``kernels`` JSON line, the card line, and the final result line.

Without a CUDA card it prints nothing but an error and exits 2.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

# published H100 SXM peaks (NVIDIA data sheet, dense, 700 W)
HBM_BYTES_S = 3.35e12
INT8_OPS_S = 1979e12
BF16_FLOPS_S = 989e12
# Kernels 2 and 3 against their plain versions, per element, with a limit
# in units of att|v| = the plain version applied to |v| (sum_j p_j |v_j| /
# l, per output element).  Both sides compute the scores in f32 from the
# same operands and sum the f32 probabilities into l; the value product
# takes the probabilities rounded to the value dtype, the kernel's
# relative to the running max of its kv tile, the plain version's
# relative to the row's final max.  One bf16 rounding moves a value by at
# most 2**-8 of it, so column j's two probabilities differ by at most
# 2**-7 p_j and the outputs by at most 2**-7 att|v|; the flash kernel's
# bf16 output store adds at most 2**-8 |out| <= 2**-8 att|v|.  TOL_BF16
# covers these 3 * 2**-8 and leaves 2**-8 for f32 rounding.  With float32
# operands nothing is rounded to bf16: the sides differ only in the order
# of the 128-term f32 dot products, at worst ~2e-4 att|v| (D * 2**-24 *
# sum_d |q_d k_d| * scale, on both sides); TOL_F32 = 2**-11.  The float32
# check at the same shapes holds the masking sharply: one key more or
# less in a row of N keys moves it by ~|v_j - out| / N, ~6e-3 att|v| at
# N = 128; the planted faults below (must fail) show it on the card.
TOL_BF16 = 2.0**-6
TOL_F32 = 2.0**-11


def phase(name):
    print(f"== {name}", flush=True)
    return time.perf_counter()


def done(t0, name):
    print(f"== {name}: {time.perf_counter() - t0:.2f}s", flush=True)


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


class Timer:
    """Median kernel time in ms over ``reps`` launches, each timed with
    CUDA events and preceded by a 256 MB write that evicts the 50 MB L2
    (weights and KV pages reach the main path's kernels cold)."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")

    def __call__(self, fn, reps=15):
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        evs = []
        for _ in range(reps):
            self.flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            evs.append((s, e))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in evs)


def bound_ms(nbytes, ops, peak_ops):
    tb, to = nbytes / HBM_BYTES_S * 1e3, ops / peak_ops * 1e3
    return max(tb, to), ("bytes" if tb >= to else "operations")


def check_ent_matmul(torch, timer):
    from repro_torch.core.multiplier import ent_packed_planes
    from repro_torch.kernels.ent_matmul.ent_matmul import ent_matmul_packed_fused
    from repro_torch.kernels.ent_matmul.ops import row_scale
    from repro_torch.kernels.ent_matmul.ref import (ent_packed_matmul_ref,
                                                    quantize_with_scale)
    g = torch.Generator(device="cuda").manual_seed(11)
    rows = []
    for k, n in [(2048, 2048), (2048, 256), (2048, 11008), (11008, 2048)]:
        w8 = torch.randint(-127, 128, (k, n), generator=g, device="cuda",
                           dtype=torch.int8)
        packed = ent_packed_planes(w8).contiguous()
        sw = torch.rand((1, n), generator=g, device="cuda") * 1e-2 + 1e-4
        for m in (8, 512):
            x = torch.randn((m, k), generator=g, device="cuda").to(torch.bfloat16)
            sx = row_scale(x)
            got = ent_matmul_packed_fused(x, packed, sx, sw)
            plain = lambda: ent_packed_matmul_ref(quantize_with_scale(x, sx),
                                                  packed, sx, sw)
            want = plain()
            torch.cuda.synchronize()
            exact = torch.equal(got, want)
            err = float((got - want).abs().max())
            if not exact:
                raise AssertionError(f"ent_matmul_packed_fused M={m} K={k} N={n}: "
                                     f"not bit-identical to the plain version "
                                     f"(max abs err {err})")
            if m == 8 and n == k:   # planted fault: one plane code off by one
                bad = packed.clone()
                bad[0, 0, 0] += 1 if int(bad[0, 0, 0]) < 10 else -1
                n_bad = int((ent_matmul_packed_fused(x, bad, sx, sw) != want).sum())
                print(f"  planted fault 'one plane code off by one': {n_bad} of "
                      f"{m * n} outputs differ", flush=True)
                if not n_bad:
                    raise AssertionError("the exact check misses a wrong plane code")
            ms = timer(lambda: ent_matmul_packed_fused(x, packed, sx, sw))
            plain_ms = timer(plain, reps=5)
            xq = quantize_with_scale(x, sx)
            xq_lib = torch.cat([xq, xq.new_zeros((max(0, 32 - m), k))]) if m < 32 else xq
            try:   # w8a8 yardstick: one int8 GEMM (M padded to 32 rows)
                library_ms = timer(lambda: torch._int_mm(xq_lib, w8))
            except RuntimeError as e:
                print(f"  torch._int_mm unavailable: {e}")
                library_ms = None
            nbytes = m * k * 2 + 2 * k * n + 4 * m + 4 * n + 4 * m * n
            b, by = bound_ms(nbytes, 2 * 2 * m * k * n, INT8_OPS_S)
            print(f"kernel ent_matmul_packed_fused M={m} K={k} N={n} ms={ms:.4f} "
                  f"plain_ms={plain_ms:.4f} library_ms={library_ms} "
                  f"bound_ms={b:.4f} ({by}) max_abs_err={err} bit_exact={exact}",
                  flush=True)
            rows.append(dict(M=m, K=k, N=n, ms=ms, plain_ms=plain_ms,
                             library_ms=library_ms, bound_ms=b, bound_by=by,
                             max_abs_err=err))
    return rows


def excess(got, want, att_abs_v, tol):
    """max |got - want| / (tol * att|v|): <= 1 passes.  A fully masked row
    has att|v| = 0, so anything but exact zeros there reads as huge."""
    return float(((got.float() - want).abs() / (tol * att_abs_v + 1e-30)).max())


def attn_check(torch, what, kernel, plain, operands, faults):
    """Hold ``kernel`` against ``plain`` on ``operands`` (q, k, v first)
    in bf16 and float32; then each planted fault (``kernel`` called with
    a wrong mask argument) must fail the float32 check.  Returns the bf16
    max abs error."""
    q, k, v, *rest = operands
    att = plain(q.float(), k.float(), v.float().abs(), *rest)
    reads = {}
    for dt, tol in ((torch.bfloat16, TOL_BF16), (torch.float32, TOL_F32)):
        ops = [t.to(dt) for t in (q, k, v)] + rest
        got, want = kernel(*ops), plain(*ops)
        if not torch.isfinite(got).all():
            raise AssertionError(f"{what} {dt}: non-finite output")
        reads[dt] = (excess(got, want, att, tol), float((got.float() - want).abs().max()))
        for name, bad in faults.items():
            reads[(dt, name)] = excess(bad(*ops), want, att, tol)
    line = (f"  {what}: err/limit bf16 {reads[torch.bfloat16][0]:.3f} "
            f"(max abs {reads[torch.bfloat16][1]:.3e}), float32 "
            f"{reads[torch.float32][0]:.3f} (max abs {reads[torch.float32][1]:.3e})")
    for name in faults:
        line += (f"; planted fault '{name}': float32 {reads[(torch.float32, name)]:.1f}"
                 f", bf16 {reads[(torch.bfloat16, name)]:.2f}")
    print(line, flush=True)
    if reads[torch.bfloat16][0] > 1 or reads[torch.float32][0] > 1:
        raise AssertionError(f"{what}: kernel disagrees with the plain version")
    missed = [n for n in faults if reads[(torch.float32, n)] <= 1]
    if missed:
        raise AssertionError(f"{what}: the float32 check misses planted faults {missed}")
    return reads[torch.bfloat16][1]


def check_flash(torch, timer):
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.flash_attention import flash_attention_masked
    from repro_torch.kernels.flash_attention.ref import masked_attention_ref
    g = torch.Generator(device="cuda").manual_seed(12)
    rows = []
    for s, window in [(64, None), (200, None), (512, None), (512, 128)]:
        hq, hkv, d = 16, 2, 128
        q = torch.randn((1, hq, s, d), generator=g, device="cuda").to(torch.bfloat16)
        k = torch.randn((1, hkv, s, d), generator=g, device="cuda").to(torch.bfloat16)
        v = torch.randn((1, hkv, s, d), generator=g, device="cuda").to(torch.bfloat16)
        start = torch.tensor([s // 5], dtype=torch.int32, device="cuda")
        faults = {"start + 1": lambda q, k, v, st: flash_attention_masked(
            q, k, v, st + 1, window=window)}
        if window:
            faults["window + 1"] = lambda q, k, v, st: flash_attention_masked(
                q, k, v, st, window=window + 1)
        err = attn_check(
            torch, f"flash_attention_masked S={s} window={window}",
            lambda q, k, v, st: flash_attention_masked(q, k, v, st, window=window),
            lambda q, k, v, st: masked_attention_ref(q, k, v, start=st, window=window),
            (q, k, v, start), faults)
        got = flash_attention_masked(q, k, v, start, window=window)
        plain = lambda: masked_attention_ref(q, k, v, start=start, window=window)
        ms = timer(lambda: flash_attention_masked(q, k, v, start, window=window))
        plain_ms = timer(plain, reps=5)
        qp = torch.arange(s, device="cuda")[:, None]
        kp = torch.arange(s, device="cuda")[None, :]
        mask = (kp <= qp) & (kp >= s // 5)
        if window:
            mask &= kp > qp - window
        library_ms = timer(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask[None, None], enable_gqa=True))
        pairs = int(mask.sum())
        # q, k, v and start read once, the output (q's dtype) written once
        nbytes = (q.numel() + 2 * k.numel()) * q.element_size() + 4 \
            + got.numel() * got.element_size()
        b, by = bound_ms(nbytes, pairs * hq * d * 4, BF16_FLOPS_S)
        print(f"kernel flash_attention_masked B=1 Hq={hq} Hkv={hkv} D={d} S={s} "
              f"start={s // 5} window={window} ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"library_ms={library_ms:.4f} bound_ms={b:.5f} ({by}) "
              f"max_abs_err={err}", flush=True)
        rows.append(dict(S=s, window=window, ms=ms, plain_ms=plain_ms,
                         library_ms=library_ms, bound_ms=b, bound_by=by,
                         max_abs_err=err))
    return rows


def check_paged(torch, timer):
    from repro_torch.kernels.paged_attention.paged_attention import paged_attention_kernel
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    g = torch.Generator(device="cuda").manual_seed(13)
    b, hq, hkv, d, page, pps = 8, 16, 2, 128, 16, 36
    npool = b * pps + 1
    q = torch.randn((b, hq, 1, d), generator=g, device="cuda").to(torch.bfloat16)
    kp = torch.randn((npool, page, hkv, d), generator=g, device="cuda").to(torch.bfloat16)
    vp = torch.randn((npool, page, hkv, d), generator=g, device="cuda").to(torch.bfloat16)
    pos = torch.tensor([300, 511, 270, 543, 289, 400, 17, 0], dtype=torch.int32)
    start = torch.tensor([0, 200, 14, 31, 0, 399, 3, 0], dtype=torch.int32)
    table = torch.zeros((b, pps), dtype=torch.int32)
    perm = torch.randperm(npool - 1, generator=torch.Generator().manual_seed(0)) + 1
    for i in range(b - 1):          # slot 7 idle: all-null row
        live = int(pos[i]) // page + 1
        table[i, :live] = perm[i * pps:i * pps + live].to(torch.int32)
    table[1, 3] = 0                 # null entries inside live ranges
    table[3, 10] = 0
    table, pos, start = table.cuda(), pos.cuda(), start.cuda()
    kernel = lambda q, kp, vp, pos: paged_attention_kernel(q, kp, vp, table, pos, start,
                                                           page_size=page)
    err = attn_check(
        torch, "paged_attention_kernel", kernel,
        lambda q, kp, vp, pos: paged_attention_ref(q, kp, vp, table, pos, start,
                                                   page_size=page),
        (q, kp, vp, pos), {"pos - 1": lambda q, kp, vp, pos: kernel(q, kp, vp, pos - 1)})
    got = kernel(q, kp, vp, pos)
    plain = lambda: paged_attention_ref(q, kp, vp, table, pos, start, page_size=page)
    ms = timer(lambda: kernel(q, kp, vp, pos))
    plain_ms = timer(plain, reps=5)
    # what this run's data needs: live (non-null, in-band) pages, valid columns
    cols = torch.arange(pps * page, device="cuda")[None, :]
    mapped = torch.repeat_interleave(table != 0, page, dim=1)
    valid = mapped & (cols <= pos[:, None]) & (cols >= start[:, None])
    live_pages = int(valid.reshape(b, pps, page).any(-1).sum())
    nbytes = (q.numel() * 2 + live_pages * page * hkv * d * 2 * 2
              + table.numel() * 4 + 8 * b + got.numel() * 4)
    bnd, by = bound_ms(nbytes, int(valid.sum()) * hq * d * 4, BF16_FLOPS_S)
    print(f"kernel paged_attention_kernel B={b} Hq={hq} Hkv={hkv} D={d} page={page} "
          f"pps={pps} live_pages={live_pages} ms={ms:.4f} plain_ms={plain_ms:.4f} "
          f"library_ms=None bound_ms={bnd:.5f} ({by}) max_abs_err={err}", flush=True)
    return [dict(B=b, live_pages=live_pages, ms=ms, plain_ms=plain_ms,
                 library_ms=None, bound_ms=bnd, bound_by=by, max_abs_err=err)]


def serve_full_width(torch):
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels.ent_matmul import ops as ent_ops
    from repro_torch.kernels.ent_matmul.ent_matmul import ent_matmul_packed_fused
    from repro_torch.kernels.flash_attention import ops as attn_ops
    from repro_torch.kernels.flash_attention.flash_attention import flash_attention_masked
    from repro_torch.kernels.paged_attention import ops as paged_ops
    from repro_torch.kernels.paged_attention.paged_attention import paged_attention_kernel
    from repro_torch.launch import serve as launch
    from repro_torch.runtime.serve_loop import ServeEngine

    cfg = get_config("qwen2.5-3b")
    t0 = time.perf_counter()
    model, params = launch.build(cfg, quantize=True, seed=0)
    torch.cuda.synchronize()
    print(f"qwen2.5-3b full width ({cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.num_heads}/{cfg.num_kv_heads} heads, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}): init + EN-T encode {time.perf_counter() - t0:.2f}s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card", flush=True)
    engine = ServeEngine(model, params, slots=8, max_len=576, page_size=16,
                         prefix_cache=False, seed=0)
    rng = np.random.default_rng(0)
    prompts = launch.ragged_prompts(rng, 16, 256, 512, cfg.vocab_size)
    counters = (ent_matmul_packed_fused, flash_attention_masked, paged_attention_kernel)
    plains = (ent_ops.ent_quantized_matmul_fused, attn_ops.masked_attention,
              paged_ops.paged_attention)
    for f in counters:
        f.launches = 0
    for f in plains:
        f.plain_launches = 0
    results, dt = launch.serve(engine, prompts, max_new_tokens=32)
    launches = {f.__name__: f.launches for f in counters}
    engine.check_leaks()
    if sorted(results) != list(range(16)) or any(len(v) != 32 for v in results.values()):
        raise AssertionError(f"serve: {len(results)} results, lengths "
                             f"{sorted(len(v) for v in results.values())}")
    if any(v < 1 for v in launches.values()):
        raise AssertionError(f"a kernel of the main path never launched: {launches}")
    plain_runs = {f.__name__: f.plain_launches for f in plains}
    if any(plain_runs.values()):
        raise AssertionError(f"plain versions ran on the main path: {plain_runs}")
    toks = sum(len(v) for v in results.values())
    per_layer = launches["paged_attention_kernel"] // cfg.num_layers
    print(f"serve: 16 requests (prompts {min(map(len, prompts))}..{max(map(len, prompts))}"
          f" tokens) x 32 new tokens on 8 slots: {toks} tokens in {dt:.3f}s = "
          f"{toks / dt:.2f} tok/s; decode ticks {per_layer}, prefills "
          f"{launches['flash_attention_masked'] // cfg.num_layers}; launches {launches}; "
          f"plain versions run {plain_runs}; peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    profile_decode_ticks(torch, engine, prompts[:8])
    del engine, params, model
    torch.cuda.empty_cache()
    return launches, toks / dt


def profile_decode_ticks(torch, engine, prompts, ticks=3):
    """Where a full-batch decode tick's time goes: fill the 8 slots, then
    profile ``ticks`` pure decode ticks (host clock around synchronised
    ticks; device time per kernel from torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    for p in prompts:
        engine.submit(p, max_new_tokens=2 * ticks + 2)
    engine.step()                      # admits all 8 (prefills) + 1 tick
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ticks):
        engine.step()
    torch.cuda.synchronize()
    plain_wall = (time.perf_counter() - t0) * 1e3 / ticks
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(ticks):
            engine.step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / ticks
    dev = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
        if us and getattr(ev, "device_type", None) is not None and \
                str(ev.device_type).endswith("CUDA"):
            dev[ev.key] = us / 1e3 / ticks
    busy = sum(dev.values())
    idle = "not measured" if not busy else f"{100 * (1 - busy / plain_wall):.1f}% idle"
    print(f"decode tick (8 slots, full width): {plain_wall:.3f} ms host-clock "
          f"({wall:.3f} ms under the profiler); device busy {busy:.3f} ms/tick "
          f"({idle})")
    for name, ms in sorted(dev.items(), key=lambda kv: -kv[1])[:8]:
        print(f"  {ms:9.3f} ms/tick  {name[:90]}")
    engine.run()
    engine.check_leaks()


def e2e_faults(torch):
    """Planted faults for the end-to-end comparison: each replaces one
    kernel wrapper, as its ops module calls it, with the real wrapper fed
    one wrong mask argument.  name -> (module, attribute, wrap)."""
    from repro_torch.kernels.flash_attention import ops as attn_ops
    from repro_torch.kernels.paged_attention import ops as paged_ops

    def skip_pos_page(f):
        def g(q, kp, vp, table, pos, st, *a, page_size, **kw):
            table = table.clone()
            table[torch.arange(len(pos), device=pos.device), (pos // page_size).long()] = 0
            return f(q, kp, vp, table, pos, st, *a, page_size=page_size, **kw)
        return g

    paged = (paged_ops, "paged_attention_kernel")
    return {
        "decode misses its own token (pos - 1)": (*paged, lambda f: lambda q, kp, vp, t, pos, st, *a, **kw:
                                                  f(q, kp, vp, t, pos - 1, st, *a, **kw)),
        "decode skips the page holding pos": (*paged, skip_pos_page),
        "decode attends the left padding": (*paged, lambda f: lambda q, kp, vp, t, pos, st, *a, **kw:
                                            f(q, kp, vp, t, pos, torch.zeros_like(st), *a, **kw)),
        "prefill attends the left padding": (
            attn_ops, "flash_attention_masked", lambda f: lambda q, k, v, st, **kw:
            f(q, k, v, torch.zeros_like(st), **kw)),
    }


@contextlib.contextmanager
def planted(module, name, wrap):
    real = getattr(module, name)
    setattr(module, name, wrap(real))
    try:
        yield
    finally:
        setattr(module, name, real)


def kernels_vs_plain_end_to_end(torch, compute_dtype, quantize, bound):
    """One prefill (2 x 256 tokens, one left-padded to 200) + 4 decode
    ticks of full-width qwen2.5-3b at 2 layers, with the kernels and with
    the plain versions (``use_kernels=False``), on the same
    teacher-forced tokens; fails when the logits' relative L2 difference
    exceeds ``bound``, or when a planted fault (``e2e_faults``) stays
    within it.  Per call the kernels agree with the plain versions
    (kernel 1 bit for bit, float32 attention to ~1e-6); with EN-T weights
    every projection re-quantizes its input to int8, so the first code
    that a last-bit difference flips re-draws the rounding of everything
    downstream, and the quantized runs differ by int8 rounding noise
    (~1e-2 relative) however small the kernel error.  Also prints the
    free-running difference (each path fed its own greedy tokens), which
    is not bounded: once one greedy token differs, the two paths decode
    different inputs."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as launch
    from repro_torch.models.transformer import Model

    cfg = dataclasses.replace(get_config("qwen2.5-3b"), num_layers=2,
                              compute_dtype=compute_dtype)
    model, params = launch.build(cfg, quantize=quantize, seed=1)
    plain_model = Model(cfg, use_kernels=False)
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 256))).cuda()
    mask = torch.ones((2, 256), dtype=torch.bool, device="cuda")
    mask[1, :56] = False
    forced = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 2))).cuda()

    def run(m, teacher_forced=True):
        cache = m.init_cache(2, 288, kind="paged")
        logits, cache = m.prefill(params, cache, toks, pad_mask=mask)
        seq = [logits]
        for i in range(4):
            nxt = forced[i] if teacher_forced else seq[-1].argmax(-1)
            logits, cache = m.decode_step(params, cache, nxt)
            seq.append(logits)
        return torch.stack(seq)

    def rel(a, b):
        return float((a - b).norm() / b.norm())

    a, b = run(model), run(plain_model)
    if a.shape != (5, 2, cfg.padded_vocab) or not torch.isfinite(a).all():
        raise AssertionError(f"logits shape {tuple(a.shape)} / finite "
                             f"{bool(torch.isfinite(a).all())}")
    diff, sound = float((a - b).abs().max()), rel(a, b)
    agree = float((a.argmax(-1) == b.argmax(-1)).float().mean())
    fa, fb = run(model, False), run(plain_model, False)
    print(f"2-layer full width, {compute_dtype}, "
          f"{'EN-T int8' if quantize else 'float'} weights: prefill + 4 decode ticks, kernels "
          f"vs plain: logits max abs diff {diff:.3e} (max |logit| "
          f"{float(b.abs().max()):.3e}), relative L2 {sound:.3e} (limit {bound}), "
          f"greedy agreement {agree:.3f}; free-running: max abs diff "
          f"{float((fa - fb).abs().max()):.3e}, relative L2 {rel(fa, fb):.3e}", flush=True)
    missed = []
    for name, (module, attr, wrap) in e2e_faults(torch).items():
        with planted(module, attr, wrap):
            reading = rel(run(model), b)
        caught = reading > bound
        print(f"  planted fault '{name}': relative L2 {reading:.3e} "
              f"({'over' if caught else 'within'} the limit)", flush=True)
        if not caught:
            missed.append(name)
    if sound > bound:
        raise AssertionError(f"kernel path disagrees with the plain path "
                             f"({compute_dtype}, quantize={quantize}: relative "
                             f"L2 {sound} > {bound})")
    if missed:
        raise AssertionError(f"the limit {bound} misses planted faults {missed}")


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build

    t = phase("device")
    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    done(t, "device")

    t = phase("build")
    built = _build.build_all()
    for name in built:
        for line in _build.build_logs[name].splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    print(f"built {built or 'nothing (cached)'}")
    done(t, "build")

    t = phase("kernel checks")
    timer = Timer(torch)
    k1 = check_ent_matmul(torch, timer)
    k2 = check_flash(torch, timer)
    k3 = check_paged(torch, timer)
    del timer
    done(t, "kernel checks")

    t = phase("serve qwen2.5-3b full width")
    launches, tps = serve_full_width(torch)
    done(t, "serve qwen2.5-3b full width")

    t = phase("kernels vs plain, 2 layers")
    # Limits between the sound readings and the planted faults' on the
    # H100 (PERF.md): EN-T runs read 4.3e-2 (bf16) and 1.5e-2 (float32)
    # sound and >= 0.11 under every fault; the float-weight run reads
    # 1.1e-6 sound and >= 0.10 under every fault.
    kernels_vs_plain_end_to_end(torch, "bfloat16", True, 0.07)   # as served
    kernels_vs_plain_end_to_end(torch, "float32", True, 0.07)
    kernels_vs_plain_end_to_end(torch, "float32", False, 1e-4)   # no int8 cascade
    done(t, "kernels vs plain, 2 layers")

    def entry(name, source, replaces, rows, pick):
        row = pick(rows)
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": max(r["max_abs_err"] for r in rows),
                "ms": row["ms"], "plain_ms": row["plain_ms"],
                "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                "library_ms": row["library_ms"], "checks": rows}

    kernels = [
        entry("ent_matmul_packed_fused", "src/repro_torch/csrc/ent_matmul.cu",
              "src/repro/kernels/ent_matmul/ent_matmul.py:227", k1,
              lambda rows: next(r for r in rows if r["M"] == 8 and r["N"] == 11008)),
        entry("flash_attention_masked", "src/repro_torch/csrc/flash_attention.cu",
              "src/repro/kernels/flash_attention/flash_attention.py:145", k2,
              lambda rows: next(r for r in rows if r["S"] == 512 and r["window"] is None)),
        entry("paged_attention_kernel", "src/repro_torch/csrc/paged_attention.cu",
              "src/repro/kernels/paged_attention/paged_attention.py:109", k3,
              lambda rows: rows[0]),
    ]
    print(f"serve tokens/s {tps:.3f}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
