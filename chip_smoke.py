#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases (each prints its seconds; any failure exits non-zero):

1. the card (``nvidia-smi`` name and power limit) and torch/CUDA versions;
2. build the five CUDA sources from ``src/repro_torch/csrc`` (one nvcc
   per source, all at once), and report the registers, spills and shared
   memory (``-Xptxas -v``) and HGMMA / IGMMA / HMMA (IDP4A) counts
   (``cuobjdump``, where the toolkit has it) of the tensor-core kernels (7,
   7b, 7c, kernel 2's masked instantiations, the int8 loop of kernels 1,
   6 and 5, kernel 8's three launches, 8b's two and kernel 8c), of the
   split-K stream of kernels 1, 6 and 5 and of the paged decode (3 and 3b);
3. hold each kernel against its plain PyTorch version on the card at the
   main paths' shapes: the four serving matmuls (packed fused EN-T,
   w8a8 int8, 4-plane and packed EN-T) bit for bit at the full-width
   projection shapes, with the EN-T identity (all four int32
   accumulators equal); kernels 1, 6 and 5 on each of their routes, the
   split-K stream (M 1..32) and the int8 tensor-core loop (M 1..512; X
   near rounding ties and rows whose 1 / sx overflows for kernel 1), bit
   for bit on those shapes and a ragged one, in f32, bf16 and int32
   outputs, timed beside the old CUDA-core tile loop, and the two routes
   timed against each other at M 8..128 (the table each wrapper's cut
   comes from);
   the flash kernel (bf16 on its tensor-core route, float32 on CUDA
   cores; ragged starts, a chunked prefill) and the paged attention
   kernel (split-KV, one launch), the latter with bf16 pools and with
   int8 pools + bf16 scales, at the serving tick's shape, at G = 12 and
   D = 64 with pos on split boundaries, and at long context (8 x 4096
   tokens, timed beside its bytes bound), in bf16 and float32 within
   limits derived from the data (see TOL_BF16), two calls bit-identical.
   Planted faults (a wrong weight or plane code, a wrong mask argument, a
   wrong scale pool, a combine that drops the last live split) must fail
   those checks.  Kernel, plain
   version and a library yardstick are timed with CUDA events (L2 flushed
   by a read before every launch);
4. serve 16 ragged greedy requests (prompts 256..512 tokens, 32 new
   tokens each) on qwen2.5-3b at full width (36 layers, random weights
   from a seed) through ``repro_torch.launch.serve``'s code, in two
   configurations: EN-T w8a8 with a bf16 KV cache, and w8a8 int8
   (``QuantConfig(ent_encode=False)``) with an int8 KV cache.  Each
   asserts that the kernels of its path launched, no other serving
   kernel and no plain version ran, that every decode tick launched the
   paged decode once per layer (36) and no prefill did, that every
   decode tick and every
   prefill launched its matmul once per projection and layer (252; the
   decode ticks' all on the split-K stream, the prefills' all on the
   tensor-core loop) and kernel 2 once per layer per prefill (36), all on
   its tensor-core route, and profiles full-batch decode ticks (with the
   matmul on each route, in one process) and one admission prefill;
5. one prefill + 4 decode ticks of the same widths at 2 layers with the
   kernels and with the plain versions, compared (bf16 and float32 with
   EN-T weights, float32 with float weights, bf16 with int8 weights and
   int8 KV, bf16 with legacy 4-plane records, whose 70 kernel 5 launches
   must split between the split-K stream (the ticks) and the tensor-core
   loop (the prefill) as its cut says), and with planted mask and scale
   faults that the limits must reject;
6. the training kernels: the flash forward (kernel 7) against
   ``attention_ref`` and its two backward kernels (7b dK/dV, 7c dQ)
   against ``flash_attention_bwd_ref``, at the training shape (B=1,
   H=36, S=4096, D=64, causal) and at a GQA + window shape (Hq=16,
   Hkv=2, D=128, S=1024, window 256), in bf16 (7, 7b and 7c on their
   tensor-core route) and float32 (CUDA-core route), per element within
   limits derived like TOL_BF16's, with planted faults (a causal mask off
   by one, lse of the neighbouring row, dK/dV of only the first q head of
   a group) that must fail in both dtypes; the D_i that 7c writes held
   against ``bwd_delta``; each kernel, its plain version and SDPA
   (forward; backward through autograd) timed at the training shape;
7. loss and every gradient leaf of full-width minicpm-2b at 2 layers
   (S=1024) with the kernels and with the plain versions, bf16 and
   float32, with planted faults in the attention wrappers, and with
   remat full and dots against no remat;
8. 3 training steps of full-width minicpm-2b (40 layers, seq 4096,
   global batch 2, microbatch 1, remat full) through
   ``repro_torch.launch.train``'s code, each step's launches of kernels
   7 / 7b / 7c checked against 160 / 80 / 80, all on the tensor-core
   route, with no plain D_i pass (``bwd_delta``: 7c writes D_i for 7b),
   then one more step under ``torch.profiler``;
9. the SSD kernels: the scan (kernel 8: each chunk's own state, the
   carry from chunk to chunk, the outputs; split-bf16 three-pass products
   on the tensor cores) against ``ssd_scan_fwd_ref`` (y and each chunk's
   entering state) and its backward (8b the state gradients: each chunk's
   own term on the tensor cores, then the carry in reverse; 8c the
   chunk's gradients on the tensor cores) against
   ``ssd_scan_bwd_ref``, all five gradients, float32, at SSD_SHAPES
   (mamba2-370m's training call, jamba's 8 groups, one short chunk), per
   element within limits derived in ``ssd_units``, with planted faults
   (the carried state not decayed, the mask off by one, dh not carried,
   8b's rows weighted by exp(cum_{i+1}), dB / dC of one head of a group,
   da of the first chunk) that must fail;
   bfloat16 and L % chunk != 0 must raise on the card; each kernel and its
   plain version timed at the training step's call (B=4, L=4096, H=32)
   beside its bytes bound, its three-pass tensor-core bound and its f32
   CUDA-core bound;
10. loss and every gradient leaf of full-width mamba2-370m at 2 layers
   (S=1024) with the kernels and with the plain versions, bf16 and
   float32, with planted faults in the SSD wrappers, and remat full and
   dots against no remat;
11. 3 training steps of full-width mamba2-370m (48 layers, seq 4096,
   global batch 8, microbatch 4, remat full), each step's launches of
   kernels 8 / 8b / 8c checked against 192 / 96 / 96, of each of kernel
   8's three launches (states, carry, outputs) against 192 and of each of
   8b's two (own, carry) against 96, then
   one more step under ``torch.profiler``;
12. a ``kernels`` JSON line, the card line, and the final result line.

Without a CUDA card it prints nothing but an error and exits 2.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

DEV = "cuda"
# published H100 SXM peaks (NVIDIA data sheet, dense, 700 W)
HBM_BYTES_S = 3.35e12
INT8_OPS_S = 1979e12
BF16_FLOPS_S = 989e12
F32_FLOPS_S = 67e12    # float32 outside the tensor cores
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
# covers these 3 * 2**-8 and leaves 2**-8 for f32 rounding.  The bf16
# (tensor-core) route of the training forward, kernel 7, rounds its
# probabilities the same way (relative to the running max after each
# 128-column tile) against attention_ref's f32 ones: the same 3 * 2**-8
# (tests/test_torch_flash_tc.py rehearses it on the CPU).  With float32
# operands nothing is rounded to bf16: the sides differ only in the order
# of the 128-term f32 dot products, at worst ~2e-4 att|v| (D * 2**-24 *
# sum_d |q_d k_d| * scale, on both sides); TOL_F32 = 2**-11.  The float32
# check at the same shapes holds the masking sharply: one key more or
# less in a row of N keys moves it by ~|v_j - out| / N, ~6e-3 att|v| at
# N = 128; the planted faults below (must fail) show it on the card.
TOL_BF16 = 2.0**-6
TOL_F32 = 2.0**-11
# Training, kernels vs plain versions end to end (loss and per-leaf
# gradient relative L2 of full-width minicpm-2b at 2 layers): set between
# the sound readings and the planted faults' on the H100 (PERF.md): bf16
# reads 4.3e-3 sound (the two paths round dq, dk, dv and the attention
# output to bf16 at different points), float32 1.2e-6; the three planted
# faults read 0.24-0.66 in both.
TRAIN_BOUND_BF16 = 2e-2
TRAIN_BOUND_F32 = 1e-4
# The same reading for full-width mamba2-370m at 2 layers through the SSD
# kernels; PERF.md has the sound and the planted faults' readings.
SSM_BOUND_BF16 = 2e-2
SSM_BOUND_F32 = 1e-4


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
    CUDA events and preceded by a 256 MB read that evicts the 50 MB L2
    (weights and KV pages reach the main path's kernels cold).  A read,
    not a write: a write leaves the L2 full of dirty lines, which the
    timed kernel then writes back, and that slowed the split-K stream's
    weight reads (17% at M = 8, 2048->11008) more than the tensor-core
    loop's (4%), an ordering the decode tick does not show (PERF.md)."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.ones(64 * 2**20, dtype=torch.float32, device=DEV)
        self.sink = torch.empty((), dtype=torch.float32, device=DEV)

    def __call__(self, fn, reps=15):
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        evs = []
        for _ in range(reps):
            torch.sum(self.flush, dim=0, out=self.sink)
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


def check_matmuls(torch, timer):
    """The four serving matmuls at the full-width projection shapes:
    kernel 1 (``ent_matmul_packed_fused``) and kernels 6 / A
    (``int8_matmul``), 5 / C (``ent_matmul``, 4-plane) and 4 / D
    (``ent_matmul_packed``), at M = 8 (kernels 1, 6 and 5 on the split-K
    stream) and M = 512 (on the tensor-core loop).  Each is held bit for
    bit against its plain version; the four int32 accumulators at the same
    Xq (kernel 1 quantizes X with the same sx) must all be equal, the EN-T
    identity; one planted fault per kernel (one weight or plane code off
    by one) must fail the exact check at both M; and all four, their plain
    versions and ``torch._int_mm`` are timed, kernels 1, 6 and 5 also on
    the CUDA-core tile loop that served them before.  Returns {kernel name:
    [row per shape]}."""
    from repro_torch.core.multiplier import ent_packed_planes
    from repro_torch.kernels.ent_matmul import ent_matmul as em
    from repro_torch.kernels.ent_matmul.ent_matmul import (ent_matmul, ent_matmul_packed,
                                                           ent_matmul_packed_fused)
    from repro_torch.kernels.ent_matmul.ops import encode_weights, row_scale
    from repro_torch.kernels.ent_matmul.ref import (ent_matmul_ref, ent_packed_matmul_ref,
                                                    quantize_with_scale)
    from repro_torch.kernels.int8_matmul import int8_matmul as im
    from repro_torch.kernels.int8_matmul.int8_matmul import int8_matmul
    from repro_torch.kernels.int8_matmul.ref import int8_matmul_int32_ref, int8_matmul_ref
    g = torch.Generator(device=DEV).manual_seed(11)
    rows = {n: [] for n in ("ent_matmul_packed_fused", "int8_matmul", "ent_matmul",
                            "ent_matmul_packed")}
    for k, n in [(2048, 2048), (2048, 256), (2048, 11008), (11008, 2048)]:
        w8 = torch.randint(-127, 128, (k, n), generator=g, device=DEV,
                           dtype=torch.int8)
        packed = ent_packed_planes(w8).contiguous()
        planes = encode_weights(w8).contiguous()
        sw = torch.rand((1, n), generator=g, device=DEV) * 1e-2 + 1e-4
        for m in (8, 512):
            x = torch.randn((m, k), generator=g, device=DEV).to(torch.bfloat16)
            sx = row_scale(x)
            xq = quantize_with_scale(x, sx)
            # name -> (kernel on weights w, weights, plain version, planes, x bytes)
            cases = {
                "ent_matmul_packed_fused": (
                    lambda w, o=torch.float32: ent_matmul_packed_fused(x, w, sx, sw, o),
                    packed, lambda: ent_packed_matmul_ref(xq, packed, sx, sw)),
                "int8_matmul": (
                    lambda w, o=torch.float32: int8_matmul(xq, w, sx, sw, o),
                    w8, lambda: int8_matmul_ref(xq, w8, sx, sw, torch.float32)),
                "ent_matmul": (
                    lambda w, o=torch.float32: ent_matmul(xq, w, sx, sw, o),
                    planes, lambda: ent_matmul_ref(xq, planes, sx, sw)),
                "ent_matmul_packed": (
                    lambda w, o=torch.float32: ent_matmul_packed(xq, w, sx, sw, o),
                    packed, lambda: ent_packed_matmul_ref(xq, packed, sx, sw)),
            }
            # the EN-T identity: one int32 accumulator for all four
            acc = int8_matmul_int32_ref(xq, w8)
            for name, (kern, w, _) in cases.items():
                got = kern(w, torch.int32)
                torch.cuda.synchronize()
                if not torch.equal(got, acc):
                    raise AssertionError(f"EN-T identity: {name} M={m} K={k} N={n}: int32 "
                                         f"accumulator differs from X @ W in "
                                         f"{int((got != acc).sum())} places")
            xq_lib = torch.cat([xq, xq.new_zeros((max(0, 32 - m), k))]) if m < 32 else xq
            try:   # w8a8 yardstick: one int8 GEMM (M padded to 32 rows)
                library_ms = timer(lambda: torch._int_mm(xq_lib, w8))
            except RuntimeError as e:
                print(f"  torch._int_mm unavailable: {e}")
                library_ms = None
            for name, (kern, w, plain) in cases.items():
                got, want = kern(w), plain()
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                if not torch.equal(got, want):
                    raise AssertionError(f"{name} M={m} K={k} N={n}: not bit-identical "
                                         f"to the plain version (max abs err {err})")
                if name == "int8_matmul" and not torch.equal(
                        kern(w, torch.bfloat16),
                        int8_matmul_ref(xq, w8, sx, sw, torch.bfloat16)):
                    raise AssertionError(f"int8_matmul M={m} K={k} N={n}: bf16 output "
                                         f"not bit-identical")
                if n == k:   # planted fault: one weight/plane code off by one
                    bad = w.clone()
                    flat = bad.view(-1)
                    flat[0] += 1 if int(flat[0]) < 1 else -1
                    n_bad = int((kern(bad) != want).sum())
                    print(f"  {name} M={m}: planted fault 'one code off by one': {n_bad} of "
                          f"{m * n} outputs differ", flush=True)
                    if not n_bad:
                        raise AssertionError(f"{name} M={m}: the exact check misses a wrong "
                                             f"code")
                ms = timer(lambda: kern(w))
                plain_ms = timer(plain, reps=5)
                nplanes, x_bytes = PLANES_X_BYTES[name]
                nbytes = m * k * x_bytes + nplanes * k * n + 4 * m + 4 * n + 4 * m * n
                b, by = bound_ms(nbytes, nplanes * 2 * m * k * n, INT8_OPS_S)
                extra = {}
                if name in MATMULS:
                    tile = {"ent_matmul_packed_fused": lambda: em._launch_fused(
                                x, packed, sx, sw, torch.float32, "tile"),
                            "int8_matmul": lambda: im._launch(xq, w8, sx, sw, torch.float32,
                                                              "tile"),
                            "ent_matmul": lambda: em._launch_planes(xq, planes, sx, sw,
                                                                    torch.float32, "tile")}[name]
                    extra = dict(route=matmul_route(name, m), tile_ms=timer(tile))
                print(f"kernel {name} M={m} K={k} N={n} ms={ms:.4f} "
                      f"plain_ms={plain_ms:.4f} library_ms={library_ms} "
                      f"bound_ms={b:.4f} ({by}) max_abs_err={err} bit_exact=True"
                      + "".join(f" {a}={v:.4f}" if isinstance(v, float) else f" {a}={v}"
                                for a, v in extra.items()), flush=True)
                rows[name].append(dict(M=m, K=k, N=n, ms=ms, plain_ms=plain_ms,
                                       library_ms=library_ms, bound_ms=b, bound_by=by,
                                       max_abs_err=err, **extra))
    print("  EN-T identity: int8_matmul, ent_matmul (4-plane), ent_matmul_packed and "
          "ent_matmul_packed_fused gave the same int32 accumulator at all 8 shapes",
          flush=True)
    return rows


# the four projection shapes and a ragged one
STREAM_SHAPES = [(2048, 2048), (2048, 256), (2048, 11008), (11008, 2048), (1000, 300)]
# kernels 1 and 6 on the stream: M up to the cut (decode: 8), and one M
# past it at which check_cut times the stream (in chunks of 8 rows); on
# the tensor-core loop at these M as well (check_cut and the decode ticks'
# route comparison run it there)
STREAM_CHECK_M = (1, 3, 8, 16, 32)
# kernels 1 and 6 on the tensor-core loop: one tile, the M just past it,
# and the serving prefills' range (260..505 prompt tokens) and cap
TC_CHECK_M = (128, 129, 260, 505, 512)
CUT_M = (8, 16, 32, 64, 96, 128)   # where check_cut times the two routes
# kernels 1, 6 and 5: the matmuls routed by M
MATMULS = ("ent_matmul_packed_fused", "int8_matmul", "ent_matmul")
# each matmul's weight planes and bytes an X element (kernel 1 reads bf16 X)
PLANES_X_BYTES = {"ent_matmul_packed_fused": (2, 2), "int8_matmul": (1, 1),
                  "ent_matmul": (4, 1), "ent_matmul_packed": (2, 1)}


def matmul_cuts():
    """{kernel 1, 6 or 5: (the wrapper module, the name of its cut)}."""
    from repro_torch.kernels.ent_matmul import ent_matmul as em
    from repro_torch.kernels.int8_matmul import int8_matmul as im
    return {"ent_matmul_packed_fused": (em, "M_STREAM"), "int8_matmul": (im, "M_STREAM"),
            "ent_matmul": (em, "M_STREAM_PLANES")}


def matmul_cut(name):
    """The cut of kernel 1, 6 or 5, read at call time."""
    mod, attr = matmul_cuts()[name]
    return getattr(mod, attr)


def matmul_route(name, m):
    """The route the wrapper of kernel 1, 6 or 5 takes at ``m`` rows."""
    from repro_torch.kernels.ent_matmul import ent_matmul as em
    return em.route_of(m, matmul_cut(name))


def _routed(torch, g, k, n):
    """Operands of kernels 1, 6 and 5 at one projection shape (weights,
    packed planes, 4-plane digits, sw), and a call of each by route:
    {kernel: (call(x, sx, xq, route or None, out dtype), wrapper)}; route
    None is the public wrapper, whose choice by M is counted."""
    from repro_torch.core.multiplier import ent_packed_planes
    from repro_torch.kernels.ent_matmul import ent_matmul as em
    from repro_torch.kernels.ent_matmul.ops import encode_weights
    from repro_torch.kernels.int8_matmul import int8_matmul as im
    w8 = torch.randint(-127, 128, (k, n), generator=g, device=DEV, dtype=torch.int8)
    packed = ent_packed_planes(w8).contiguous()
    digits = encode_weights(w8).contiguous()
    sw = torch.rand((1, n), generator=g, device=DEV) * 1e-2 + 1e-4

    def k1(x, sx, xq, route, o, planes=packed):
        if route is None:
            return em.ent_matmul_packed_fused(x, planes, sx, sw, o)
        return em._launch_fused(x, planes, sx, sw, o, route)

    def k6(x, sx, xq, route, o, w=w8):
        if route is None:
            return im.int8_matmul(xq, w, sx, sw, o)
        return im._launch(xq, w, sx, sw, o, route)

    def k5(x, sx, xq, route, o, planes=digits):
        if route is None:
            return em.ent_matmul(xq, planes, sx, sw, o)
        return em._launch_planes(xq, planes, sx, sw, o, route)
    return w8, (packed, digits), sw, {"ent_matmul_packed_fused": (k1, em.ent_matmul_packed_fused),
                                      "int8_matmul": (k6, im.int8_matmul),
                                      "ent_matmul": (k5, em.ent_matmul)}


def check_routes_exact(torch, what, ms, route, x_dtypes, seed):
    """Kernels 1, 6 and 5 on ``route`` at every M of ``ms`` ({kernel name:
    M values}; a kernel not named is skipped) on STREAM_SHAPES: kernel 1
    with each X dtype of ``x_dtypes``, all in f32, bf16 and int32
    outputs, bit for bit against the plain version, the int32 accumulator
    equal to X @ W (``int8_matmul_int32_ref``: the EN-T identity), twice in
    a row (a split-K workspace is left zeroed), each call one launch on the
    route; through the wrapper where it takes ``route`` at that M.  A
    weight or plane code off by one must fail the exact check at each
    kernel's largest M.  Returns the number of calls checked."""
    from repro_torch.kernels.ent_matmul import ent_matmul as em
    from repro_torch.kernels.ent_matmul.ops import row_scale
    from repro_torch.kernels.ent_matmul.ref import (ent_matmul_ref, ent_packed_matmul_ref,
                                                    quantize_with_scale)
    from repro_torch.kernels.int8_matmul.ref import int8_matmul_int32_ref, int8_matmul_ref
    g = torch.Generator(device=DEV).manual_seed(seed)
    counter = f"{route}_launches"
    n_checked = 0
    for k, n in STREAM_SHAPES:
        w8, (packed, digits), sw, kernels = _routed(torch, g, k, n)
        for m in sorted({m for v in ms.values() for m in v}):
            for xdt in x_dtypes:
                x = torch.randn((m, k), generator=g, device=DEV).to(xdt)
                sx = row_scale(x)
                xq = quantize_with_scale(x, sx)
                acc = int8_matmul_int32_ref(xq, w8)
                for name, (call, wrapper) in kernels.items():
                    if m not in ms.get(name, ()):
                        continue
                    if name != "ent_matmul_packed_fused" and xdt != x_dtypes[0]:
                        continue   # int8 X: one quantization is enough
                    via = None if matmul_route(name, m) == route else route
                    for o in (torch.float32, torch.bfloat16, torch.int32):
                        if o == torch.int32:
                            want = acc
                        elif name == "int8_matmul":
                            want = int8_matmul_ref(xq, w8, sx, sw, o)
                        elif name == "ent_matmul":
                            want = ent_matmul_ref(xq, digits, sx, sw, o)
                        else:
                            want = ent_packed_matmul_ref(xq, packed, sx, sw, o)
                        for _ in range(2):
                            before = wrapper.launches, getattr(wrapper, counter)
                            got = call(x, sx, xq, via, o)
                            torch.cuda.synchronize()
                            if (wrapper.launches - before[0],
                                    getattr(wrapper, counter) - before[1]) != (1, 1):
                                raise AssertionError(f"{what} {name} M={m} K={k} N={n}: not "
                                                     f"one launch on the {route} route")
                            if not torch.equal(got, want):
                                raise AssertionError(
                                    f"{what} {name} M={m} K={k} N={n} X {xdt} out {o}: not "
                                    f"bit-identical ({int((got != want).sum())} of {m * n} "
                                    f"differ)")
                            n_checked += 1
                    if m == max(ms[name]) and xdt == x_dtypes[0]:   # planted fault
                        bad = {"ent_matmul_packed_fused": packed, "int8_matmul": w8,
                               "ent_matmul": digits}[name].clone()
                        flat = bad.view(-1)
                        flat[k * n // 2] += 1 if int(flat[k * n // 2]) < 1 else -1
                        n_bad = int((call(x, sx, xq, route, torch.int32, bad) != acc).sum())
                        print(f"  {what} {name} M={m} K={k} N={n}: planted fault 'one code "
                              f"off by one': {n_bad} of {m * n} outputs differ", flush=True)
                        if not n_bad:
                            raise AssertionError(f"{what} {name}: the exact check misses a "
                                                 f"wrong code")
    print(f"  {what}: {n_checked} calls ("
          + ", ".join(f"{name} at M {v}" for name, v in ms.items())
          + f") x {len(STREAM_SHAPES)} shapes x out f32 / bf16 / int32 (ent_matmul_packed_fused: X "
          f"{[str(d)[6:] for d in x_dtypes]}; each twice) bit-identical, the int32 "
          f"accumulator equal to X @ W (EN-T identity), one launch each on the {route} route",
          flush=True)
    return n_checked


def check_launchers_refuse(torch):
    """The stream's and the tensor-core loop's launchers hold the
    wrapper's plan and workspace to their own constants: a ticket short,
    an int of the sums short, or a K slice off its step is refused, for
    kernels 1, 6 and 5 alike."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.ent_matmul import ent_matmul as em
    from repro_torch.kernels.ent_matmul.ops import row_scale
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    k, n = 2048, 2048
    for m, route in ((8, "stream"), (256, "tc")):
        x = torch.randn((m, k), device=DEV).to(torch.bfloat16)
        x8 = torch.zeros((m, k), dtype=torch.int8, device=DEV)
        planes = torch.zeros((4, k, n), dtype=torch.int8, device=DEV)
        sx, sw = row_scale(x), torch.ones((1, n), device=DEV)
        out = torch.empty((m, n), device=DEV)
        # kernel -> (C entry point, its operand arguments, rows a tensor-core block)
        launchers = {
            "ent_matmul_packed_fused": (
                _build.entry("ent_matmul", f"ent_matmul_packed_fused_{route}"),
                (x.data_ptr(), 1, planes.data_ptr(), sx.data_ptr(), sw.data_ptr(),
                 out.data_ptr(), 0), em.TC_BM),
            "int8_matmul": (
                _build.entry("int8_matmul", f"int8_matmul_{route}"),
                (x8.data_ptr(), planes.data_ptr(), sx.data_ptr(), sw.data_ptr(),
                 out.data_ptr(), 0), em.TC_BM),
            "ent_matmul": (
                _build.entry("ent_matmul", f"ent_matmul_planes_{route}"),
                (x8.data_ptr(), planes.data_ptr(), sx.data_ptr(), sw.data_ptr(),
                 out.data_ptr(), 0), em.TC_BM_PLANES)}
        for name, (fn, lead, bm) in launchers.items():
            if route == "stream":
                mb, kslice, splits, (strips, _, chunks) = em.stream_plan(m, n, k, sms)
                plan, tickets, step = (mb,), strips * chunks, em.STREAM_KSTEP
            else:
                kslice, splits, (mt, nt, _) = em.tc_plan(m, n, k, sms, bm)
                plan, tickets, step = (), mt * nt, em.TC_BK
            assert splits > 1, (name, route, splits)
            ws, tk = _build.stream_workspace((x.device, _build.stream_of(x)), m * n, tickets)
            for what, ws_len, n_tk, ks in (("tickets", m * n, tickets - 1, kslice),
                                           ("sums", m * n - 1, tickets, kslice),
                                           ("K slice", m * n, tickets, kslice + step // 2)):
                rc = fn(*lead, ws.data_ptr(), ws_len, tk.data_ptr(), n_tk, m, n, k, *plan, ks,
                        -(-k // ks), _build.stream_of(x))
                if rc == 0:
                    raise AssertionError(f"{name} {route} launcher: took a plan with {what} "
                                         f"short or off")
    print("  stream and tensor-core launchers (kernels 1, 6 and 5): a ticket short, a sum "
          "short and a K slice off its step refused", flush=True)


def time_routes(torch, timer, ms, routes, seed, names=MATMULS):
    """Kernels ``names`` of 1, 6 and 5 (X bf16, f32 out) on each of ``routes``
    at every M of ``ms`` on the four projection shapes, beside the bound
    and ``torch._int_mm`` (one plane, M padded to 32 rows).  Returns rows."""
    from repro_torch.kernels.ent_matmul.ops import row_scale
    from repro_torch.kernels.ent_matmul.ref import quantize_with_scale
    g = torch.Generator(device=DEV).manual_seed(seed)
    rows = []
    for k, n in STREAM_SHAPES[:4]:
        w8, _, _, kernels = _routed(torch, g, k, n)
        for m in ms:
            x = torch.randn((m, k), generator=g, device=DEV).to(torch.bfloat16)
            sx = row_scale(x)
            xq = quantize_with_scale(x, sx)
            xq_lib = torch.cat([xq, xq.new_zeros((max(0, 32 - m), k))]) if m < 32 else xq
            library_ms = timer(lambda: torch._int_mm(xq_lib, w8))
            for name in names:
                call = kernels[name][0]
                t = {r: timer(lambda: call(x, sx, xq, r, torch.float32)) for r in routes}
                nplanes, x_bytes = PLANES_X_BYTES[name]
                nbytes = m * k * x_bytes + nplanes * k * n + 4 * m + 4 * n + 4 * m * n
                b, by = bound_ms(nbytes, nplanes * 2 * m * k * n, INT8_OPS_S)
                print(f"kernel {name} M={m} K={k} N={n}: "
                      + " ".join(f"{r} ms={v:.4f}" for r, v in t.items())
                      + f" bound_ms={b:.4f} ({by}) library_ms={library_ms:.4f}", flush=True)
                rows.append(dict(kernel=name, M=m, K=k, N=n, bound_ms=b, bound_by=by,
                                 library_ms=library_ms, **{f"{r}_ms": v for r, v in t.items()}))
    return rows


def check_stream(torch):
    """The split-K weight stream (``csrc/int8_stream.cuh``) of kernels 1,
    6 and 5, which their wrappers take up to their cuts: bit for bit at
    STREAM_CHECK_M (``check_routes_exact``), then the launchers'
    refusals.  Returns the number of calls checked."""
    n = check_routes_exact(torch, "stream", dict.fromkeys(MATMULS, STREAM_CHECK_M), "stream",
                           (torch.bfloat16, torch.float32), 13)
    check_launchers_refuse(torch)
    return n


def check_tc(torch):
    """The int8 tensor-core loop (``csrc/int8_tc.cuh``) of kernels 1, 6 and
    5, which their wrappers take above their cuts: bit for bit at STREAM_CHECK_M,
    the M just past each cut and TC_CHECK_M (``check_routes_exact``); then
    kernel 1, on both its routes, with X on rounding ties of X / sx (k + 1/2 exactly, and one
    float32 ulp to either side) and with rows whose 1 / sx overflows (0 <
    sx < 1 / FLT_MAX, X zero or small), where the loop's reciprocal
    quantizer must defer to the IEEE division.  Returns the number of
    calls checked."""
    from repro_torch.core.multiplier import ent_packed_planes
    from repro_torch.kernels.ent_matmul import ent_matmul as em
    from repro_torch.kernels.ent_matmul.ops import row_scale
    ms = {name: tuple(sorted({*STREAM_CHECK_M, matmul_cut(name) + 1, *TC_CHECK_M}))
          for name in MATMULS}
    n = check_routes_exact(torch, "tensor-core", ms, "tc", (torch.bfloat16, torch.float32), 15)
    g = torch.Generator(device=DEV).manual_seed(17)
    m, c = 300, 2.0**-5   # sx = 127 c / 127 = c exactly: X / sx = X / c
    for k, cols in ((2048, 2048), (1000, 300)):
        w8 = torch.randint(-127, 128, (k, cols), generator=g, device=DEV, dtype=torch.int8)
        packed = ent_packed_planes(w8).contiguous()
        ties = (torch.randint(-127, 127, (m, k), generator=g, device=DEV).float() + 0.5) * c
        for side in (0.0, 1e9, -1e9):
            x = ties if not side else torch.nextafter(ties, torch.full_like(ties, side))
            x[:, 0] = 127 * c
            for xdt in (torch.float32, torch.bfloat16):
                xx = x.to(xdt)
                n += _quantizer_case(torch, em, xx, row_scale(xx), packed, w8,
                                     f"X near ties ({side})")
        # rows whose 1 / sx is not finite (1e-39, 2.5e-39, the least
        # subnormal), beside one where it is just finite (3e-39) and a normal
        # one; X ~ 1e-38 (some subnormal), every third element zero
        x = torch.randn((m, k), generator=g, device=DEV) * 1e-38
        x[:, ::3] = 0
        sx = torch.tensor([1e-39, 2.5e-39, 1e-45, 3e-39, 0.05], device=DEV).repeat(m // 5)[:, None]
        for xdt in (torch.float32, torch.bfloat16):
            n += _quantizer_case(torch, em, x.to(xdt), sx.contiguous(), packed, w8, "tiny sx")
    print("  tensor-core / stream: X on and one ulp beside rounding ties of X / sx, and rows "
          "whose 1 / sx overflows, bit-identical (f32 and bf16 X)", flush=True)
    return n


def _quantizer_case(torch, em, x, sx, packed, w8, what):
    """Kernel 1's int32 accumulator at X, sx on the tensor-core loop (all
    rows) and the stream (the first 8) against X @ W with X quantized by
    the plain version.  Returns the number of calls checked."""
    from repro_torch.kernels.ent_matmul.ref import quantize_with_scale
    from repro_torch.kernels.int8_matmul.ref import int8_matmul_int32_ref
    want = int8_matmul_int32_ref(quantize_with_scale(x, sx), w8)
    sw = torch.ones((1, w8.shape[1]), device=DEV)
    for route, rows in (("tc", x.shape[0]), ("stream", 8)):
        got = em._launch_fused(x[:rows].contiguous(), packed, sx[:rows].contiguous(), sw,
                               torch.int32, route)
        if not torch.equal(got, want[:rows]):
            raise AssertionError(f"{route} K={x.shape[1]} N={w8.shape[1]}: {what}, X {x.dtype}: "
                                 f"not bit-identical ({int((got != want[:rows]).sum())} differ)")
    return 2


# projections a layer by shape (K, N): q and o, k and v, gate and up, down
LAYER_SHAPES = {(2048, 2048): 2, (2048, 256): 2, (2048, 11008): 2, (11008, 2048): 1}


def check_cut(torch, timer):
    """The stream against the tensor-core loop at CUT_M, kernels 1, 6 and
    5, on the four projection shapes: the table each wrapper's cut is set
    from.  Prints, for each kernel and M, the two routes' time over a
    layer's seven projections, and the largest timed M up to which the
    stream's is the smaller.  Returns the rows."""
    rows = time_routes(torch, timer, CUT_M, ("stream", "tc"), 16)
    for name in MATMULS:
        layer = {m: {r: sum(LAYER_SHAPES[(x["K"], x["N"])] * x[f"{r}_ms"] for x in rows
                            if x["kernel"] == name and x["M"] == m) for r in ("stream", "tc")}
                 for m in CUT_M}
        last = max((m for m in CUT_M
                    if all(layer[w]["stream"] <= layer[w]["tc"] for w in CUT_M if w <= m)),
                   default=None)
        print(f"  cut [{name}]: a layer's seven projections, stream / tensor-core ms: "
              + ", ".join(f"M={m} {v['stream']:.4f} / {v['tc']:.4f}" for m, v in layer.items())
              + f"; the stream is the faster up to M = {last}; its cut = {matmul_cut(name)}",
              flush=True)
    return rows


def excess(got, want, att_abs_v, tol):
    """max |got - want| / (tol * att|v|): <= 1 passes.  A fully masked row
    has att|v| = 0, so anything but exact zeros there reads as huge."""
    return float(((got.float() - want).abs() / (tol * att_abs_v + 1e-30)).max())


def attn_check(torch, what, kernel, plain, operands, faults):
    """Hold ``kernel`` against ``plain`` on ``operands`` (q, k, v first)
    in bf16 and float32; then each planted fault (``kernel`` called with
    a wrong mask argument) must fail the check in both dtypes.  Returns
    the bf16 max abs error."""
    q, k, v, *rest = operands
    # int8 KV pools stay int8 (their scales ride in ``rest``)
    cast = lambda t, dt: t.to(dt) if t.is_floating_point() else t   # noqa: E731
    att = plain(q.float(), cast(k, torch.float32), cast(v, torch.float32).abs(), *rest)
    reads = {}
    for dt, tol in ((torch.bfloat16, TOL_BF16), (torch.float32, TOL_F32)):
        ops = [cast(t, dt) for t in (q, k, v)] + rest
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
    missed = [(n, str(dt)) for n in faults for dt in (torch.bfloat16, torch.float32)
              if reads[(dt, n)] <= 1]
    if missed:
        raise AssertionError(f"{what}: the check misses planted faults {missed}")
    return reads[torch.bfloat16][1]


# kernel 2's checked calls: (B, Sq, Skv, start per sequence, q_offset,
# window, D); Hq = 16, Hkv = 2 (qwen2.5-3b's heads).  D = 128 as served:
# ragged B = 3 with one start past a whole q tile, and a chunked prefill
# (q_offset > 0); and a ragged, windowed D = 64 case for the route's other
# instantiation.
FLASH_CASES = [(1, 64, 64, (12,), 0, None, 128), (1, 200, 200, (40,), 0, None, 128),
               (1, 512, 512, (102,), 0, None, 128), (1, 512, 512, (102,), 0, 128, 128),
               (3, 300, 300, (0, 150, 290), 0, None, 128),
               (1, 128, 512, (37,), 384, None, 128), (2, 200, 200, (17, 90), 0, 96, 64)]


def check_flash(torch, timer):
    """Kernel 2 at FLASH_CASES against ``masked_attention_ref``: bf16 (the
    tensor-core route) and float32 (the CUDA-core route) through
    ``attn_check``, with the planted faults start + 1 (and window + 1);
    query rows before their start must be exact zeros; every bf16 call one
    tensor-core launch.  Timed against the plain version and SDPA.
    Returns rows."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention.ref import masked_attention_ref
    kern2 = fa.flash_attention_masked
    g = torch.Generator(device=DEV).manual_seed(12)
    rows = []
    hq, hkv = 16, 2
    for b, sq, skv, starts, qo, window, d in FLASH_CASES:
        q = torch.randn((b, hq, sq, d), generator=g, device=DEV).to(torch.bfloat16)
        k = torch.randn((b, hkv, skv, d), generator=g, device=DEV).to(torch.bfloat16)
        v = torch.randn((b, hkv, skv, d), generator=g, device=DEV).to(torch.bfloat16)
        start = torch.tensor(starts, dtype=torch.int32, device=DEV)
        kw = dict(q_offset=qo, window=window)
        faults = {"start + 1": lambda q, k, v, st: kern2(q, k, v, st + 1, **kw)}
        if window:
            faults["window + 1"] = lambda q, k, v, st: kern2(
                q, k, v, st, q_offset=qo, window=window + 1)
        what = (f"flash_attention_masked B={b} Sq={sq} Skv={skv} start={list(starts)} "
                f"q_offset={qo} window={window} D={d}")
        tc0 = kern2.launches, kern2.tc_launches
        err = attn_check(torch, what, lambda q, k, v, st: kern2(q, k, v, st, **kw),
                         lambda q, k, v, st: masked_attention_ref(q, k, v, start=st, **kw),
                         (q, k, v, start), faults)
        calls, tc = kern2.launches - tc0[0], kern2.tc_launches - tc0[1]
        if tc * 2 != calls:   # attn_check: as many bf16 calls as float32 ones
            raise AssertionError(f"{what}: {tc} of {calls} launches on the tensor-core route")
        got = kern2(q, k, v, start, **kw)
        for i, st in enumerate(starts):   # pad queries: no attended column
            pad = got[i, :, :max(0, min(sq, st - qo))]
            if pad.numel() and bool((pad != 0).any()):
                raise AssertionError(f"{what}: a pad query row is not exact zeros")
        plain = lambda: masked_attention_ref(q, k, v, start=start, **kw)   # noqa: E731
        ms = timer(lambda: kern2(q, k, v, start, **kw))
        plain_ms = timer(plain, reps=5)
        qp = torch.arange(sq, device=DEV)[:, None] + qo
        kp = torch.arange(skv, device=DEV)[None, :]
        mask = (kp <= qp)[None] & (kp[None] >= start[:, None, None])
        if window:
            mask &= (kp > qp - window)[None]
        library_ms = timer(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask[:, None], enable_gqa=True))
        pairs = int(mask.sum())
        # q, k, v and start read once, the output (q's dtype) written once
        nbytes = (q.numel() + 2 * k.numel()) * q.element_size() + 4 * b \
            + got.numel() * got.element_size()
        bnd, by = bound_ms(nbytes, pairs * hq * d * 4, BF16_FLOPS_S)
        print(f"kernel {what} ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"library_ms={library_ms:.4f} bound_ms={bnd:.5f} ({by}) max_abs_err={err}",
              flush=True)
        rows.append(dict(B=b, S=sq, Skv=skv, start=list(starts), q_offset=qo, window=window,
                         D=d, ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bnd,
                         bound_by=by, max_abs_err=err))
    return rows


# The paged decode's checked calls (kernels 3 and 3b): name -> (B, Hq, Hkv,
# D, page, pps, pos, start, null table entries (slot, page), last slot
# idle).  "tick": the serving tick's shape (qwen2.5-3b's heads, 8 slots of
# <= 576 tokens), ragged pos and start, null entries inside live ranges.
# "G12": Hq 24 over Hkv 2 at D 64 with 32-token pages, one page a split
# on the H100 (split_plan): slot 0's pos the first column of a split (its
# last live split holds one column), slot 1's the last column of one, a
# null page inside slot 1's range, slot 2 a few columns in one split.
# PAGED_LONG (8 slots x 4096 tokens, the long-context timing) and
# PAGED_WIDE are checked without planted faults, which move a long row's
# output by less than the limit.  PAGED_WIDE: 33 slots x 8 kv heads (B Hkv
# >= 2 SMs: the plan alone fills the card, one split a row but for
# split_plan's cap of MAX_RUN_PAGES) of up to 54,400 tokens in 32-token
# pages, D 64 and G 1 to keep the plain version's gathers small; ragged pos
# and start, null entries inside live ranges.
PAGED_CASES = {
    "tick": (8, 16, 2, 128, 16, 36, (300, 511, 270, 543, 289, 400, 17, 0),
             (0, 200, 14, 31, 0, 399, 3, 0), ((1, 3), (3, 10)), True),
    "G12": (4, 24, 2, 64, 32, 16, (320, 255, 40, 0), (0, 64, 37, 0), ((1, 4),), True),
}
PAGED_LONG = (8, 16, 2, 128, 16, 256, (4095,) * 8, (0,) * 8, (), False)
PAGED_WIDE = (33, 8, 8, 64, 32, 1700, tuple(54399 - 1013 * i for i in range(33)),
              tuple(7 * i for i in range(33)), ((0, 5), (17, 600)), False)


def paged_case(torch, spec, int8_kv, seed=13):
    """One paged decode call's operands on the card: q, the pools (bf16,
    or int8 with bf16 scale pools as ``quantize_kv`` writes them), the
    block table (each live slot's pages [0, pos / page] on distinct pool
    pages, then the null entries), pos and start."""
    from repro_torch.models.kv_cache import quantize_kv
    b, hq, hkv, d, page, pps, pos, start, nulls, idle = spec
    g = torch.Generator(device=DEV).manual_seed(seed)
    npool = b * pps + 1
    q = torch.randn((b, hq, 1, d), generator=g, device=DEV).to(torch.bfloat16)
    kp = torch.randn((npool, page, hkv, d), generator=g, device=DEV).to(torch.bfloat16)
    vp = torch.randn((npool, page, hkv, d), generator=g, device=DEV).to(torch.bfloat16)
    scales = ()
    if int8_kv:
        (kp, ks), (vp, vs) = quantize_kv(kp), quantize_kv(vp)
        scales = (ks, vs)
    pos = torch.tensor(pos, dtype=torch.int32)
    start = torch.tensor(start, dtype=torch.int32)
    table = torch.zeros((b, pps), dtype=torch.int32)
    perm = torch.randperm(npool - 1, generator=torch.Generator().manual_seed(0)) + 1
    for i in range(b - idle):
        live = min(pps, int(pos[i]) // page + 1)
        table[i, :live] = perm[i * pps:i * pps + live].to(torch.int32)
    for i, j in nulls:
        table[i, j] = 0
    return q, kp, vp, table.to(DEV), pos.to(DEV), start.to(DEV), scales


def paged_bound(torch, q, table, pos, start, page, hkv, int8_kv):
    """(bound ms, bound_by, live pages) of one call: q, the K and V rows of
    the valid columns (mapped, start <= j <= pos) with their bf16 row
    scales when int8, the table, pos and start read once, the f32 output
    written once; the score and value products of the valid columns at the
    bf16 peak.  Live pages (non-null, meeting [start, pos]) are counted
    for the report."""
    b, hq, _, d = q.shape
    pps = table.shape[1]
    cols = torch.arange(pps * page, device=DEV)[None, :]
    mapped = torch.repeat_interleave(table != 0, page, dim=1)
    valid = mapped & (cols <= pos[:, None]) & (cols >= start[:, None])
    live_pages = int(valid.reshape(b, pps, page).any(-1).sum())
    row_bytes = (d + 2) if int8_kv else 2 * d
    cols_valid = int(valid.sum())
    nbytes = (q.numel() * 2 + cols_valid * hkv * row_bytes * 2
              + table.numel() * 4 + 8 * b + q.numel() * 4)
    bnd, by = bound_ms(nbytes, cols_valid * hq * d * 4, BF16_FLOPS_S)
    return bnd, by, live_pages


def check_paged(torch, timer, int8_kv=False):
    """Kernel 3 (bf16 pools) or 3b (``int8_kv``: int8 pools and bf16 scale
    pools as ``quantize_kv`` writes them) against its plain version at
    PAGED_CASES, PAGED_LONG and PAGED_WIDE through ``attn_check``, bf16 (the
    tensor-core route) and float32 (the CUDA-core route).  The int8
    branch's limits are the same att|v| multiples (TOL_BF16, TOL_F32),
    with att|v| the plain version applied to |codes| and the same scales:
    the kernel and the plain version both fold the V scale into the f32
    probability before its bf16 rounding, so the rounding argument above
    holds per column, and the split's own running max moves a rounding
    by no more (``csrc/paged_attention.cu``).  Planted faults: pos - 1,
    the combine dropping the last live split, and with int8 pools the V
    scale not folded and the K scale of the neighbouring page.  Two calls
    on the same inputs must be equal bit for bit; each case is timed
    against the plain version.  Returns rows, the tick's first."""
    from repro_torch.kernels._build import sm_count
    from repro_torch.kernels.paged_attention.paged_attention import (MAX_RUN_PAGES,
                                                                     paged_attention_kernel,
                                                                     split_plan)
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    name = "paged_attention_kernel[int8_kv]" if int8_kv else "paged_attention_kernel"
    rows = []
    for case, spec in (*PAGED_CASES.items(), ("long", PAGED_LONG), ("wide", PAGED_WIDE)):
        b, hq, hkv, d, page, pps = spec[:6]
        q, kp, vp, table, pos, start, scales = paged_case(torch, spec, int8_kv)
        pages, splits = split_plan(b, hkv, pps, sm_count(q.device))
        if case == "G12" and (int(pos[0]) % (pages * page) or (int(pos[1]) + 1) % (pages * page)):
            raise AssertionError(f"{name} [G12]: pos {pos.tolist()} is not on split boundaries "
                                 f"of {pages} pages")
        if case == "wide" and pages != MAX_RUN_PAGES:
            raise AssertionError(f"{name} [wide]: the plan is {pages} pages a split, not "
                                 f"split_plan's cap of {MAX_RUN_PAGES}")

        def kernel(q, kp, vp, pos, ks=None, vs=None, fault=0, table=table, start=start,
                   page=page):
            return paged_attention_kernel(q, kp, vp, table, pos, start, ks, vs,
                                          page_size=page, fault=fault)

        def plain_fn(q, kp, vp, pos, ks=None, vs=None, table=table, start=start, page=page):
            return paged_attention_ref(q, kp, vp, table, pos, start, page_size=page,
                                       k_scales=ks, v_scales=vs)

        faults = {}
        if case in PAGED_CASES:
            faults = {"pos - 1": lambda q, kp, vp, pos, *sc, k=kernel: k(q, kp, vp, pos - 1, *sc),
                      "combine drops the last live split":
                          lambda q, kp, vp, pos, *sc, k=kernel: k(q, kp, vp, pos, *sc, fault=1)}
            if int8_kv:
                faults["V scale not folded"] = lambda q, kp, vp, pos, ks, vs, k=kernel: k(
                    q, kp, vp, pos, ks, torch.ones_like(vs))
                faults["K scale of the neighbouring page"] = \
                    lambda q, kp, vp, pos, ks, vs, k=kernel: k(q, kp, vp, pos, ks.roll(1, 0), vs)
        what = f"{name} [{case}: B={b} Hq={hq} Hkv={hkv} D={d} page={page} pps={pps}]"
        err = attn_check(torch, what, kernel, plain_fn, (q, kp, vp, pos, *scales), faults)
        for dt in (torch.bfloat16, torch.float32):   # the same inputs, the same bits
            ops = [t.to(dt) if t.is_floating_point() else t for t in (q, kp, vp)]
            first = kernel(*ops, pos, *scales)
            if not torch.equal(first, kernel(*ops, pos, *scales)):
                raise AssertionError(f"{what} {dt}: two calls on the same inputs differ")
        args = (q, kp, vp, pos, *scales)
        ms = timer(lambda: kernel(*args))
        plain_ms = timer(lambda: plain_fn(*args), reps=5)
        bnd, by, live_pages = paged_bound(torch, q, table, pos, start, page, hkv, int8_kv)
        print(f"kernel {name} [{case}] B={b} Hq={hq} Hkv={hkv} D={d} page={page} pps={pps} "
              f"split {pages} pages x {splits} ({b * hkv * splits} blocks) "
              f"live_pages={live_pages} ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms=None "
              f"bound_ms={bnd:.5f} ({by}) max_abs_err={err}; two calls bit-identical",
              flush=True)
        rows.append(dict(case=case, B=b, Hq=hq, Hkv=hkv, D=d, page=page, pps=pps,
                         pages_a_split=pages, splits=splits, live_pages=live_pages, ms=ms,
                         plain_ms=plain_ms, library_ms=None, bound_ms=bnd, bound_by=by,
                         max_abs_err=err))
    return rows


def band_mask(torch, sq, skv, q_offset, causal, window):
    qp = torch.arange(sq, device=DEV)[:, None] + q_offset
    kp = torch.arange(skv, device=DEV)[None, :]
    mask = (kp <= qp) if causal else torch.ones((sq, skv), dtype=torch.bool, device=DEV)
    if window:
        mask &= kp > qp - window
    return mask


def bwd_units(torch, q, k, v, o, lse, do, window):
    """Per-element units of the backward kernels' limits, float32 (causal,
    q_offset 0).  With P the probabilities on the band and W = P (|dO|
    |V|^T + rowsum(|dO| |O|)), which bounds |dS| and the rounding of
    dP - D: dQ's unit is scale W |K|, dK's scale W^T |Q| and dV's P^T |dO|
    (dK and dV summed over each kv head's group of q heads).  Each output
    is a sum of at most Skv + D terms of its unit, each computed in f32
    from the same operands on both sides: their orders differ by at most
    (Skv + D) 2^-24 of the unit (2.5e-4 at Skv = 4096), under TOL_F32;
    with bf16 outputs both sides round once more, 2^-8 each, and the
    bf16 (tensor-core) route of 7b rounds P and dS to bf16 before the dV
    and dK products, which moves dV by at most 2^-8 of its unit and dK,
    since |dS| <= W, by at most 2^-8 of its unit: 3 x 2^-8 in all, under
    TOL_BF16 (the operands are the same bf16 values on both sides)."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = hq // hkv
    kr, vr = (t.float().repeat_interleave(g, 1) for t in (k, v))
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kr) * d**-0.5
    mask = band_mask(torch, sq, skv, 0, True, window)
    p = torch.exp(torch.where(mask, s - lse[..., None], -float("inf")))
    del s
    dabs = do.float().abs()
    w = p * (torch.einsum("bhqd,bhkd->bhqk", dabs, vr.abs())
             + (dabs * o.float().abs()).sum(-1, keepdim=True))
    unit_dq = d**-0.5 * torch.einsum("bhqk,bhkd->bhqd", w, kr.abs())
    unit_dk = d**-0.5 * torch.einsum("bhqk,bhqd->bhkd", w, q.float().abs())
    unit_dv = torch.einsum("bhqk,bhqd->bhkd", p, dabs)
    return (unit_dq, unit_dk.reshape(b, hkv, g, skv, d).sum(2),
            unit_dv.reshape(b, hkv, g, skv, d).sum(2))


def bwd_check(torch, what, q, k, v, do, window, faults):
    """Kernels 7b + 7c (``flash_attention_bwd``) against
    ``flash_attention_bwd_ref`` on the same operands, with o and lse from
    the plain forward, per element in units of ``bwd_units``, in bf16 and
    float32; each planted fault (a function of the same operands giving
    (dq, dk, dv)) must fail the check in both dtypes.  Returns the bf16 max
    abs error."""
    from repro_torch.kernels.flash_attention.flash_attention import flash_attention_bwd
    from repro_torch.kernels.flash_attention.ref import (flash_attention_bwd_ref,
                                                         flash_attention_ref)
    reads = {}
    for dt, tol in ((torch.bfloat16, TOL_BF16), (torch.float32, TOL_F32)):
        qd, kd, vd, dod = (t.to(dt) for t in (q, k, v, do))
        o, lse = flash_attention_ref(qd, kd, vd, window=window)
        ops = (qd, kd, vd, o, lse, dod)
        units = bwd_units(torch, *ops, window)
        want = [t.float() for t in flash_attention_bwd_ref(*ops, window=window)]
        got = flash_attention_bwd(*ops, window=window)
        torch.cuda.synchronize()
        if not all(torch.isfinite(t).all() for t in got):
            raise AssertionError(f"{what} {dt}: non-finite gradient")
        per = [excess(a, w, u, tol) for a, w, u in zip(got, want, units)]
        reads[dt] = (max(per), max(float((a.float() - w).abs().max())
                                   for a, w in zip(got, want)))
        reads[(dt, "per gradient")] = per
        for name, bad in faults.items():
            reads[(dt, name)] = max(excess(a, w, u, tol)
                                    for a, w, u in zip(bad(*ops), want, units))
        del units, want, got
    per = lambda dt: " / ".join(f"{r:.3f}" for r in reads[(dt, "per gradient")])  # noqa: E731
    line = (f"  {what}: err/limit bf16 {reads[torch.bfloat16][0]:.3f} "
            f"(dq / dk / dv {per(torch.bfloat16)}; max abs {reads[torch.bfloat16][1]:.3e}), "
            f"float32 {reads[torch.float32][0]:.3f} (dq / dk / dv {per(torch.float32)}; "
            f"max abs {reads[torch.float32][1]:.3e})")
    for name in faults:
        line += (f"; planted fault '{name}': float32 {reads[(torch.float32, name)]:.1f}"
                 f", bf16 {reads[(torch.bfloat16, name)]:.2f}")
    print(line, flush=True)
    if reads[torch.bfloat16][0] > 1 or reads[torch.float32][0] > 1:
        raise AssertionError(f"{what}: kernels disagree with the plain version")
    missed = [(n, str(dt)) for n in faults for dt in (torch.bfloat16, torch.float32)
              if reads[(dt, n)] <= 1]
    if missed:
        raise AssertionError(f"{what}: the check misses planted faults {missed}")
    return reads[torch.bfloat16][1]


def delta_check(torch, what, q, k, v, do, window):
    """The D_i = rowsum(dO * O) that kernel 7c writes on its bf16
    (tensor-core) route, against ``bwd_delta`` on the same operands.  A
    product of two bf16 values is exact in f32, so the two differ only in
    the order of D f32 additions, each side by at most (D - 1) 2^-24
    rowsum(|dO O|): the limit is 2 D 2^-24 rowsum(|dO O|).  D_i of the
    neighbouring row must read above it.  Returns the reading."""
    from repro_torch.kernels.flash_attention.flash_attention import (bwd_delta,
                                                                     flash_attention_bwd_dq)
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    qd, kd, vd, dod = (t.to(torch.bfloat16) for t in (q, k, v, do))
    o, lse = flash_attention_ref(qd, kd, vd, window=window)
    _, got = flash_attention_bwd_dq(qd, kd, vd, o, lse, dod, window=window,
                                    return_delta=True)
    want = bwd_delta(o, dod)
    unit = 2 * q.shape[-1] * 2.0**-24 * (dod.float() * o.float()).abs().sum(-1) + 1e-30
    read = float(((got - want).abs() / unit).max())
    fault = float(((got.roll(1, -1) - want).abs() / unit).max())
    print(f"  {what}: D_i written by 7c vs bwd_delta: err/limit {read:.3f} (max abs "
          f"{float((got - want).abs().max()):.3e}); planted fault 'D_i of the "
          f"neighbouring row' {fault:.1f}", flush=True)
    if not torch.isfinite(got).all() or read > 1:
        raise AssertionError(f"{what}: kernel 7c's D_i disagrees with bwd_delta")
    if fault <= 1:
        raise AssertionError(f"{what}: the D_i check misses a planted fault")
    return read


# the training kernels' check shapes: (B, Hq, Hkv, S, D, window); the first
# is one attention call of full-width minicpm-2b training at seq 4096
TRAIN_ATTN_SHAPES = [(1, 36, 36, 4096, 64, None), (1, 16, 2, 1024, 128, 256)]


def check_flash_train(torch, timer):
    """Kernels 7, 7b and 7c at TRAIN_ATTN_SHAPES (causal, Sq = Skv):
    checked against their plain versions (forward with ``attn_check``,
    plus the lse to TOL_F32 absolute, which bounds a sum of Skv positive
    f32 terms; backward with ``bwd_check``) and timed in bf16 beside
    their plain versions and SDPA (forward, and its autograd backward for
    7b and 7c, which computes all three gradients).  Returns {kernel:
    [row per shape]}."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.flash_attention import (
        bwd_delta, flash_attention, flash_attention_bwd, flash_attention_bwd_dkdv,
        flash_attention_bwd_dq)
    from repro_torch.kernels.flash_attention.ref import (attention_ref,
                                                         flash_attention_bwd_ref,
                                                         flash_attention_ref)
    gen = torch.Generator(device=DEV).manual_seed(14)
    rows = {n: [] for n in ("flash_attention", "flash_attention_bwd_dkdv",
                            "flash_attention_bwd_dq")}
    # what the kernels do not take must raise on the card, not fall back
    for what, bad, exc in (("head_dim 32", torch.zeros((1, 2, 8, 32), device=DEV), ValueError),
                           ("float16", torch.zeros((1, 2, 8, 64), device=DEV).half(),
                            TypeError)):
        for name, call in (("forward", lambda t: flash_attention(t, t, t)),
                           ("backward", lambda t: flash_attention_bwd(
                               t, t, t, t, torch.zeros(t.shape[:3], device=DEV), t))):
            try:
                call(bad)
            except exc:
                continue
            raise AssertionError(f"flash_attention {name} took {what} on the card")
    print("  flash_attention forward and backward refuse head_dim 32 and float16 "
          "on the card", flush=True)
    for b, hq, hkv, s, d, window in TRAIN_ATTN_SHAPES:
        q, do = (torch.randn((b, hq, s, d), generator=gen, device=DEV) for _ in range(2))
        k, v = (torch.randn((b, hkv, s, d), generator=gen, device=DEV) for _ in range(2))
        shape = f"B={b} Hq={hq} Hkv={hkv} D={d} S={s} window={window}"
        fwd_faults = {"causal mask off by one": lambda q, k, v: flash_attention(
            q, k, v, window=window, q_offset=1)[0]}
        if window:
            fwd_faults["window + 1"] = lambda q, k, v: flash_attention(
                q, k, v, window=window + 1)[0]
        err_f = attn_check(
            torch, f"flash_attention {shape}",
            lambda q, k, v: flash_attention(q, k, v, window=window)[0],
            lambda q, k, v: attention_ref(q, k, v, window=window).float(),
            (q, k, v), fwd_faults)
        lse_err = 0.0
        for dt in (torch.bfloat16, torch.float32):
            ops = [t.to(dt) for t in (q, k, v)]
            lse_err = max(lse_err, float((flash_attention(*ops, window=window)[1]
                                          - flash_attention_ref(*ops, window=window)[1])
                                         .abs().max()))
        print(f"  flash_attention {shape}: lse max abs err {lse_err:.3e} "
              f"(limit {TOL_F32:.3e})", flush=True)
        if lse_err > TOL_F32:
            raise AssertionError(f"flash_attention {shape}: lse disagrees")

        def causal_off_by_one(q, k, v, o, lse, do):
            return flash_attention_bwd(q, k, v, o, lse, do, window=window, q_offset=1)

        def lse_of_neighbour(q, k, v, o, lse, do):
            return flash_attention_bwd(q, k, v, o, lse.roll(1, -1).contiguous(), do,
                                       window=window)

        bwd_faults = {"causal mask off by one in the backward": causal_off_by_one,
                      "lse of the neighbouring row": lse_of_neighbour}
        if hq > hkv:
            def first_head_only(q, k, v, o, lse, do):
                sel = lambda t: t[:, ::hq // hkv].contiguous()   # noqa: E731
                dk, dv = flash_attention_bwd_dkdv(sel(q), k, v, sel(o), sel(lse), sel(do),
                                                  window=window)
                return flash_attention_bwd_dq(q, k, v, o, lse, do, window=window), dk, dv
            bwd_faults["dK/dV of only the first q head of a group"] = first_head_only
        err_b = bwd_check(torch, f"flash_attention_bwd {shape}", q, k, v, do, window,
                          bwd_faults)
        delta_read = delta_check(torch, f"flash_attention_bwd_dq {shape}", q, k, v, do,
                                 window)

        # times, bf16 (the training dtype)
        qb, kb, vb, dob = (t.to(torch.bfloat16) for t in (q, k, v, do))
        del q, k, v, do
        o, lse = flash_attention(qb, kb, vb, window=window)
        mask = band_mask(torch, s, s, 0, True, window)
        pairs = int(mask.sum())
        fw = dict(window=window)
        lib_mask = None if window is None else mask[None, None]
        ql, kl, vl = (t.detach().clone().requires_grad_(True) for t in (qb, kb, vb))
        lib_out = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=lib_mask,
                                                 is_causal=lib_mask is None,
                                                 enable_gqa=hq > hkv)
        lib_fwd = timer(lambda: F.scaled_dot_product_attention(
            qb, kb, vb, attn_mask=lib_mask, is_causal=lib_mask is None, enable_gqa=hq > hkv))
        lib_bwd = timer(lambda: torch.autograd.grad(lib_out, (ql, kl, vl), dob,
                                                    retain_graph=True))
        plain_bwd = timer(lambda: flash_attention_bwd_ref(qb, kb, vb, o, lse, dob, **fw),
                          reps=3)
        # the plain D_i pass, which a standalone call of 7b (no delta) runs;
        # on the training path 7c writes D_i in its own pass
        delta_ms = timer(lambda: bwd_delta(o, dob))
        delta = flash_attention_bwd_dq(qb, kb, vb, o, lse, dob, return_delta=True, **fw)[1]
        both_ms = timer(lambda: flash_attention_bwd(qb, kb, vb, o, lse, dob, **fw))
        print(f"  bwd_delta (D_i = rowsum(dO * O) in torch, off the training path) "
              f"{shape}: {delta_ms:.4f} ms; flash_attention_bwd (7c, then 7b with 7c's "
              f"D_i): {both_ms:.4f} ms", flush=True)
        e = 2   # bf16 bytes
        io = qb.numel() * e                       # one [B, Hq, S, D] tensor
        kv = kb.numel() * e
        lse_b = lse.numel() * 4                   # one f32 [B, Hq, S] row term
        cases = {   # name -> (kernel, plain, library, bytes, flops)
            "flash_attention": (lambda: flash_attention(qb, kb, vb, **fw),
                                lambda: flash_attention_ref(qb, kb, vb, **fw), lib_fwd,
                                io + 2 * kv + io + lse_b, 4 * pairs * hq * d,
                                err_f),
            # q, dO, K, V, lse and D_i read; dK, dV written
            "flash_attention_bwd_dkdv": (
                lambda: flash_attention_bwd_dkdv(qb, kb, vb, o, lse, dob, delta=delta,
                                                 **fw), None,
                lib_bwd, 2 * io + 2 * kv + 2 * lse_b + 2 * kv, 8 * pairs * hq * d, err_b),
            # q, O, dO, K, V and lse read; dQ and D_i written
            "flash_attention_bwd_dq": (
                lambda: flash_attention_bwd_dq(qb, kb, vb, o, lse, dob, **fw), None,
                lib_bwd, 3 * io + 2 * kv + lse_b + io + lse_b, 6 * pairs * hq * d, err_b),
        }
        for name, (kern, plain, lib_ms, nbytes, flops, err) in cases.items():
            ms = timer(kern)
            plain_ms = timer(plain, reps=3) if plain is not None else plain_bwd
            bnd, by = bound_ms(nbytes, flops, BF16_FLOPS_S)
            print(f"kernel {name} {shape} causal ms={ms:.4f} plain_ms={plain_ms:.4f} "
                  f"library_ms={lib_ms:.4f} bound_ms={bnd:.5f} ({by}) "
                  f"max_abs_err={err}", flush=True)
            rows[name].append(dict(S=s, Hq=hq, Hkv=hkv, D=d, window=window, ms=ms,
                                   plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bnd,
                                   bound_by=by, max_abs_err=err))
            if name == "flash_attention_bwd_dkdv":
                rows[name][-1]["standalone_delta_ms"] = delta_ms
            if name == "flash_attention_bwd_dq":
                rows[name][-1].update(delta_err_over_limit=delta_read,
                                      bwd_7c_then_7b_ms=both_ms)
        del qb, kb, vb, dob, o, lse, ql, kl, vl, lib_out, delta
        torch.cuda.empty_cache()
    return rows


# The SSD kernels' check shapes: (B, L, H, P, G, N, chunk).  The first is
# one SSD call of full-width mamba2-370m training per batch row; the
# second jamba's grouped B/C (ngroups 8); the third one short chunk
# (L < chunk).  SSD_TIME_SHAPE is the training step's call (microbatch 4).
SSD_SHAPES = [(1, 4096, 32, 64, 1, 128, 128), (2, 1024, 64, 64, 8, 128, 128),
              (1, 64, 32, 64, 1, 128, 128)]
SSD_TIME_SHAPE = (4, 4096, 32, 64, 1, 128, 128)
SSD_KERNELS = ("ssd_scan", "ssd_scan_bwd_state", "ssd_scan_bwd_chunk")
SSD_FWD_PARTS = ("states", "carry", "out")   # kernel 8's three launches
SSD_BWD_STATE_PARTS = ("own", "carry")        # kernel 8b's two


def ssd_inputs(torch, gen, shape):
    """x, dt, a, b, c and an output gradient dy at ``shape``, as the
    model makes them at init: dt log-uniform in [0.001, 0.1] (as
    ``ssm.init`` draws it between ``SSMConfig`` dt_min and dt_max), a =
    -(1..H) (``a_log = log(1..H)``), x, B, C, dy normal.  The slowest
    heads then carry ~6% of the state across a 128-step chunk."""
    b, l, h, p, g, n, _ = shape
    x, dy = (torch.randn((b, l, h, p), generator=gen, device=DEV) for _ in range(2))
    lo, hi = math.log(1e-3), math.log(1e-1)
    dt = torch.exp(torch.rand((b, l, h), generator=gen, device=DEV) * (hi - lo) + lo)
    a = -torch.arange(1, h + 1, dtype=torch.float32, device=DEV)
    bm, cm = (torch.randn((b, l, g, n), generator=gen, device=DEV) for _ in range(2))
    return x, dt, a, bm, cm, dy


def ssd_units(torch, x, dt, a, b, c, dy, chunk):
    """Per-element units and decay slack of the SSD kernels' limits.

    The unit of each output is its plain computation on absolute values
    (|x|, |B|, |C|, |dy|, and in the backward every subtraction an
    addition and |a| for a): it bounds the sum of the absolute values of
    the terms the output sums.  Kernel and plain version compute the
    same terms in float32 from the same operands in other orders: the
    in-chunk dots (N or P terms), the sums over the chunk's Q positions
    and the state carried over the nc chunks ((Q + 2) roundings a chunk)
    differ by at most (N + P + Q + 8 + nc (Q + 2)) 2^-24 of the unit,
    2.7e-4 at nc = 32 and Q = 128, under TOL_F32 = 2^-11.  The in-chunk
    cumsum is sequential in the kernel and a parallel scan in
    torch.cumsum: each side's cum_i is within Q 2^-24 |cum|max of the
    exact sum, so each decay factor (exp of a difference of two cums)
    differs between the sides by a relative 4 Q 2^-24 |cum|max, and a
    term carries at most two of them: the slack E = 8 Q 2^-24 |cum|max
    per (batch row, head), from this run's data (|cum| reaches ~400 at
    a = -32).

    da is a sum over every position of every chunk and batch row of
    terms of both signs, and the in-chunk terms cancel exactly in
    exact arithmetic (the intra-chunk dcum sums to 0 over a chunk): its
    unit is ~1e4 |da|, a sound limit that no wrong da reaches (leaving
    out 31 of 32 chunks reads ~0.1 of it).  So da is held to a second,
    tighter limit: each side's da is sum_k S_k dcum_k (S_k = sum_{m<=k}
    dt_m, the weight of the reverse cumsum), each dcum_k a sum of 2Q + 3
    terms rounded within (2Q + 8) 2^-24 of its unit; over the K = B nc Q
    positions of a head these per-position errors are independent and
    add as a random walk, so the two sides differ by about
    sigma_h = (2Q + 8) 2^-24 sqrt(sum_k (S_k unit(dcum_k))^2); the
    limit is 6 sigma_h (+ E of the decays).  Returns (units, E, sigma)
    with units and E dicts keyed y, h0s, dhs, dx, ddt, da, db, dc and
    sigma [H]."""
    from repro_torch.kernels.ssd_scan.ref import (_chunk_operands, ssd_scan_bwd_state_ref,
                                                  ssd_scan_fwd_ref)
    bsz, l, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    ax, ab, ac, ady = x.abs(), b.abs(), c.abs(), dy.abs()
    y_u, h0 = ssd_scan_fwd_ref(ax, dt, a, ab, ac, chunk)
    dhs = ssd_scan_bwd_state_ref(dt, a, ac, ady, chunk)
    xf, dtf, bf, cf, cum, decay = _chunk_operands(ax, dt, a, ab, ac, chunk)
    nc, q = xf.shape[1], xf.shape[2]
    dyf = ady.reshape(bsz, nc, q, h, p)
    h0c, dhc = h0.transpose(1, 2), dhs.transpose(1, 2)
    dt_j = dtf.transpose(2, 3)[..., None, :]
    s = torch.einsum("bcihn,bcjhn->bchij", cf, bf)
    w = torch.einsum("bcihp,bcjhp->bchij", dyf, xf) * decay
    ws = w * s
    ddt = ws.sum(-2).transpose(2, 3)
    t = ws * dt_j
    dcum = (t.sum(-1) + t.sum(-2)).transpose(2, 3)
    dx = torch.einsum("bchij,bcihp->bcjhp", s * decay * dt_j, dyf)
    del s, ws, t
    wd = w * dt_j
    del w
    dc = torch.einsum("bchij,bcjhn->bcihn", wd, bf)
    db = torch.einsum("bchij,bcihn->bcjhn", wd, cf)
    del wd
    tail = torch.exp(cum[:, :, -1:, :] - cum)
    dcs = torch.einsum("bchpn,bcihp->bcihn", h0c, dyf) * torch.exp(cum)[..., None]
    dc = dc + dcs
    dcum = dcum + (cf * dcs).sum(-1)
    v = torch.einsum("bchpn,bcjhp->bcjhn", dhc, xf) * tail[..., None]
    db = db + v * dtf[..., None]
    dds = (bf * v).sum(-1)
    ddt = ddt + dds
    dx = dx + torch.einsum("bchpn,bcjhn->bcjhp", dhc, bf) * (tail * dtf)[..., None]
    u = dtf * dds
    last = torch.exp(cum[:, :, -1]) * (h0c * dhc).sum((-2, -1)) + u.sum(2)
    dcum = dcum + u
    dcum = torch.cat([dcum[:, :, :-1], dcum[:, :, -1:] + last[:, :, None]], dim=2)
    dda = dcum.flip(2).cumsum(2).flip(2)
    ddt = ddt + a.abs() * dda
    sigma = (2 * q + 8) * 2.0**-24 * (torch.cumsum(dtf, 2) * dcum).square().sum((0, 1, 2)).sqrt()
    units = dict(y=y_u, h0s=h0, dhs=dhs, dx=dx.reshape(bsz, l, h, p),
                 ddt=ddt.reshape(bsz, l, h), da=(dtf * dda).sum((0, 1, 2)),
                 db=db.reshape(bsz, l, g, h // g, n).sum(3),
                 dc=dc.reshape(bsz, l, g, h // g, n).sum(3))
    e = 8 * q * 2.0**-24 * cum.abs().amax(dim=(1, 2))            # [B, H]
    eg = e.reshape(bsz, g, h // g).amax(-1)
    slack = dict(y=e[:, None, :, None], h0s=e[:, :, None, None, None],
                 dhs=e[:, :, None, None, None], dx=e[:, None, :, None],
                 ddt=e[:, None, :], da=e.amax(0), db=eg[:, None, :, None],
                 dc=eg[:, None, :, None])
    return units, slack, sigma


SSD_FWD_OUT = ("y", "h0s")
SSD_BWD_OUT = ("dx", "ddt", "da", "db", "dc")


def ssd_reading(got, want, units, slack, names, sigma=None):
    """max over ``names`` of max |got - want| / ((TOL_F32 + E) unit): <= 1
    passes (an output whose unit is 0 must be exactly 0); with ``sigma``,
    da is also held to 6 sigma (1 + E) (see ``ssd_units``)."""
    r = max(float(((g - w).abs() / ((TOL_F32 + slack[k]) * units[k] + 1e-30)).max())
            for k, g, w in zip(names, got, want))
    if sigma is not None and "da" in names:
        g, w = got[names.index("da")], want[names.index("da")]
        r = max(r, float(((g - w).abs() / (6 * sigma * (1 + slack["da"]) + 1e-30)).max()))
    return r


def ssd_bounds(shape):
    """(bytes, flops) per kernel at ``shape``: each input read once, each
    output written once, float32; flops on the causal half of the [Q, Q]
    chunk products (the pairs j <= i this run's data needs) plus the
    [Q, P, N] state products."""
    b, l, h, p, g, n, q = shape
    nc, e, pairs = l // q, 4, q * (q + 1) // 2
    xb, dtb, bcb, st = b * l * h * p, b * l * h, b * l * g * n, b * h * nc * p * n
    return {
        "ssd_scan": (e * (2 * xb + dtb + h + 2 * bcb + st),
                     b * h * nc * (2 * pairs * (n + p) + 4 * q * p * n)),
        "ssd_scan_bwd_state": (e * (dtb + h + bcb + xb + st),
                               b * h * (nc - 1) * 2 * q * p * n),
        "ssd_scan_bwd_chunk": (e * (3 * xb + 2 * dtb + 2 * h + 4 * bcb + 2 * st),
                               b * h * nc * (2 * pairs * (2 * p + 3 * n) + 6 * q * p * n)),
    }


def check_ssd(torch, timer):
    """Kernels 8, 8b and 8c at SSD_SHAPES, float32: the forward's y and
    h0s against ``ssd_scan_fwd_ref`` (``ssd_scan_chunked`` with its
    states), 8b's dhs against ``ssd_scan_bwd_state_ref`` and the five
    gradients of 8b + 8c against ``ssd_scan_bwd_ref``, per element
    within (TOL_F32 + E) units (``ssd_units``); planted faults must read
    above 1.  What the wrappers do not take must raise on the card.  Then
    all three, their plain versions and their bounds at SSD_TIME_SHAPE:
    bytes at the HBM rate against operations at the f32 CUDA-core peak
    (``f32_bound_ms``) and, as all three take their chunk products as
    three split-bf16 tensor-core passes, against three bf16 passes at the
    tensor-core peak (``bound_ms``), with the card's name and power limit;
    and one profiled run of
    the three for their device time by CUDA kernel (kernel 8 is three, 8b
    two).  No single
    PyTorch call computes the SSD scan: library_ms is None.  Returns
    {kernel: [row per shape]}."""
    from repro_torch.kernels.ssd_scan.ref import (ssd_scan_bwd_chunk_ref,
                                                  ssd_scan_bwd_state_ref, ssd_scan_fwd_ref)
    from repro_torch.kernels.ssd_scan.ssd_scan import (ssd_scan, ssd_scan_bwd,
                                                       ssd_scan_bwd_chunk,
                                                       ssd_scan_bwd_state)
    gen = torch.Generator(device=DEV).manual_seed(15)
    rows = {k: [] for k in SSD_KERNELS}
    x, dt, a, bm, cm, dy = ssd_inputs(torch, gen, (1, 128, 2, 64, 1, 128, 64))
    h0 = torch.zeros((1, 2, 2, 64, 128), device=DEV)
    refusals = {
        "bfloat16 input": (TypeError, lambda: ssd_scan(x.bfloat16(), dt, a, bm, cm, chunk=64)),
        "bfloat16 in the backward": (TypeError, lambda: ssd_scan_bwd(
            x, dt, a, bm, cm, h0, dy.bfloat16(), chunk=64)),
        "L not a multiple of chunk": (ValueError, lambda: ssd_scan(
            x[:, :96].contiguous(), dt[:, :96].contiguous(), a, bm[:, :96].contiguous(),
            cm[:, :96].contiguous(), chunk=64)),
        "L not a multiple of chunk, backward": (ValueError, lambda: ssd_scan_bwd_state(
            dt[:, :96].contiguous(), a, cm[:, :96].contiguous(), dy[:, :96].contiguous(),
            chunk=64)),
    }
    for what, (exc, call) in refusals.items():
        try:
            call()
        except exc:
            continue
        raise AssertionError(f"the SSD wrappers took {what} on the card")
    print("  ssd_scan forward and backward refuse bfloat16 and L % chunk != 0 on the card",
          flush=True)

    for shape in SSD_SHAPES:
        b, l, h, p, g, n, q = shape
        hpg, nc = h // g, l // min(q, l)
        tag = f"B={b} L={l} H={h} P={p} G={g} N={n} chunk={q}"
        x, dt, a, bm, cm, dy = ssd_inputs(torch, gen, shape)
        units, slack, sigma = ssd_units(torch, x, dt, a, bm, cm, dy, q)
        want_f = ssd_scan_fwd_ref(x, dt, a, bm, cm, q)
        got_f = ssd_scan(x, dt, a, bm, cm, chunk=q, save_states=True)
        dhs_ref = ssd_scan_bwd_state_ref(dt, a, cm, dy, q)
        want_b = ssd_scan_bwd_chunk_ref(x, dt, a, bm, cm, want_f[1], dhs_ref, dy, q)
        got_dhs = ssd_scan_bwd_state(dt, a, cm, dy, chunk=q)
        got_b = ssd_scan_bwd(x, dt, a, bm, cm, got_f[1], dy, chunk=q)
        torch.cuda.synchronize()
        if not all(torch.isfinite(t).all() for t in (*got_f, got_dhs, *got_b)):
            raise AssertionError(f"ssd_scan {tag}: non-finite output or gradient")
        reads = {
            "ssd_scan": ssd_reading(got_f, want_f, units, slack, SSD_FWD_OUT),
            "ssd_scan_bwd_state": ssd_reading((got_dhs,), (dhs_ref,), units, slack, ("dhs",)),
            "ssd_scan_bwd_chunk": ssd_reading(got_b, want_b, units, slack, SSD_BWD_OUT,
                                              sigma),
        }
        errs = {
            "ssd_scan": max(float((u - v).abs().max()) for u, v in zip(got_f, want_f)),
            "ssd_scan_bwd_state": float((got_dhs - dhs_ref).abs().max()),
            "ssd_scan_bwd_chunk": max(float((u - v).abs().max()) for u, v in zip(got_b, want_b)),
        }

        # planted faults: each must read above its limit
        faults = {"intra-chunk mask off by one (j < i)": (
            "ssd_scan", lambda: ssd_scan(x, dt, a, bm, cm, chunk=q, save_states=True, fault=2),
            SSD_FWD_OUT, want_f)}
        if nc > 1:
            faults["carried state not decayed"] = (
                "ssd_scan", lambda: ssd_scan(x, dt, a, bm, cm, chunk=q, save_states=True,
                                             fault=1), SSD_FWD_OUT, want_f)
            faults["dh not carried across chunks (8b's carry)"] = (
                "ssd_scan_bwd_chunk", lambda: ssd_scan_bwd_chunk(
                    x, dt, a, bm, cm, got_f[1],
                    ssd_scan_bwd_state(dt, a, cm, dy, chunk=q, fault=3), dy, chunk=q),
                SSD_BWD_OUT, want_b)
            faults["row i weighted by exp(cum_{i+1}) (8b's own)"] = (
                "ssd_scan_bwd_state", lambda: (ssd_scan_bwd_state(dt, a, cm, dy, chunk=q,
                                                                  fault=4),),
                ("dhs",), (dhs_ref,))

            def first_chunk_da():
                dx, ddt, _, db, dc = got_b
                sl = lambda t: t[:, :q].contiguous()   # noqa: E731
                da0 = ssd_scan_bwd_chunk(sl(x), sl(dt), a, sl(bm), sl(cm),
                                         got_f[1][:, :, :1].contiguous(),
                                         got_dhs[:, :, :1].contiguous(), sl(dy), chunk=q)[2]
                return dx, ddt, da0, db, dc
            faults["da from only the first chunk"] = ("ssd_scan_bwd_chunk", first_chunk_da,
                                                      SSD_BWD_OUT, want_b)
        if hpg > 1:
            def first_head_dbdc():
                dx, ddt, da, _, _ = got_b
                hs = lambda t: t[:, :, ::hpg].contiguous()   # noqa: E731
                _, _, _, db, dc = ssd_scan_bwd_chunk(
                    hs(x), hs(dt), a[::hpg].contiguous(), bm, cm,
                    got_f[1][:, ::hpg].contiguous(), got_dhs[:, ::hpg].contiguous(), hs(dy),
                    chunk=q)
                return dx, ddt, da, db, dc
            faults["dB / dC from only the first head of a group"] = (
                "ssd_scan_bwd_chunk", first_head_dbdc, SSD_BWD_OUT, want_b)
        fault_reads = {name: ssd_reading(call(), want, units, slack, outs, sigma)
                       for name, (_, call, outs, want) in faults.items()}
        line = f"  ssd {tag}: err/limit " + ", ".join(
            f"{k} {r:.3f} (max abs {errs[k]:.3e})" for k, r in reads.items())
        line += f"; E max {float(slack['y'].max()):.3e}"
        for name, r in fault_reads.items():
            line += f"; planted fault '{name}': {r:.1f}"
        print(line, flush=True)
        if max(reads.values()) > 1:
            raise AssertionError(f"ssd {tag}: kernels disagree with the plain versions")
        missed = [k for k, r in fault_reads.items() if r <= 1]
        if missed:
            raise AssertionError(f"ssd {tag}: the limits miss planted faults {missed}")
        for k in SSD_KERNELS:
            rows[k].append(dict(shape=tag, reading=reads[k], max_abs_err=errs[k], ms=None,
                                plain_ms=None, library_ms=None, bound_ms=None,
                                bound_by=None))
        del units, slack, sigma, want_f, got_f, want_b, got_b, dhs_ref, got_dhs
        torch.cuda.empty_cache()

    # times at the training step's shape
    b, l, h, p, g, n, q = SSD_TIME_SHAPE
    tag = f"B={b} L={l} H={h} P={p} G={g} N={n} chunk={q}"
    x, dt, a, bm, cm, dy = ssd_inputs(torch, gen, SSD_TIME_SHAPE)
    y, h0s = ssd_scan(x, dt, a, bm, cm, chunk=q, save_states=True)
    dhs = ssd_scan_bwd_state(dt, a, cm, dy, chunk=q)
    grads = ssd_scan_bwd_chunk(x, dt, a, bm, cm, h0s, dhs, dy, chunk=q)
    yr, h0r = ssd_scan_fwd_ref(x, dt, a, bm, cm, q)
    dhr = ssd_scan_bwd_state_ref(dt, a, cm, dy, q)
    gr = ssd_scan_bwd_chunk_ref(x, dt, a, bm, cm, h0s, dhs, dy, q)
    errs = {"ssd_scan": max(float((y - yr).abs().max()), float((h0s - h0r).abs().max())),
            "ssd_scan_bwd_state": float((dhs - dhr).abs().max()),
            "ssd_scan_bwd_chunk": max(float((u - v).abs().max()) for u, v in zip(grads, gr))}
    del yr, h0r, dhr, gr
    cases = {
        "ssd_scan": (lambda: ssd_scan(x, dt, a, bm, cm, chunk=q, save_states=True),
                     lambda: ssd_scan_fwd_ref(x, dt, a, bm, cm, q)),
        "ssd_scan_bwd_state": (lambda: ssd_scan_bwd_state(dt, a, cm, dy, chunk=q),
                               lambda: ssd_scan_bwd_state_ref(dt, a, cm, dy, q)),
        "ssd_scan_bwd_chunk": (
            lambda: ssd_scan_bwd_chunk(x, dt, a, bm, cm, h0s, dhs, dy, chunk=q),
            lambda: ssd_scan_bwd_chunk_ref(x, dt, a, bm, cm, h0s, dhs, dy, q)),
    }
    bounds = ssd_bounds(SSD_TIME_SHAPE)
    card = card_line()
    for name, (kern, plain) in cases.items():
        ms = timer(kern)
        plain_ms = timer(plain, reps=3)
        nbytes, flops = bounds[name]
        f32_bnd, f32_by = bound_ms(nbytes, flops, F32_FLOPS_S)
        bnd, by = bound_ms(nbytes, 3 * flops, BF16_FLOPS_S)
        print(f"kernel {name} {tag} ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms=None "
              f"bound_ms={bnd:.5f} ({by}; {flops:.4e} flops, x3 bf16 passes, {nbytes:.4e} "
              f"bytes; bytes alone {nbytes / HBM_BYTES_S * 1e3:.5f}, three passes alone "
              f"{3 * flops / BF16_FLOPS_S * 1e3:.5f}) f32_bound_ms={f32_bnd:.5f} ({f32_by}) "
              f"max_abs_err={errs[name]:.3e} [{card}]", flush=True)
        rows[name].append(dict(shape=tag, ms=ms, plain_ms=plain_ms, library_ms=None,
                               bound_ms=bnd, bound_by=by, f32_bound_ms=f32_bnd,
                               max_abs_err=errs[name]))
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            for kern, _ in cases.values():
                kern()
        torch.cuda.synchronize()
    launches = {}   # kernel name -> (device ms, launches) over the traced launches
    for ev in prof.events():
        us = getattr(ev, "device_time_total", 0)
        if us and "ssd" in ev.name and str(getattr(ev, "device_type", "")).endswith("CUDA"):
            name = ev.name.replace("(anonymous namespace)::", "").split("(")[0]
            ms, k = launches.get(name, (0.0, 0))
            launches[name] = (ms + us / 1e3, k + 1)
    by_kernel = {name: ms / k for name, (ms, k) in launches.items()}
    print(f"  SSD device ms a launch by CUDA kernel ({tag}; launches traced): "
          + ", ".join(f"{k} {v:.4f} ({launches[k][1]})" for k, v in sorted(by_kernel.items())),
          flush=True)
    rows["ssd_scan"][-1]["device_ms_by_kernel"] = by_kernel
    del x, dt, a, bm, cm, dy, y, h0s, dhs, grads
    torch.cuda.empty_cache()
    return rows


def ssd_train_faults():
    """Planted faults for the SSM training comparison: the forward kernel
    with a fault planted, or the backward as ``SSDScan`` calls it
    (``ops.ssd_scan_bwd``) with one part wrong.  name -> (module,
    attribute, wrap)."""
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan.ssd_scan import ssd_scan_bwd_chunk, ssd_scan_bwd_state

    def no_dh_carry(f):
        def g(x, dt, a, b, c, h0s, dy, *, chunk):
            dhs = ssd_scan_bwd_state(dt, a, c, dy, chunk=chunk, fault=3)
            return ssd_scan_bwd_chunk(x, dt, a, b, c, h0s, dhs, dy, chunk=chunk)
        return g

    def first_chunk_da(f):
        def g(x, dt, a, b, c, h0s, dy, *, chunk):
            dx, ddt, _, db, dc = f(x, dt, a, b, c, h0s, dy, chunk=chunk)
            q = min(chunk, x.shape[1])
            dhs = ssd_scan_bwd_state(dt, a, c, dy, chunk=chunk)
            sl = lambda t: t[:, :q].contiguous()   # noqa: E731
            da0 = ssd_scan_bwd_chunk(sl(x), sl(dt), a, sl(b), sl(c), h0s[:, :, :1].contiguous(),
                                     dhs[:, :, :1].contiguous(), sl(dy), chunk=chunk)[2]
            return dx, ddt, da0, db, dc
        return g

    def first_head_dbdc(f):
        def g(x, dt, a, b, c, h0s, dy, *, chunk):
            dx, ddt, da, _, _ = f(x, dt, a, b, c, h0s, dy, chunk=chunk)
            hpg = x.shape[2] // b.shape[2]
            hs = lambda t: t[:, :, ::hpg].contiguous()   # noqa: E731
            _, _, _, db, dc = f(hs(x), hs(dt), a[::hpg].contiguous(), b, c,
                                h0s[:, ::hpg].contiguous(), hs(dy), chunk=chunk)
            return dx, ddt, da, db, dc
        return g

    return {
        "forward state carried without decay": (
            ssd_ops, "ssd_scan", lambda f: lambda *a, **kw: f(*a, fault=1, **kw)),
        "forward mask off by one (j < i)": (
            ssd_ops, "ssd_scan", lambda f: lambda *a, **kw: f(*a, fault=2, **kw)),
        "backward dh not carried across chunks": (ssd_ops, "ssd_scan_bwd", no_dh_carry),
        "backward da from only the first chunk": (ssd_ops, "ssd_scan_bwd", first_chunk_da),
        "backward dB / dC from only the first head": (ssd_ops, "ssd_scan_bwd",
                                                      first_head_dbdc),
    }


def wrappers(torch):
    """Every kernel wrapper of the port (name -> wrapper with its
    ``launches`` count) and every ops-level plain route (with its
    ``plain_launches`` count)."""
    from repro_torch.kernels.ent_matmul import ops as ent_ops
    from repro_torch.kernels.ent_matmul.ent_matmul import (ent_matmul, ent_matmul_packed,
                                                           ent_matmul_packed_fused)
    from repro_torch.kernels.flash_attention import ops as attn_ops
    from repro_torch.kernels.flash_attention.flash_attention import flash_attention_masked
    from repro_torch.kernels.int8_matmul import ops as int8_ops
    from repro_torch.kernels.int8_matmul.int8_matmul import int8_matmul
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention, flash_attention_bwd_dkdv, flash_attention_bwd_dq)
    from repro_torch.kernels.paged_attention import ops as paged_ops
    from repro_torch.kernels.paged_attention.paged_attention import paged_attention_kernel
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan.ssd_scan import (ssd_scan, ssd_scan_bwd_chunk,
                                                       ssd_scan_bwd_state)
    kernels = (ent_matmul_packed_fused, flash_attention_masked, paged_attention_kernel,
               int8_matmul, ent_matmul, ent_matmul_packed, flash_attention,
               flash_attention_bwd_dkdv, flash_attention_bwd_dq, ssd_scan,
               ssd_scan_bwd_state, ssd_scan_bwd_chunk)
    plains = (ent_ops.ent_quantized_matmul_fused, ent_ops.ent_quantized_matmul,
              ent_ops.ent_quantized_matmul_packed, int8_ops.quantized_matmul,
              attn_ops.masked_attention, paged_ops.paged_attention, attn_ops.attention,
              ssd_ops.ssd)
    return kernels, plains, paged_attention_kernel


def reset_counts(torch):
    kernels, plains, paged = wrappers(torch)
    for f in kernels:
        f.launches = 0
        for route in ("tc_launches", "stream_launches",
                      *(f"{part}_launches" for part in SSD_FWD_PARTS + SSD_BWD_STATE_PARTS)):
            if hasattr(f, route):
                setattr(f, route, 0)
    paged.int8_kv_launches = 0
    for f in plains:
        f.plain_launches = 0


def read_counts(torch):
    """(kernel launches by JSON name, by ``ssd_scan[<part>]`` each of
    kernel 8's three launches and by ``ssd_scan_bwd_state[<part>]`` each of
    8b's two; plain versions run by op name)."""
    from repro_torch.kernels.ssd_scan.ssd_scan import ssd_scan, ssd_scan_bwd_state
    kernels, plains, paged = wrappers(torch)
    launches = {f.__name__: f.launches for f in kernels}
    launches["paged_attention_kernel"] = paged.launches - paged.int8_kv_launches
    launches["paged_attention_kernel[int8_kv]"] = paged.int8_kv_launches
    for part in SSD_FWD_PARTS:
        launches[f"ssd_scan[{part}]"] = getattr(ssd_scan, f"{part}_launches")
    for part in SSD_BWD_STATE_PARTS:
        launches[f"ssd_scan_bwd_state[{part}]"] = getattr(ssd_scan_bwd_state, f"{part}_launches")
    return launches, {f.__name__: f.plain_launches for f in plains}


def read_tc_counts(torch):
    """Tensor-core launches of the kernels with two routes (2, 7, 7b, 7c),
    by JSON name; the rest of their ``launches`` took the CUDA-core route."""
    return {f.__name__: f.tc_launches for f in wrappers(torch)[0] if hasattr(f, "tc_launches")}


def read_matmul_routes(torch):
    """Launches of kernels 1, 6 and 5 by route: {"<name>[stream]": n,
    "<name>[tc]": n}; the rest of their ``launches`` took the tile loop."""
    from repro_torch.kernels.ent_matmul.ent_matmul import ent_matmul, ent_matmul_packed_fused
    from repro_torch.kernels.int8_matmul.int8_matmul import int8_matmul
    return {f"{f.__name__}[{r}]": getattr(f, f"{r}_launches")
            for f in (ent_matmul_packed_fused, int8_matmul, ent_matmul) for r in ("stream", "tc")}


TRAIN_KERNELS = ("flash_attention", "flash_attention_bwd_dkdv", "flash_attention_bwd_dq")
# the serving configurations chip_smoke runs at full width: name ->
# (launch.build keyword arguments, kernels that must launch, kernels that
# must not)
SERVE_CONFIGS = {
    "EN-T w8a8, bf16 KV": (
        dict(quantize=True),
        ("ent_matmul_packed_fused", "flash_attention_masked", "paged_attention_kernel"),
        ("int8_matmul", "paged_attention_kernel[int8_kv]", *TRAIN_KERNELS, *SSD_KERNELS)),
    "w8a8 int8, int8 KV": (
        dict(quant="int8", kv_quant=True),
        ("int8_matmul", "flash_attention_masked", "paged_attention_kernel[int8_kv]"),
        ("ent_matmul_packed_fused", "paged_attention_kernel", *TRAIN_KERNELS,
         *SSD_KERNELS)),
}


def build_kw(kw):
    from repro_torch.configs.base import QuantConfig
    if kw.get("quant") == "int8":   # the plain int8 records of launch/specs.py:111-113
        kw = dict(kw, quant=QuantConfig(enabled=True, ent_encode=False))
    return kw


def serve_full_width(torch, config):
    """Serve 16 ragged greedy requests on full-width qwen2.5-3b in one of
    SERVE_CONFIGS; every kernel of its path must launch (counts set to 0
    just before the run and read just after), no other serving kernel
    and no plain version may; then profile decode ticks and one admission
    prefill.  Returns (launches, tokens/s, launches by route, the prefill's
    profile, the decode tick's matmul ms by route)."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as launch
    from repro_torch.runtime.serve_loop import ServeEngine

    kw, must, must_not = SERVE_CONFIGS[config]
    cfg = get_config("qwen2.5-3b")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, params = launch.build(cfg, seed=0, **build_kw(kw))
    torch.cuda.synchronize()
    print(f"qwen2.5-3b full width ({cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.num_heads}/{cfg.num_kv_heads} heads, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}), {config}: init + quantize {time.perf_counter() - t0:.2f}s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card", flush=True)
    engine = ServeEngine(model, params, slots=SLOTS, max_len=576, page_size=16,
                         prefix_cache=False, seed=0)
    rng = np.random.default_rng(0)
    prompts = launch.ragged_prompts(rng, 16, 256, 512, cfg.vocab_size)
    reset_counts(torch)
    results, dt = launch.serve(engine, prompts, max_new_tokens=32)
    launches, plain_runs = read_counts(torch)
    routes = {"flash_attention_masked[tensor-core]": read_tc_counts(torch)[
        "flash_attention_masked"], **read_matmul_routes(torch)}
    engine.check_leaks()
    if sorted(results) != list(range(16)) or any(len(v) != 32 for v in results.values()):
        raise AssertionError(f"serve: {len(results)} results, lengths "
                             f"{sorted(len(v) for v in results.values())}")
    if any(launches[n] < 1 for n in must):
        raise AssertionError(f"{config}: a kernel of the path never launched: {launches}")
    if any(launches[n] for n in must_not):
        raise AssertionError(f"{config}: kernels of another path launched: {launches}")
    if any(plain_runs.values()):
        raise AssertionError(f"{config}: plain versions ran on the path: {plain_runs}")
    toks = sum(len(v) for v in results.values())
    layers = engine.cache["layers"]
    pool = engine.pool_bytes
    bf16_pool = sum(2 * c.k.numel() * 2 for c in layers)   # the same pools in bf16
    ticks = max(launches[n] for n in ("paged_attention_kernel",
                                      "paged_attention_kernel[int8_kv]")) // cfg.num_layers
    check_serve_routes(cfg, config, launches, routes, ticks)
    print(f"serve [{config}]: 16 requests (prompts {min(map(len, prompts))}.."
          f"{max(map(len, prompts))} tokens) x 32 new tokens on 8 slots: {toks} tokens in "
          f"{dt:.3f}s = {toks / dt:.2f} tok/s; decode ticks {ticks}, prefills "
          f"{launches['flash_attention_masked'] // cfg.num_layers}; launches {launches}; "
          f"routes {routes}; "
          f"plain versions run {plain_runs}; KV pools {pool} bytes ({pool / 2**20:.1f} MiB, "
          f"{pool / bf16_pool:.4f} of the {bf16_pool} bytes of bf16 pools); peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    tick_routes = profile_decode_ticks(torch, engine, prompts[:SLOTS], cfg, config)
    prefill = profile_prefill(torch, engine, max(prompts, key=len), cfg, config)
    del engine, params, model
    torch.cuda.empty_cache()
    return launches, toks / dt, routes, prefill, tick_routes


PROJECTIONS = 7   # quantized projections a layer: q, k, v, o, gate, up, down
SLOTS = 8         # the serving engine's slots: a full decode tick's M


def check_serve_routes(cfg, config, launches, routes, ticks):
    """Per decode tick and per prefill, each layer launches its path's
    matmul (kernel 1 or 6) once per projection, on the route its wrapper's
    cut gives the tick's 8 rows (the split-K stream) and on the tensor-core
    loop at prefill sizes of M, and kernel 2 once per prefill, all of it
    on the tensor-core route."""
    per = PROJECTIONS * cfg.num_layers
    paged = launches["paged_attention_kernel"] + launches["paged_attention_kernel[int8_kv]"]
    if paged != cfg.num_layers * ticks:
        raise AssertionError(f"{config}: the paged decode launched {paged} times; expected "
                             f"{cfg.num_layers} a tick ({ticks} ticks) and none a prefill")
    n2 = launches["flash_attention_masked"]
    prefills = n2 // cfg.num_layers
    if n2 != prefills * cfg.num_layers or routes["flash_attention_masked[tensor-core]"] != n2:
        raise AssertionError(f"{config}: kernel 2 launched {n2} times, "
                             f"{routes['flash_attention_masked[tensor-core]']} tensor-core; "
                             f"expected {cfg.num_layers} a prefill, all tensor-core")
    mm = "ent_matmul_packed_fused" if launches["ent_matmul_packed_fused"] else "int8_matmul"
    if launches[mm] != per * (ticks + prefills):
        raise AssertionError(f"{config}: {mm} launched {launches[mm]} times, expected {per} "
                             f"a tick and a prefill ({ticks} ticks, {prefills} prefills)")
    stream, tc = routes[f"{mm}[stream]"], routes[f"{mm}[tc]"]
    decode = matmul_route(mm, SLOTS)
    want = (per * ticks, per * prefills) if decode == "stream" else (0, per * (ticks + prefills))
    if (stream, tc) != want:
        raise AssertionError(f"{config}: {mm} launched {stream} times on the stream and {tc} on "
                             f"the tensor-core loop ({ticks} ticks, {prefills} prefills; "
                             f"expected {want})")
    print(f"  {config}: the paged decode {cfg.num_layers} launches a tick; "
          f"{mm} {per} launches a tick and a prefill, every decode tick's on the "
          + ("split-K stream" if decode == "stream" else "tensor-core loop")
          + f", every prefill's on the tensor-core loop; kernel 2 {cfg.num_layers} a prefill, "
          "all tensor-core", flush=True)


def device_ms_by_kernel(prof, per=1):
    """Device time in ms by kernel name from a torch.profiler run, over ``per``."""
    dev = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
        if us and getattr(ev, "device_type", None) is not None and \
                str(ev.device_type).endswith("CUDA"):
            dev[ev.key] = us / 1e3 / per
    return dev


def profile_prefill(torch, engine, prompt, cfg, config):
    """Where one admission prefill's time goes: admit one ``prompt`` into
    the idle engine (``_admit``: the prefill alone, no decode tick), once
    unprofiled (host clock, its launches: the path's matmul once per
    projection and layer, all on the tensor-core loop) and once under
    torch.profiler (device time by kernel)."""
    from torch.profiler import ProfilerActivity, profile
    runs = {}
    for profiled in (False, True):
        engine.submit(prompt, max_new_tokens=2)
        torch.cuda.synchronize()
        reset_counts(torch)
        ctx = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) if profiled \
            else contextlib.nullcontext()
        with ctx as prof:
            t0 = time.perf_counter()
            engine._admit()
            torch.cuda.synchronize()
            runs[profiled] = (time.perf_counter() - t0) * 1e3
        if not profiled:
            launches, _ = read_counts(torch)
            check_serve_routes(cfg, config, launches, {
                "flash_attention_masked[tensor-core]": launches["flash_attention_masked"],
                **read_matmul_routes(torch)}, 0)
        engine.run()
    dev = device_ms_by_kernel(prof)
    busy = sum(dev.values())
    print(f"admission prefill ({len(prompt)} tokens, full width): {runs[False]:.3f} ms "
          f"host-clock ({runs[True]:.3f} ms under the profiler); device busy {busy:.3f} ms "
          f"({100 * (1 - busy / runs[False]):.1f}% idle)" if busy else "device time not measured")
    for name, ms in sorted(dev.items(), key=lambda kv: -kv[1])[:10]:
        print(f"  {ms:9.3f} ms/prefill  {name[:90]}")
    engine.check_leaks()
    return dict(host_ms=runs[False], busy_ms=busy,
                by_kernel=dict(sorted(dev.items(), key=lambda kv: -kv[1])[:10]))


def profile_decode_ticks(torch, engine, prompts, cfg, config, ticks=3):
    """Where a full-batch decode tick's time goes: fill the 8 slots, then
    profile ``ticks`` pure decode ticks (host clock around synchronised
    ticks; device time per kernel from torch.profiler).  The unprofiled
    ticks must launch their path's matmul once per projection and layer,
    all on the split-K stream, and no prefill.  Then the matmul's two
    routes in the same process, the wrapper's and the other (its cut set
    to 0 or to the tick's M for the run), in the order A B B A, ``ticks``
    profiled ticks each: its device ms a tick on each route, the decode
    tick's measure of the cut.  Returns {route: [ms a tick, ms a tick]}."""
    from torch.profiler import ProfilerActivity, profile

    def profiled():
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(ticks):
                engine.step()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / ticks
        return wall, device_ms_by_kernel(prof, ticks)

    for p in prompts:
        engine.submit(p, max_new_tokens=6 * ticks + 4)
    engine.step()                      # admits all 8 (prefills) + 1 tick
    torch.cuda.synchronize()
    reset_counts(torch)
    t0 = time.perf_counter()
    for _ in range(ticks):
        engine.step()
    torch.cuda.synchronize()
    plain_wall = (time.perf_counter() - t0) * 1e3 / ticks
    launches, _ = read_counts(torch)
    check_serve_routes(cfg, config, launches, {
        "flash_attention_masked[tensor-core]": 0, **read_matmul_routes(torch)}, ticks)
    wall, dev = profiled()
    busy = sum(dev.values())
    idle = "not measured" if not busy else f"{100 * (1 - busy / plain_wall):.1f}% idle"
    print(f"decode tick (8 slots, full width): {plain_wall:.3f} ms host-clock "
          f"({wall:.3f} ms under the profiler); device busy {busy:.3f} ms/tick "
          f"({idle})")
    for name, ms in sorted(dev.items(), key=lambda kv: -kv[1])[:8]:
        print(f"  {ms:9.3f} ms/tick  {name[:90]}")
    mm = "ent_matmul_packed_fused" if "EN-T" in config else "int8_matmul"
    mod, attr = matmul_cuts()[mm]
    cut, own = matmul_cut(mm), matmul_route(mm, SLOTS)
    other = "tc" if own == "stream" else "stream"
    by_route = {own: [], other: []}
    try:
        for route in (own, other, other, own):
            setattr(mod, attr, SLOTS if route == "stream" else 0)
            _, dev = profiled()
            by_route[route].append(sum(v for k, v in dev.items()
                                       if "ent_stream::stream_kernel" in k
                                       or "ent_tc::tc_kernel" in k))
    finally:
        setattr(mod, attr, cut)
    print(f"  decode tick, {mm} by route (A B B A, {ticks} ticks each): "
          + "; ".join(f"{r} {' / '.join(f'{v:.3f}' for v in vs)} ms/tick"
                      for r, vs in by_route.items())
          + f"; the wrapper takes {own} at M = {SLOTS}", flush=True)
    engine.run()
    engine.check_leaks()
    return by_route


def e2e_faults(torch, kv_quant):
    """Planted faults for the end-to-end comparison: each replaces one
    kernel wrapper, as its ops module calls it, with the real wrapper fed
    one wrong mask argument (or, with an int8 KV cache, one wrong scale
    pool).  name -> (module, attribute, wrap)."""
    from repro_torch.kernels.flash_attention import ops as attn_ops
    from repro_torch.kernels.paged_attention import ops as paged_ops

    def skip_pos_page(f):
        def g(q, kp, vp, table, pos, st, *a, page_size, **kw):
            table = table.clone()
            table[torch.arange(len(pos), device=pos.device), (pos // page_size).long()] = 0
            return f(q, kp, vp, table, pos, st, *a, page_size=page_size, **kw)
        return g

    paged = (paged_ops, "paged_attention_kernel")
    scale_faults = {
        "decode ignores the V scale": (*paged, lambda f: lambda q, kp, vp, t, pos, st, ks, vs, **kw:
                                       f(q, kp, vp, t, pos, st, ks, torch.ones_like(vs), **kw)),
        "decode reads the neighbouring page's K scale": (
            *paged, lambda f: lambda q, kp, vp, t, pos, st, ks, vs, **kw:
            f(q, kp, vp, t, pos, st, ks.roll(1, 0), vs, **kw)),
    } if kv_quant else {}
    return {
        **scale_faults,
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


def with_legacy_planes(params):
    """Give every plane-less int8 record its legacy 4-plane ``planes``
    (``ent_ops.encode_weights``), as old checkpoints hold them, so that
    ``qdense_apply`` serves it through the 4-plane kernel."""
    from repro_torch.kernels.ent_matmul.ops import encode_weights
    if isinstance(params, dict):
        if "q" in params:
            return dict(params, planes=encode_weights(params["q"]))
        return {k: with_legacy_planes(v) for k, v in params.items()}
    if isinstance(params, list):
        return [with_legacy_planes(v) for v in params]
    return params


# weights of the end-to-end runs -> launch.build keyword arguments
E2E_WEIGHTS = {"float": {}, "EN-T": dict(quantize=True), "int8": dict(quant="int8"),
               "4-plane": dict(quant="int8")}


def kernels_vs_plain_end_to_end(torch, compute_dtype, weights, bound, kv_quant=False):
    """One prefill (2 x 256 tokens, one left-padded to 200) + 4 decode
    ticks of full-width qwen2.5-3b at 2 layers, with the kernels and with
    the plain versions (``use_kernels=False``), on the same
    teacher-forced tokens; fails when the logits' relative L2 difference
    exceeds ``bound``, or when a planted fault (``e2e_faults``) stays
    within it.  Per call the kernels agree with the plain versions (the
    matmuls bit for bit, float32 attention to ~1e-6); with quantized
    weights every projection re-quantizes its input to int8, so the first
    code that a last-bit difference flips re-draws the rounding of
    everything downstream, and the quantized runs differ by int8 rounding
    noise (~1e-2 relative) however small the kernel error.  An int8 KV
    cache re-quantizes every K/V row on its way in, with the same effect.
    Also prints the free-running difference (each path fed its own greedy
    tokens), which is not bounded: once one greedy token differs, the two
    paths decode different inputs.  Returns the kernel launches of the
    kernel run (counts set to 0 just before it)."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as launch
    from repro_torch.models.transformer import Model

    cfg = dataclasses.replace(get_config("qwen2.5-3b"), num_layers=2,
                              compute_dtype=compute_dtype)
    model, params = launch.build(cfg, seed=1, kv_quant=kv_quant,
                                 **build_kw(E2E_WEIGHTS[weights]))
    if weights == "4-plane":
        params = with_legacy_planes(params)
    plain_model = Model(cfg, use_kernels=False, kv_quant=kv_quant)
    label = f"{weights} weights{', int8 KV' if kv_quant else ''}"
    rng = np.random.default_rng(1)
    dev = model.device
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 256))).to(dev)
    mask = torch.ones((2, 256), dtype=torch.bool, device=dev)
    mask[1, :56] = False
    forced = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 2))).to(dev)

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

    reset_counts(torch)
    a = run(model)
    launches, plain_runs = read_counts(torch)
    launches.update(read_matmul_routes(torch))
    if any(plain_runs.values()):
        raise AssertionError(f"{label}: the kernel run ran plain versions {plain_runs}")
    b = run(plain_model)
    if a.shape != (5, 2, cfg.padded_vocab) or not torch.isfinite(a).all():
        raise AssertionError(f"logits shape {tuple(a.shape)} / finite "
                             f"{bool(torch.isfinite(a).all())}")
    diff, sound = float((a - b).abs().max()), rel(a, b)
    agree = float((a.argmax(-1) == b.argmax(-1)).float().mean())
    fa, fb = run(model, False), run(plain_model, False)
    print(f"2-layer full width, {compute_dtype}, {label}: prefill + 4 decode ticks, kernels "
          f"vs plain: logits max abs diff {diff:.3e} (max |logit| "
          f"{float(b.abs().max()):.3e}), relative L2 {sound:.3e} (limit {bound}), "
          f"greedy agreement {agree:.3f}; free-running: max abs diff "
          f"{float((fa - fb).abs().max()):.3e}, relative L2 {rel(fa, fb):.3e}; "
          f"kernel launches {launches}", flush=True)
    missed = []
    for name, (module, attr, wrap) in e2e_faults(torch, kv_quant).items():
        with planted(module, attr, wrap):
            reading = rel(run(model), b)
        caught = reading > bound
        print(f"  planted fault '{name}': relative L2 {reading:.3e} "
              f"({'over' if caught else 'within'} the limit)", flush=True)
        if not caught:
            missed.append(name)
    if sound > bound:
        raise AssertionError(f"kernel path disagrees with the plain path "
                             f"({compute_dtype}, {label}: relative L2 {sound} > {bound})")
    if missed:
        raise AssertionError(f"the limit {bound} misses planted faults {missed}")
    return launches


def loss_and_grads(model, params, batch, remat="none"):
    """The train step's loss and float32 master-weight gradients, without
    the optimizer update."""
    from repro_torch.optim.grad import accumulate
    from repro_torch.runtime.train_loop import make_loss
    from repro_torch.tree import leaves
    loss, grads = accumulate(make_loss(model, remat), params, [batch])
    return loss, leaves(grads)


def train_faults():
    """Planted faults for the training comparison: each replaces one
    attention wrapper, as ``FlashAttention`` calls it, with the real
    wrapper fed one wrong argument.  name -> (module, attribute, wrap)."""
    from repro_torch.kernels.flash_attention import ops as attn_ops
    return {
        "forward sees one key ahead (q_offset + 1)": (
            attn_ops, "flash_attention",
            lambda f: lambda q, k, v, **kw: f(q, k, v, q_offset=1, **kw)),
        "backward causal mask off by one": (
            attn_ops, "flash_attention_bwd",
            lambda f: lambda *a, **kw: f(*a, q_offset=1, **kw)),
        "backward reads the neighbouring row's lse": (
            attn_ops, "flash_attention_bwd",
            lambda f: lambda q, k, v, o, lse, do, **kw: f(
                q, k, v, o, lse.roll(1, -1).contiguous(), do, **kw)),
    }


def train_kernels_vs_plain(torch, compute_dtype, bound, arch="minicpm-2b",
                           faults=None, names=TRAIN_KERNELS):
    """Loss and every gradient leaf of full-width ``arch`` at 2 layers
    (seq 1024, one row of ``SyntheticSource(seed=1234)``) with the kernels
    and with the plain versions (``use_kernels=False``); the reading is
    the larger of the loss's relative difference and the largest per-leaf
    relative L2 difference of the gradients, and must stay within
    ``bound``; each planted fault (``faults()``, default ``train_faults``)
    must exceed it.  ``names``: the kernels of the path.  Returns the
    kernel launches of the kernel run."""
    from repro_torch.configs import get_config, get_optim
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.pipeline import SyntheticSource, TokenStream
    from repro_torch.launch import train as launch
    from repro_torch.models.transformer import Model

    cfg = dataclasses.replace(get_config(arch), num_layers=2, compute_dtype=compute_dtype)
    model, params, _, _ = launch.build(cfg, TrainConfig(seq_len=1024, global_batch=1),
                                       get_optim(arch), seed=2)
    plain_model = Model(cfg, use_kernels=False)
    stream = TokenStream(SyntheticSource(cfg.vocab_size, seed=1234), global_batch=1,
                         seq_len=1024)
    batch = launch.to_device(stream.next(), model.device)

    def reading(grads_a, loss_a, grads_b, loss_b):
        rel = max(float((a - b).norm() / b.norm()) for a, b in zip(grads_a, grads_b))
        return max(abs(float(loss_a) - float(loss_b)) / abs(float(loss_b)), rel)

    reset_counts(torch)
    loss_k, grads_k = loss_and_grads(model, params, batch)
    launches, plain_runs = read_counts(torch)
    if any(plain_runs.values()):
        raise AssertionError(f"training kernel run ran plain versions {plain_runs}")
    loss_p, grads_p = loss_and_grads(plain_model, params, batch)
    if not (torch.isfinite(loss_k) and all(torch.isfinite(g).all() for g in grads_k)):
        raise AssertionError("training kernel run: non-finite loss or gradient")
    sound = reading(grads_k, loss_k, grads_p, loss_p)
    worst = max(range(len(grads_p)), key=lambda i: float(
        (grads_k[i] - grads_p[i]).norm() / grads_p[i].norm()))
    if any(launches[n] < 1 for n in names):
        raise AssertionError(f"{arch}: a kernel of the path never launched: {launches}")
    print(f"{arch} full width, 2 layers, {compute_dtype}, seq 1024: loss kernels "
          f"{float(loss_k):.6f} plain {float(loss_p):.6f}; reading (max of loss and "
          f"per-leaf gradient relative L2) {sound:.3e} (limit {bound}; worst leaf "
          f"#{worst} of {len(grads_p)}); kernel launches "
          f"{ {n: launches[n] for n in names} }", flush=True)
    missed = []
    for name, (module, attr, wrap) in (faults or train_faults)().items():
        with planted(module, attr, wrap):
            loss_f, grads_f = loss_and_grads(model, params, batch)
        r = reading(grads_f, loss_f, grads_p, loss_p)
        del grads_f
        caught = r > bound
        print(f"  planted fault '{name}': {r:.3e} ({'over' if caught else 'within'} "
              f"the limit)", flush=True)
        if not caught:
            missed.append(name)
    # recomputation replays the same deterministic kernels: remat full and
    # dots must give the no-remat kernel run's loss and gradients
    for remat in ("full", "dots"):
        loss_r, grads_r = loss_and_grads(model, params, batch, remat)
        r = reading(grads_r, loss_r, grads_k, loss_k)
        del grads_r
        print(f"  remat {remat} vs none (kernels): {r:.3e} (limit {bound})", flush=True)
        if r > bound:
            raise AssertionError(f"remat {remat} changes the gradients ({r} > {bound})")
    if sound > bound:
        raise AssertionError(f"training kernel path disagrees with the plain path "
                             f"({compute_dtype}: {sound} > {bound})")
    if missed:
        raise AssertionError(f"the limit {bound} misses planted faults {missed}")
    del model, params, plain_model, grads_p, grads_k
    torch.cuda.empty_cache()
    return launches


def profile_train_step(torch, step_fn, params, opt, batch, step_wall):
    """One train step under torch.profiler: device busy vs the unprofiled
    step time ``step_wall`` (host clock, seconds) and the top device ops."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, opt, m = step_fn(params, opt, batch)
        loss = float(m["loss"])
        wall = time.perf_counter() - t0
    dev = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
        if us and getattr(ev, "device_type", None) is not None and \
                str(ev.device_type).endswith("CUDA"):
            dev[ev.key] = us / 1e6
    busy = sum(dev.values())
    idle = "not measured" if not busy else f"{100 * (1 - busy / step_wall):.1f}% idle"
    print(f"profiled train step: loss {loss:.4f}; {wall:.3f} s host-clock under the "
          f"profiler ({step_wall:.3f} s unprofiled); device busy {busy:.3f} s ({idle} "
          f"of the unprofiled step)", flush=True)
    top = sorted(dev.items(), key=lambda kv: -kv[1])[:16]
    for name, sec in top:
        print(f"  {sec * 1e3:10.2f} ms/step ({100 * sec / max(busy, 1e-12):5.1f}%)  "
              f"{name[:90]}", flush=True)
    # the port's own kernels by name, in and beyond the top
    ours = {}
    for name, sec in dev.items():
        short = name.replace("void ", "").replace("(anonymous namespace)::", "").split("(")[0]
        if short.startswith(("ssd_", "flash_")):
            ours[short] = ours.get(short, 0.0) + sec * 1e3
    print("  the port's kernels, ms/step: "
          + ", ".join(f"{n} {ms:.2f}" for n, ms in sorted(ours.items())), flush=True)
    return dict(busy_s=busy, wall_s=wall, step_s=step_wall,
                top=[(n[:90], sec) for n, sec in top], kernels_ms=ours)


# kernels with a tensor-core route (bf16 operands) beside the CUDA-core one
TC_KERNELS = ("flash_attention", "flash_attention_bwd_dkdv", "flash_attention_bwd_dq")
# the full-width training runs: arch -> (TrainConfig keyword arguments,
# launches of each kernel of the path per layer and microbatch: the
# forward kernel twice under remat full, forward and recomputation;
# kernels whose every launch must take the tensor-core route)
TRAIN_RUNS = {
    "minicpm-2b": (dict(seq_len=4096, global_batch=2, microbatch=1, remat="full"),
                   dict(zip(TRAIN_KERNELS, (2, 1, 1))), TC_KERNELS),
    "mamba2-370m": (dict(seq_len=4096, global_batch=8, microbatch=4, remat="full"),
                    {**dict(zip(SSD_KERNELS, (2, 1, 1))),
                     **{f"ssd_scan[{part}]": 2 for part in SSD_FWD_PARTS},
                     **{f"ssd_scan_bwd_state[{part}]": 1 for part in SSD_BWD_STATE_PARTS}}, ()),
}


def train_full_width(torch, arch):
    """Three training steps of full-width ``arch`` (all its layers, random
    float32 master weights from seed 0) in its TRAIN_RUNS configuration
    on ``SyntheticSource(seed=1234)``, through ``repro_torch.launch.train``'s
    ``build`` and ``train``.  Counts are set to 0 just before the run and
    read (and set to 0) after each step; every step must launch each
    kernel of the path its TRAIN_RUNS count per layer and microbatch, all
    of them on the tensor-core route for the kernels TRAIN_RUNS names, and
    nothing else of the port's kernels or plain versions, nor the plain D_i
    pass ``bwd_delta`` (kernel 7c writes D_i for 7b); every loss and
    grad-norm must be finite, and the first loss within 2 of ln(vocab)
    (random weights: the head's unit-variance logits add ~0.5).  Then one
    more step under the profiler.  Returns the run's record."""
    from repro_torch.configs import get_config, get_optim
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.pipeline import SyntheticSource, TokenStream
    from repro_torch.kernels.flash_attention import flash_attention as fa_mod
    from repro_torch.launch import train as launch

    tkw, per_layer, tc_names = TRAIN_RUNS[arch]
    names = tuple(per_layer)
    cfg = get_config(arch)
    tcfg = TrainConfig(**tkw)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, params, opt, step_fn = launch.build(cfg, tcfg, get_optim(arch), seed=0)
    torch.cuda.synchronize()
    widths = (f"SSD heads {cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim} x P "
              f"{cfg.ssm.head_dim}, N {cfg.ssm.state_dim}, groups {cfg.ssm.ngroups}"
              if cfg.ssm else f"{cfg.num_heads}/{cfg.num_kv_heads} heads, head_dim "
              f"{cfg.head_dim}, d_ff {cfg.d_ff}")
    print(f"{arch} full width ({cfg.num_layers} layers, d_model {cfg.d_model}, {widths}, "
          f"vocab {cfg.vocab_size}, {cfg.param_count() / 1e9:.3f}B params): "
          f"init {time.perf_counter() - t0:.2f}s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card; seq "
          f"{tcfg.seq_len}, batch {tcfg.global_batch}, microbatch {tcfg.microbatch}, remat "
          f"{tcfg.remat}", flush=True)
    stream = TokenStream(SyntheticSource(cfg.vocab_size, seed=1234),
                         global_batch=tcfg.global_batch, seq_len=tcfg.seq_len)
    n_micro = tcfg.global_batch // tcfg.microbatch
    expected = {n: k * cfg.num_layers * n_micro for n, k in per_layer.items()}
    steps = []
    delta_passes = [0]   # bwd_delta calls since the last step

    def counted(f):
        def bwd_delta(*a, **kw):
            delta_passes[0] += 1
            return f(*a, **kw)
        return bwd_delta

    def on_step(rec):
        launches, plain_runs = read_counts(torch)
        tc = read_tc_counts(torch)
        reset_counts(torch)
        rec.update(launches=launches, plain_runs=plain_runs, tc_launches=tc,
                   delta_passes=delta_passes[0],
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        delta_passes[0] = 0
        steps.append(rec)
        print(f"  step {rec['step']}: loss {rec['loss']:.4f} grad-norm "
              f"{rec['grad_norm']:.4f} lr {rec['lr']:.3e} time {rec['seconds']:.3f}s "
              f"tokens/s {rec['tokens_per_s']:.1f} peak {rec['peak_gib']:.2f} GiB; "
              f"launches {({n: launches[n] for n in names})}; tensor-core route "
              f"{({n: tc[n] for n in tc_names})}; bwd_delta passes "
              f"{rec['delta_passes']}", flush=True)

    reset_counts(torch)
    with planted(fa_mod, "bwd_delta", counted):
        params, opt, _ = launch.train(step_fn, params, opt, stream, 3, device=model.device,
                                      log_every=1, on_step=on_step)
    for rec in steps:
        got = {n: rec["launches"][n] for n in names}
        if got != expected:
            raise AssertionError(f"step {rec['step']}: launches {got}, expected {expected}")
        routed = {n: rec["tc_launches"][n] for n in tc_names}
        if routed != {n: expected[n] for n in tc_names}:
            raise AssertionError(f"step {rec['step']}: tensor-core launches {routed}, "
                                 f"expected all of {expected} (none on the CUDA-core route)")
        others = {n: c for n, c in rec["launches"].items() if n not in names and c}
        if others or any(rec["plain_runs"].values()):
            raise AssertionError(f"step {rec['step']}: other kernels {others} or plain "
                                 f"versions {rec['plain_runs']} ran")
        if rec["delta_passes"]:
            raise AssertionError(f"step {rec['step']}: {rec['delta_passes']} plain D_i "
                                 f"passes (bwd_delta) ran on the training path")
        if not (math.isfinite(rec["loss"]) and math.isfinite(rec["grad_norm"])):
            raise AssertionError(f"step {rec['step']}: non-finite loss or grad-norm")
    print(f"first step's loss {steps[0]['loss']:.4f} beside ln(vocab) = "
          f"{math.log(cfg.vocab_size):.4f} (limit: within 2)", flush=True)
    if abs(steps[0]["loss"] - math.log(cfg.vocab_size)) > 2:
        raise AssertionError(f"{arch}: first loss {steps[0]['loss']} is not near ln(vocab)")
    step_wall = statistics.mean(r["seconds"] for r in steps[1:])
    with planted(fa_mod, "bwd_delta", counted):
        prof = profile_train_step(torch, step_fn, params, opt,
                                  launch.to_device(stream.next(), model.device), step_wall)
    if delta_passes[0]:
        raise AssertionError(f"profiled step: {delta_passes[0]} plain D_i passes ran")
    peak = torch.cuda.max_memory_allocated() / 2**30
    del model, params, opt, step_fn
    torch.cuda.empty_cache()
    return dict(steps=steps, expected=expected, profile=prof, peak_gib=peak,
                launches={n: sum(r["launches"][n] for r in steps) for n in names},
                tc_launches={n: sum(r["tc_launches"][n] for r in steps) for n in tc_names},
                tokens=tcfg.global_batch * tcfg.seq_len)


# the tensor-core kernels by wrapper name, and their kind index of
# flash_attention_tc_smem
TC_SOURCES = {"flash_attention_masked": ("flash_fwd_masked_tc", 3),
              "flash_attention": ("flash_fwd_tc", 0),
              "flash_attention_bwd_dkdv": ("flash_bwd_dkdv_tc", 1),
              "flash_attention_bwd_dq": ("flash_bwd_dq_tc", 2)}


def _build_label(fn):
    """Report label of a kernel's mangled name, or None."""
    import re
    fn = fn or ""
    if (m := re.search(r"(flash_fwd_masked_tc|flash_fwd_tc|flash_bwd_dkdv_tc|flash_bwd_dq_tc)"
                       r"ILi(\d+)E", fn)):
        return f"{m.group(1)}<{m.group(2)}>"
    if (m := re.search(r"ssd_states_kernelILb([01])E", fn)):
        return f"ssd_states_kernel<{('false', 'true')[int(m.group(1))]}>"
    if (m := re.search(r"(ssd_carry_kernel|ssd_fwd_out_kernel|ssd_bwd_chunk_kernel)", fn)):
        return m.group(1)
    types = {"13__nv_bfloat16": "bf16", "S1_": "bf16", "f": "float", "a": "int8", "i": "int"}
    if (m := re.search(r"stream_kernelI(13__nv_bfloat16|a)Li(\d)ELi(\d)ELi(\d+)EfE", fn)):
        return f"stream_kernel<{types[m.group(1)]},{m.group(2)},{m.group(3)},{m.group(4)},float>"
    if (m := re.search(r"(paged_decode_tc|paged_decode_f32)I(13__nv_bfloat16|f|a)Lb[01]ELi(\d+)E",
                       fn)):
        return f"{m.group(1)}<{types[m.group(2)]},{m.group(3)}>"
    if (m := re.search(r"tc_kernelI(13__nv_bfloat16|f|a)Li(\d)ELi(\d)E(13__nv_bfloat16|S1_|f|i)E",
                       fn)):
        x = {"float": "f32"}.get(types[m.group(1)], types[m.group(1)])
        return f"tc_kernel<{x},{m.group(2)},{m.group(3)},{types[m.group(4)]}>"
    return None


def _scan_build(report, source, ops):
    """Fill ``report`` from ``source``'s ptxas log (registers, spills) and,
    where the toolkit has ``cuobjdump``, its SASS (counts of ``ops``)."""
    import re
    import shutil
    from repro_torch.kernels import _build
    fn = None
    for line in _build.build_logs.get(source, "").splitlines():
        m = re.search(r"(?:entry function '|Function properties for |the function ')([^' ]+)", line)
        if m:
            fn = m.group(1)
        rec = report.get(_build_label(fn))
        if rec is None:
            continue
        if (m := re.search(r"Used (\d+) registers", line)):
            rec["registers"] = int(m.group(1))
        if (m := re.search(r"(\d+) bytes smem", line)):
            rec["static_smem_bytes"] = int(m.group(1))
        if (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            rec["spill_bytes"] = [int(m.group(1)), int(m.group(2))]
        if "Performance Loss" in line:
            rec["ptxas_warning"] = line.split("Potential Performance Loss:")[-1].split(" for ")[0].strip()
    cuobj = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if os.path.exists(cuobj):
        sass = subprocess.run([cuobj, "-sass", str(_build.library_path(source))],
                              capture_output=True, text=True, timeout=300).stdout
        fn = None
        for line in sass.splitlines():
            if (m := re.search(r"Function : (\S+)", line)):
                fn = m.group(1)
            rec = report.get(_build_label(fn))
            if rec is not None:
                for op in ops:
                    rec[op] = rec.get(op, 0) + (op in line)


def tc_build_report():
    """Registers and spills of the tensor-core kernels (2, 7, 7b, 7c; the
    int8 loop of kernels 1, 6 and 5; kernel 8's three launches, 8b's two
    and 8c), of the split-K stream of kernels 1, 6 and 5 and of the paged
    decode (3 and
    3b, both routes) from this run's build (``nvcc -Xptxas -v``), their
    HGMMA / IGMMA (int8 wgmma) / HMMA (mma.sync; the stream: IDP4A)
    instruction counts where the toolkit has ``cuobjdump``, and their
    dynamic shared memory as the built libraries size it.  Returns
    {kernel: record}."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.ent_matmul import ent_matmul as em
    kinds = dict(TC_SOURCES.values())
    report = {f"{k}<{d}>": {} for k in kinds for d in (64, 128)}
    smem = _build.entry("flash_attention", "flash_attention_tc_smem")
    for lab, rec in report.items():
        name, d = lab[:-1].split("<")
        rec["smem_bytes"] = smem(kinds[name], int(d))
    _scan_build(report, "flash_attention", ("HGMMA", "HMMA"))
    # kernels 1, 6 and 5: the stream as served (bf16 / int8 X, f32 out),
    # one instantiation per rows a block, its shared memory at the largest
    # of the four projection shapes' plans; and every instantiation of the
    # int8 tensor-core loop
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for source, smem_of, x0, np_, shift, xs in (
            ("ent_matmul", "ent_matmul", "bf16", 2, 4, ("bf16", "f32")),
            ("int8_matmul", "int8_matmul", "int8", 1, 0, ("int8",)),
            ("ent_matmul", "ent_matmul_planes", "int8", 4, 2, ("int8",))):
        recs = {f"stream_kernel<{x0},{np_},{shift},{mb},float>": {} for mb in em.STREAM_MB}
        stream_smem = _build.entry(source, f"{smem_of}_stream_smem")
        for mb, rec in zip(em.STREAM_MB, recs.values()):
            rec["smem_bytes"] = max(stream_smem(mb, em.stream_plan(mb, n, k, sms)[1])
                                    for k, n in STREAM_SHAPES[:4])
        tc_smem = _build.entry(source, f"{smem_of}_tc_smem")
        for x in xs:
            for o in ("float", "bf16", "int"):
                recs[f"tc_kernel<{x},{np_},{shift},{o}>"] = {
                    "smem_bytes": tc_smem(int(x == "bf16")) if np_ == 2 else tc_smem()}
        _scan_build(recs, source, ("HGMMA", "IGMMA", "HMMA", "IDP"))
        report.update(recs)
    # kernel 8's three launches, 8b's two and kernel 8c (split-bf16 wgmma;
    # the carry kernel, shared by 8 and 8b, has no product and no dynamic
    # shared memory)
    ssd_smem = _build.entry("ssd_scan", "ssd_scan_smem")
    recs = {"ssd_states_kernel<false>": {"smem_bytes": ssd_smem(0)},
            "ssd_states_kernel<true>": {"smem_bytes": ssd_smem(0)},
            "ssd_carry_kernel": {"smem_bytes": 0},
            "ssd_fwd_out_kernel": {"smem_bytes": ssd_smem(1)},
            "ssd_bwd_chunk_kernel": {"smem_bytes": ssd_smem(2)}}
    _scan_build(recs, "ssd_scan", ("HGMMA", "HMMA"))
    report.update(recs)
    # kernels 3 and 3b: the tensor-core kernel (bf16 q) and the CUDA-core one
    # (float32 q), each pool type, D 128 and 64; dynamic shared memory at the
    # plans of PAGED_CASES' tick (D 128) and G12 (D 64) calls
    from repro_torch.kernels.paged_attention.paged_attention import split_plan
    paged_smem = _build.entry("paged_attention", "paged_attention_smem")
    recs = {}
    for case in PAGED_CASES.values():
        b, hq, hkv, d, page, pps = case[:6]
        pp, splits = split_plan(b, hkv, pps, sms)
        for kern, is_bf16 in (("paged_decode_tc", 1), ("paged_decode_f32", 0)):
            for kv, int8 in (("int8", 1), ("bf16" if is_bf16 else "float", 0)):
                recs[f"{kern}<{kv},{d}>"] = {"smem_bytes": paged_smem(
                    is_bf16, int8, d, pp, page, hq // hkv, splits)}
    _scan_build(recs, "paged_attention", ("HMMA",))
    report.update(recs)
    for lab, rec in report.items():
        print(f"  {lab}: {rec.get('registers', 'not reported (library cached)')} registers, "
              f"spill stores / loads {rec.get('spill_bytes', 'not reported')} bytes, "
              f"{rec['smem_bytes']} bytes of dynamic shared memory"
              + (f" ({rec['static_smem_bytes']} static)" if rec.get("static_smem_bytes") else "")
              + ", HGMMA "
              f"{rec.get('HGMMA', 'not counted (no cuobjdump)')}, HMMA "
              f"{rec.get('HMMA', 'not counted')}"
              + (f", IGMMA (s8 wgmma) {rec['IGMMA']}" if "IGMMA" in rec else "")
              + (f", IDP4A {rec['IDP']}" if "IDP" in rec else "")
              + (f"; ptxas: {rec['ptxas_warning']}" if "ptxas_warning" in rec else ""),
              flush=True)
    return report


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    # float32 products and convolutions in full float32 on the card (the
    # matmul default; the port runs no convolution)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

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
            if any(k in line for k in ("registers", "spill", "entry function")):
                print(f"  {name}: {line.strip()}")
    print(f"built {built or 'nothing (cached)'}")
    tc_build = tc_build_report()
    done(t, "build")

    t = phase("kernel checks")
    timer = Timer(torch)
    mm = check_matmuls(torch, timer)
    n_stream = check_stream(torch)
    n_tc = check_tc(torch)
    cut = check_cut(torch, timer)
    k2 = check_flash(torch, timer)
    k3 = check_paged(torch, timer)
    k3i = check_paged(torch, timer, int8_kv=True)
    del timer
    done(t, "kernel checks")

    serves = {}
    for config in SERVE_CONFIGS:
        t = phase(f"serve qwen2.5-3b full width, {config}")
        serves[config] = serve_full_width(torch, config)
        done(t, f"serve qwen2.5-3b full width, {config}")

    t = phase("kernels vs plain, 2 layers")
    # Limits between the sound readings and the planted faults' on the
    # H100 (PERF.md): EN-T runs read 4.3e-2 (bf16) and 1.5e-2 (float32)
    # sound and >= 0.11 under every fault; the float-weight run reads
    # 1.1e-6 sound and >= 0.10 under every fault; the int8 + int8-KV run
    # reads 4.5e-2 sound and >= 0.115 under every fault (0.49 and 0.97
    # under the two scale faults); the 4-plane run gives the EN-T bf16
    # run's logits (the same int32 accumulators), 4.3e-2.
    kernels_vs_plain_end_to_end(torch, "bfloat16", "EN-T", 0.07)   # as served
    kernels_vs_plain_end_to_end(torch, "float32", "EN-T", 0.07)
    kernels_vs_plain_end_to_end(torch, "float32", "float", 1e-4)   # no int8 cascade
    kernels_vs_plain_end_to_end(torch, "bfloat16", "int8", 0.07, kv_quant=True)  # as served
    legacy = kernels_vs_plain_end_to_end(torch, "bfloat16", "4-plane", 0.07)
    # kernel 5 once per projection and layer in the prefill (2 x 256 rows)
    # and in each of the 4 decode ticks (2 rows), on the routes its cut gives
    per = PROJECTIONS * 2
    want = {"ent_matmul": 5 * per, "ent_matmul[stream]": 0, "ent_matmul[tc]": 0}
    for m, calls in ((512, per), (2, 4 * per)):
        want[f"ent_matmul[{matmul_route('ent_matmul', m)}]"] += calls
    got = {k: legacy[k] for k in want}
    if got != want:
        raise AssertionError(f"legacy 4-plane records: ent_matmul launches {got}, expected "
                             f"{want}")
    print(f"  legacy 4-plane records: ent_matmul launches {got}", flush=True)
    done(t, "kernels vs plain, 2 layers")

    t = phase("training kernel checks")
    timer = Timer(torch)
    k7 = check_flash_train(torch, timer)
    del timer
    torch.cuda.empty_cache()
    done(t, "training kernel checks")

    t = phase("training kernels vs plain, minicpm-2b 2 layers")
    train_kernels_vs_plain(torch, "bfloat16", TRAIN_BOUND_BF16)
    train_kernels_vs_plain(torch, "float32", TRAIN_BOUND_F32)
    done(t, "training kernels vs plain, minicpm-2b 2 layers")

    t = phase("train minicpm-2b full width")
    tr = train_full_width(torch, "minicpm-2b")
    done(t, "train minicpm-2b full width")

    t = phase("SSD kernel checks")
    timer = Timer(torch)
    k8 = check_ssd(torch, timer)
    del timer
    torch.cuda.empty_cache()
    done(t, "SSD kernel checks")

    t = phase("SSM training kernels vs plain, mamba2-370m 2 layers")
    for dt_name, bound in (("bfloat16", SSM_BOUND_BF16), ("float32", SSM_BOUND_F32)):
        train_kernels_vs_plain(torch, dt_name, bound, arch="mamba2-370m",
                               faults=ssd_train_faults, names=SSD_KERNELS)
    done(t, "SSM training kernels vs plain, mamba2-370m 2 layers")

    t = phase("train mamba2-370m full width")
    tm = train_full_width(torch, "mamba2-370m")
    done(t, "train mamba2-370m full width")

    ent_t, int8 = (serves[c][0] for c in SERVE_CONFIGS)
    at_decode = lambda rows: next(r for r in rows if r["M"] == 8 and r["N"] == 11008)  # noqa: E731

    def entry(name, source, replaces, rows, pick, launches, **extra):
        row = pick(rows)
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": max(r["max_abs_err"] for r in rows),
                "ms": row["ms"], "plain_ms": row["plain_ms"],
                "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                "library_ms": row["library_ms"], **extra, "checks": rows}

    ent = "src/repro/kernels/ent_matmul/ent_matmul.py"
    paged = "src/repro/kernels/paged_attention/paged_attention.py"

    def paged_extra(rows, int8_kv):
        """Kernels 3 and 3b: the design, each checked case's numbers
        (the long-context one beside the tick's), launches in the other
        serve configuration (0), the build."""
        return dict(
            design=("split-KV flash-decode in one launch: one block per (run of pages, kv "
                    "head, slot) from split_plan, 16-byte cp.async of the run's K/V rows "
                    "into a 3-stage ring of 32 rows; bf16 q on the tensor cores, each warp "
                    "8 columns of a stage (S by mma.sync m16n8k16, P V by m16n8k8 over all "
                    "of D, G q rows padded to 16), the warps merged in shared memory; "
                    "float32 q on CUDA cores; the last block of each (slot, kv head) "
                    "combines the runs' partials in split order (ticket, no second launch)"),
            at_long_context=next(r for r in rows if r["case"] == "long"),
            launches_by_path={c: serves[c][0]["paged_attention_kernel[int8_kv]" if int8_kv
                                              else "paged_attention_kernel"]
                              for c in SERVE_CONFIGS},
            build={lab: rec for lab, rec in tc_build.items()
                   if lab.startswith("paged_decode") and ("<int8," in lab) == int8_kv})
    config_of = dict(zip(MATMULS[:2], SERVE_CONFIGS))   # kernel 1: EN-T, kernel 6: int8
    signature = {"ent_matmul_packed_fused": ",2,4,", "int8_matmul": "<int8,1,0,",
                 "ent_matmul": "<int8,4,2,"}   # each matmul's instantiations

    def routed(name, launches, routes, **extra):
        """Kernels 1, 6 and 5: launches by route on their path, the cut
        table, the build, and ``extra``."""
        return dict(
            design=(f"M <= {matmul_cut(name)} (decode): the split-K weight "
                    "stream of csrc/int8_stream.cuh (64-column strips x K slices, 16-byte "
                    "cp.async ring, __byte_perm transpose to dp4a words, atomics + ticket, "
                    "one launch); larger M (prefill): the int8 tensor-core loop of "
                    "csrc/int8_tc.cuh (" + ("64 x 128 tiles, each warpgroup two of the four "
                                            "planes" if name == "ent_matmul" else
                                            "128 x 128 tiles, two warpgroups of 64 rows")
                    + ", wgmma m64n128k32 s8.s8 -> s32 from shared memory, plane tiles "
                    "transposed to K-major through registers, one accumulator set a plane, "
                    + ("X quantized into the A tile, " if name == "ent_matmul_packed_fused"
                       else "")
                    + "split-K by tc_plan)"),
            route_launches={"stream": routes[f"{name}[stream]"], "tc": routes[f"{name}[tc]"],
                            "tile": launches[name] - routes[f"{name}[stream]"]
                            - routes[f"{name}[tc]"]},
            at_prefill=next(r for r in mm[name] if r["M"] == 512 and r["N"] == 11008),
            stream_vs_tc=[r for r in cut if r["kernel"] == name],
            calls_checked={"stream": n_stream, "tc": n_tc},
            build={lab: rec for lab, rec in tc_build.items()
                   if lab.startswith(("stream", "tc_kernel")) and signature[name] in lab},
            **extra)

    def served(name):
        """Kernels 1 and 6: ``routed`` from their serve run, with the decode
        tick's route comparison and the prefill profile."""
        launches, _, routes, prefill, tick_routes = serves[config_of[name]]
        return routed(name, launches, routes, decode_tick_ms_by_route=tick_routes,
                      prefill_profile=prefill)

    kernels = [
        entry("ent_matmul_packed_fused", "src/repro_torch/csrc/ent_matmul.cu", f"{ent}:227",
              mm["ent_matmul_packed_fused"], at_decode, ent_t["ent_matmul_packed_fused"],
              **served("ent_matmul_packed_fused")),
        entry("flash_attention_masked", "src/repro_torch/csrc/flash_attention.cu",
              "src/repro/kernels/flash_attention/flash_attention.py:145", k2,
              lambda rows: next(r for r in rows if r["S"] == 512 and r["window"] is None),
              ent_t["flash_attention_masked"],
              launches_by_path={c: serves[c][0]["flash_attention_masked"]
                                for c in SERVE_CONFIGS},
              route_launches={c: {"tensor-core": serves[c][2][
                  "flash_attention_masked[tensor-core]"], "cuda-core": serves[c][0][
                  "flash_attention_masked"] - serves[c][2]["flash_attention_masked[tensor-core]"]}
                  for c in SERVE_CONFIGS},
              design=("bfloat16: tensor-core flash_fwd_masked_tc (kernel 7's body with the "
                      "start mask, 64-row q tiles, 64-column kv tiles, no lse); "
                      "float32: the CUDA-core kernel"),
              build={lab: rec for lab, rec in tc_build.items() if "masked" in lab}),
        entry("paged_attention_kernel", "src/repro_torch/csrc/paged_attention.cu",
              f"{paged}:109", k3, lambda rows: rows[0], ent_t["paged_attention_kernel"],
              **paged_extra(k3, False)),
        entry("int8_matmul", "src/repro_torch/csrc/int8_matmul.cu",
              "src/repro/kernels/int8_matmul/int8_matmul.py:47", mm["int8_matmul"],
              at_decode, int8["int8_matmul"], **served("int8_matmul")),
        entry("paged_attention_kernel[int8_kv]", "src/repro_torch/csrc/paged_attention.cu",
              f"{paged}:109", k3i, lambda rows: rows[0],
              int8["paged_attention_kernel[int8_kv]"],
              branch=f"int8-KV, {paged}:49-56, :77-78, :92-94", **paged_extra(k3i, True)),
        entry("ent_matmul", "src/repro_torch/csrc/ent_matmul.cu", f"{ent}:75",
              mm["ent_matmul"], at_decode, legacy["ent_matmul"],
              launches_from="2-layer run with legacy 4-plane records",
              **routed("ent_matmul", legacy, legacy)),
        entry("ent_matmul_packed", "src/repro_torch/csrc/ent_matmul.cu", f"{ent}:205",
              mm["ent_matmul_packed"], at_decode, int8["ent_matmul_packed"],
              launches_from="no serving path; run by the kernel checks only"),
    ]
    flash = "src/repro/kernels/flash_attention/flash_attention.py"
    at_train = lambda rows: rows[0]   # noqa: E731  (B=1, H=36, S=4096, D=64)
    designs = {   # kernels 7, 7b, 7c: the route each dtype takes, and the tensor-core design
        "flash_attention": (
            "bfloat16: tensor-core, one block per (128-row q tile, q head, batch), two "
            "consumer warpgroups of 64 rows and a TMA producer warpgroup, K/V in a ring "
            "of 128-row tiles (4 stages at D=64, 3 at D=128), S = Q K^T by wgmma "
            "m64n128k16 from shared memory, online softmax in registers, O += P V by "
            "wgmma m64n64k16 with P as the bf16 register operand, TMA store; float32: "
            "the CUDA-core template (kernel 2's, TRAIN)"),
        "flash_attention_bwd_dkdv": (
            "bfloat16: tensor-core, one block per (128-row kv tile, kv head, batch), two "
            "consumer warpgroups of 64 kv rows and a TMA producer warpgroup, K and V "
            "resident, Q / dO / lse / D_i tiles (64 rows at D=64, 32 at D=128) in a "
            "4-stage ring, S^T = K Q^T and dP^T = V dO^T by wgmma from shared memory, "
            "dV += P^T dO and dK += dS^T Q by wgmma m64n64k16 with P^T, dS^T as bf16 "
            "register operands and dO, Q MN-major, D_i read as kernel 7c wrote it; "
            "float32: the CUDA-core kernel"),
        "flash_attention_bwd_dq": (
            "bfloat16: tensor-core, one block per (128-row q tile, q head, batch), two "
            "consumer warpgroups of 64 q rows and a TMA producer warpgroup, Q and dO "
            "resident, K/V in a ring of 64-row tiles (6 stages at D=64, 4 at D=128), "
            "D_i = rowsum(dO * O) in f32 before the kv loop and written once for 7b, "
            "S = Q K^T and dP = dO V^T by wgmma m64n64k16 from shared memory, dQ += dS K "
            "by wgmma m64n64k16 with dS as the bf16 register operand and K MN-major, "
            "TMA store, no atomics; float32: the CUDA-core kernel"),
    }
    for name in TRAIN_KERNELS:
        extra = dict(launches_per_step=tr["expected"][name],
                     launches_from="3 training steps of full-width minicpm-2b")
        lab = TC_SOURCES[name][0]
        extra.update(design=designs[name], route_launches={
            "tensor-core": tr["tc_launches"][name],
            "cuda-core": tr["launches"][name] - tr["tc_launches"][name]},
            build={d: tc_build[f"{lab}<{d}>"] for d in (64, 128)})
        if name != "flash_attention":
            extra["note"] = ("backward of flash_attention (:92); the reference has no "
                             "backward kernel and differentiates attention_ref "
                             "(src/repro/kernels/flash_attention/ref.py:25); plain_ms "
                             "and library_ms compute all three gradients")
        kernels.append(entry(name, "src/repro_torch/csrc/flash_attention.cu",
                             f"{flash}:92", k7[name], at_train, tr["launches"][name],
                             **extra))
    ssd = "src/repro/kernels/ssd_scan/ssd_scan.py"
    ssd_designs = {
        "ssd_scan": (
            "three launches: each chunk's own state (x w)^T B (one block per chunk, "
            "head, batch; wgmma m64n64k16, both operands MN-major), the carry h <- h "
            "exp(cum_Q) + s_c in place (bytes only), the outputs exp(cum_i) C h0^T + "
            "(C B^T L dt) X (one block per chunk, head, batch, two warpgroups of 64 rows; "
            "the masked scores as split register A operands); every product split-bf16 "
            "three-pass (hi hi + hi lo + lo hi, f32 accumulate)"),
        "ssd_scan_bwd_state": (
            "two launches in kernel 8's form: each chunk's own term (dy e)^T C, e_i = "
            "exp(cum_i) (kernel 8's states kernel with dy for x, C for B and exp(cum_i) for "
            "its row weight; one block per chunk >= 1, head, batch; wgmma m64n64k16, split-bf16 "
            "three-pass), written one slot down, then kernel 8's carry in reverse, dh <- dh "
            "exp(cum_Q) + own in place (bytes only)"),
        "ssd_scan_bwd_chunk": (
            "one block per (chunk, head, batch), two warpgroups of 64 rows; G = dy x^T "
            "and W = G L into a causal [Q, Q] tile, then per half of N: S += C B^T, dC = "
            "exp(cum) dy h0 + (W dt) B (register A), dB = dt (tail x dh + W^T C), dx += "
            "B dh^T; then M = S L dt into the tile, dx += M^T dy, and a one-warp tail "
            "(warp scans); every product split-bf16 three-pass"),
    }
    for name in SSD_KERNELS:
        extra = dict(launches_per_step=tm["expected"][name],
                     launches_from="3 training steps of full-width mamba2-370m",
                     f32_bound_ms=k8[name][-1]["f32_bound_ms"], design=ssd_designs[name])
        if name == "ssd_scan":
            extra["launches_by_part"] = {part: tm["launches"][f"ssd_scan[{part}]"]
                                         for part in SSD_FWD_PARTS}
            extra["build"] = {lab: tc_build[lab] for lab in (
                "ssd_states_kernel<false>", "ssd_carry_kernel", "ssd_fwd_out_kernel")}
        if name == "ssd_scan_bwd_state":
            extra["launches_by_part"] = {part: tm["launches"][f"ssd_scan_bwd_state[{part}]"]
                                         for part in SSD_BWD_STATE_PARTS}
            extra["build"] = {lab: tc_build[lab] for lab in (
                "ssd_states_kernel<true>", "ssd_carry_kernel")}
        if name == "ssd_scan_bwd_chunk":
            extra["build"] = {"ssd_bwd_chunk_kernel": tc_build["ssd_bwd_chunk_kernel"]}
        if name != "ssd_scan":
            extra["note"] = ("backward of ssd_scan (:72); the reference has no backward "
                             "kernel and differentiates ssd_scan_chunked "
                             "(src/repro/kernels/ssd_scan/ref.py:56)")
        kernels.append(entry(name, "src/repro_torch/csrc/ssd_scan.cu", f"{ssd}:72",
                             k8[name], lambda rows: rows[-1], tm["launches"][name], **extra))
    for arch, run in (("minicpm-2b", tr), ("mamba2-370m", tm)):
        steps = run["steps"]
        print(f"train {arch}: step seconds {[round(r['seconds'], 4) for r in steps]}, "
              f"tokens/s {[round(r['tokens_per_s'], 2) for r in steps]}, peak "
              f"{run['peak_gib']:.2f} GiB")
    for config in SERVE_CONFIGS:
        print(f"serve tokens/s [{config}] {serves[config][1]:.3f}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
