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
   6, 5 and 4, kernel 8's three launches, 8b's two and kernel 8c), of the
   split-K stream of kernels 1, 6, 5 and 4 and of the paged decode (3 and
   3b, and its ring form, the ring decode);
3. hold each kernel against its plain PyTorch version on the card at the
   main paths' shapes: the four serving matmuls (packed fused EN-T,
   w8a8 int8, 4-plane and packed EN-T) bit for bit at the full-width
   projection shapes, with the EN-T identity (all four int32
   accumulators equal); each of them on both its routes, the split-K
   stream (M 1..32) and the int8 tensor-core loop (M 1..512; X near
   rounding ties and rows whose 1 / sx overflows for kernel 1), bit for
   bit on those shapes and a ragged one, in f32, bf16 and int32 outputs,
   and the two routes timed against each other at M 8..128 (the table
   each wrapper's cut comes from);
   the flash kernel (bf16 on its tensor-core route, float32 on CUDA
   cores; ragged starts, a chunked prefill, the prefix cache's peek at
   Sq = 1 and its tail-padded suffix at a page-aligned q_offset; with
   per-sequence offsets at the speculative drafter's tick, Sq = 1, and
   its verify burst, Sq = 5, over 8 x 576 columns, with planted faults
   "slot 0's offset for every slot" and "offset off by one", and a CUDA
   ``valid`` mask refused) and the paged attention kernel (split-KV, one
   launch), the latter with bf16 pools and with int8 pools + bf16
   scales, at the serving tick's shape, at G = 12 and D = 64 with pos on
   split boundaries, and at long context (8 x 4096 tokens, timed beside
   its bytes bound), in bf16 and float32 within limits derived from the
   data (see TOL_BF16), two calls bit-identical; its ring form, the ring
   decode, at the starcoder2-15b tick (8 slots, 48 / 4 heads, a 4096-row
   ring in its stored [B, W, Hkv, D] layout read at positions on both
   sides of the wrap), bf16 and int8 pools, with the planted faults
   "positions read unrotated", "window off by one" and "last split
   dropped", timed against SDPA with the same bool mask; row 8p (kernel
   8's prefill form, ``ssd_prefill``) at mamba2-370m's serving shapes
   (an admission of 512 rows with 37 left pads, a 128-row chunk, an
   unpadded 300) from a non-zero entering state, y and the leaving state
   within limits derived as ``ssd_units`` derives kernel 8's, with the
   planted faults "entering state ignored", "leaving state of the
   last-but-one chunk" and "pad rows decay the state", timed beside its
   bytes bound; kernel 1 bit for bit at mamba2-370m's two projection
   shapes at M = 8 and 512.
   Planted faults (a wrong weight or plane code, a wrong mask argument, a
   wrong scale pool, a combine that drops the last live split) must fail
   those checks.  Kernel, plain
   version and a library yardstick are timed with CUDA events (L2 flushed
   by a read before every launch).  A failed exact matmul check prints
   ``diagnose_exact``'s three-way reading first (kernel, the card's
   reference, a CPU int64 product; where the wrong places fall on the
   plan; the split workspaces), and after every check group, and after
   every serving phase below, the split-K workspaces must hold zero words
   and tickets (``check_workspace_zero``); then the tuning phase
   (``tuning_phase``): ``kernels/tuning``'s autotune of kernel 1 and of
   kernel 3 into a temporary cache, every candidate held against the
   default plan, the winners reloaded and timed beside the defaults; the
   table is empty again after it (the run isolates the cache from this
   host's: ``REPRO_TORCH_TUNING_CACHE`` in a temporary directory);
4. serve 16 ragged greedy requests (prompts 256..512 tokens, 32 new
   tokens each) on qwen2.5-3b at full width (36 layers, random weights
   from a seed) through ``repro_torch.launch.serve``'s code, in two
   configurations: EN-T w8a8 with a bf16 KV cache, and w8a8 int8
   (``QuantConfig(ent_encode=False)``) with an int8 KV cache, both with
   plain paged admission (``prefix_cache=False``).  Each
   asserts that the kernels of its path launched, no other serving
   kernel and no plain version ran, that every decode tick launched the
   paged decode once per layer (36) and no prefill did, that every
   decode tick and every
   prefill launched its matmul once per projection and layer (252; the
   decode ticks' all on the split-K stream, the prefills' all on the
   tensor-core loop) and kernel 2 once per layer per prefill (36), all on
   its tensor-core route, and profiles full-batch decode ticks (with the
   matmul on each route, in one process) and one admission prefill; then
   the EN-T configuration with prefix sharing (``prefix_cache="auto"``):
   the same 16 prompts behind one seeded 256-token prefix and two
   page-aligned prompts whose pages are all cached (the full-match peek),
   with every admission after the first mapping the prefix's 16 pages,
   and one suffix prefill profiled beside the unshared admission of the
   same prompt; then EN-T with speculative decoding (k = 4, plain paged
   admission), a weight-shared drafter and the target's own first layer
   as drafter: every spec tick's launches (kernel 1 on the stream for the
   drafter's K + 1 steps and on the tensor-core loop for the verify,
   kernel 2 with per-sequence offsets once per layer of each, kernel 3
   never), acceptance >= 0.95 with the weight-shared drafter, the
   streams equal to the plain EN-T run's counted, at each stream's first
   divergence the plain path's top-1 minus top-2 logit beside the two
   paths' logit difference there and before it (a flip larger than twice
   the latter is logged as a fault), and one spec tick
   profiled (drafter steps, verify, its page gathers, device busy);
5. the scheduler phase on the speculative phase's model
   (``serve_scheduler``): (a) the shared-prefix phase's 18 prompts
   through ``PipelinedScheduler`` at depth 1 and at depth 0, chunked
   admission in 128-token windows: depth 1 ≡ depth 0 token for token;
   per decode tick kernel 1 252 times on the stream and kernel 3 36
   times, per chunk kernel 1 252 times on the tensor-core loop and kernel
   2 36 times, per peek kernel 1 on the stream and kernel 2, no plain
   version; no host sync in a depth-1 tick outside entry processing
   (``torch.cuda.set_sync_debug_mode``); the streams equal to the
   synchronous engine's with the same ``prefill_chunk`` counted; host ms
   a tick and device idle at depths 0 and 1 (order 0, 1, 1, 0); TTFT and
   ITL; (b) 8 of them at temperature 0.9 through the fault-tolerant
   scheduler (max_retries 3, a 3 s watchdog) under a fixed fault plan
   (errors at decode.dispatch, prefill.dispatch for one uid, sampler and
   allocator.alloc, a decode.dispatch hang past the watchdog): retried ≡
   fault-free, the plan fired as planned, no quarantine, and the planted
   fault "restore skips the generator states" must break the equality;
   the snapshot's bytes and its host and device ms; (c) the same 8 parked
   and resumed by ``ElasticSupervisor`` over 2 simulated hosts, ≡ the
   uninterrupted streams, leak-free; (d) ``launch/serve.py``'s
   ``--http --http-smoke`` path, plain and under "ci-chaos"; then
   ``generate`` on the same model: the serve phase's first 8 prompts
   left-padded with ``prompt_lens``, 32 greedy steps on dense rows, kernel
   1 on both routes and kernel 2 (offsets on decode) only, its streams
   counted against the engine's;
5b. sliding-window serving on full-width starcoder2-15b (40 layers,
   d_model 6144, 48 / 4 heads, d_ff 24576, window 4096; EN-T weights
   quantized layer by layer on the card; a 4096-row ring a slot): 16
   greedy requests of 4,080..4,600 prompt tokens, 32 new tokens each, on
   8 slots; every decode tick kernel 1 240 times on the split-K stream
   and the ring decode 40 times (kernel 2 never), every prefill chunk
   (4,096 rows) kernel 1 240 times on the tensor-core loop and kernel 2
   40 times with window 4096, kernel 3 and the plain versions never; the
   first wave's prompts re-admitted over stale rings reproduce their
   streams; a full-batch tick timed and profiled (the ring decode's
   share, the copies);
5c. SSM serving on full-width mamba2-370m (48 layers, EN-T, the paged
   engine, prefix caching "auto" = off): the serve phase's 16 requests x
   32 new tokens on 8 slots; every decode tick kernel 1 96 times on the
   stream and nothing else of the port's kernels, every admission
   prefill kernel 1 96 times on the tensor-core loop and 8p 48 times
   (each of its three launches 48); a full-batch tick profiled (busy,
   idle, CUDA kernels a tick), the SSM states' bytes; then speculative
   decoding (k = 4, the target's layer 0 as the drafter) on the first 8
   prompts: acceptance, tokens a tick, streams against plain decode's,
   every flip a near-tie;
5d. MoE serving on mixtral-8x7b at full width, 16 of its 32 layers
   (bf16 params, the experts 2.8 GB a layer; EN-T attention, float
   router and experts, bf16 KV on the ring): the same 16 requests; every
   tick kernel 1 64 times on the stream and the ring decode 16, every
   prefill kernel 1 64 times on the tensor-core loop and kernel 2 16
   (window 4096); each tick's dropped expert assignments; a tick
   profiled;
6. one prefill + 4 decode ticks of the same widths at 2 layers with the
   kernels and with the plain versions, compared (bf16 and float32 with
   EN-T weights, float32 with float weights, bf16 with int8 weights and
   int8 KV, bf16 with legacy 4-plane records, whose 70 kernel 5 launches
   must split between the split-K stream (the ticks) and the tensor-core
   loop (the prefill) as its cut says), and with planted mask and scale
   faults that the limits must reject; and the prefix cache's path (a
   256-token prefix, a 200-token suffix tail-padded to 256 with its last
   real row picked, a peek over 28 shared pages that must leave the pool
   unchanged, 4 decode ticks), whose planted faults (kernel 2 at q_offset
   0, the last real row ignored) the limit must reject; and the
   speculative path (bf16 EN-T, and int8 with int8 KV): two verify bursts
   around a rollback and the drafter's dense decode steps, kernels vs
   plain and the bursts vs K + 1 kernel decode steps within the same
   limit, the planted fault "pos not reset after a rejection" over it;
   and the ring's path (a 5,120-token prompt in chunks of 4,096 and
   1,024 rows, the second over the wrap, then 4 decode ticks; bf16 KV,
   then int8 KV through the ring decode's int8 form), whose planted fault
   "context read after the chunk's write" the limit must reject; and 2
   full-width layers each of mamba2-370m and mixtral-8x7b (bf16
   params), a 300-token prompt with 20 left pads in chunks of 256 rows
   and 4 decode ticks, the logits (and mamba2's leaving SSD states)
   within 0.07 relative L2, 8p's planted faults 5 and 6 over it;
7. the training kernels: the flash forward (kernel 7) against
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
8. loss and every gradient leaf of full-width minicpm-2b at 2 layers
   (S=1024) with the kernels and with the plain versions, bf16 and
   float32, with planted faults in the attention wrappers, and with
   remat full and dots against no remat;
9. 3 training steps of full-width minicpm-2b (40 layers, seq 4096,
   global batch 2, microbatch 1, remat full) through
   ``repro_torch.launch.train``'s code, each step's launches of kernels
   7 / 7b / 7c checked against 160 / 80 / 80, all on the tensor-core
   route, with no plain D_i pass (``bwd_delta``: 7c writes D_i for 7b),
   then one more step under ``torch.profiler``;
10. the SSD kernels: the scan (kernel 8: each chunk's own state, the
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
11. loss and every gradient leaf of full-width mamba2-370m at 2 layers
   (S=1024) with the kernels and with the plain versions, bf16 and
   float32, with planted faults in the SSD wrappers, and remat full and
   dots against no remat;
12. 3 training steps of full-width mamba2-370m (48 layers, seq 4096,
   global batch 8, microbatch 4, remat full), each step's launches of
   kernels 8 / 8b / 8c checked against 192 / 96 / 96, of each of kernel
   8's three launches (states, carry, outputs) against 192 and of each of
   8b's two (own, carry) against 96; with checkpointing
   (``repro_torch.checkpoint``): ``train`` saves params, m, v and step
   after step 2 (~5.0 GB, into ``_ckpt_smoke/`` beside this script; the
   free disk printed), the host snapshot's and the background write's
   seconds and the bytes printed, the write running beside step 3; a
   restore into a fresh build bit-identical to the state saved; step 3
   again from the in-memory state after step 2 (the repeat) and from the
   restored state, the stream seeked to 2, each step's launches checked
   as above: the repeat must equal the uninterrupted step 3 or the resumed
   step must stay within twice the repeat's difference, and if the repeat
   is bit-identical the resumed step must be too; the directory is
   removed; then one more step under ``torch.profiler``;
13. the paper's encoders and multipliers on the card (``core/encoding``,
   ``core/multiplier``): every encoding function equal to its CPU
   result over all int8 / uint8 and 16-bit values, ``ent_multiply`` and
   ``mbe_multiply`` equal to a * b for all 65,536 int8 pairs, the 16-bit
   round trip, ``ent_plane_matmul`` (kernel 5) and ``ent_packed_matmul``
   (kernel 4) equal to the CPU's int32 product at quickstart's shape and
   at M = 8 / 512, K = 2048, N = 11008 (their launches counted), the
   planted fault "carry into the next digit ignored" caught; then
   ``examples/torch_quickstart.py`` (kernels 5 and 4 once each);
14. the paper tables (``core/paper_tables.ALL_TABLES``) in this process,
   and the Fig 7 headline (pure Python: a sanity line);
15. multi-device under an NCCL process group of world 1 (a ``FileStore``
   in a temporary directory) on a 1x1 ("data", "model") mesh: (a)
   full-width mamba2-370m in phase 12's configuration, one plain step and
   one through the sharded step (``make_train_step(..., data_axes="data",
   grad_shardings=...)``) from two copies of one seeded state: loss,
   grad-norm and every leaf of params, m and v bit-identical, kernels 8 /
   8b / 8c launched 192 / 96 / 96 by each, both steps' times and peaks;
   (b) one full-width mixtral-8x7b MoE layer (bf16) through
   ``moe.apply_sharded`` and ``moe.apply`` at T = 8 and T = 4096: outputs
   and, at T = 4096, the input and expert gradients within the relative
   L2 limit ``tests/test_torch_moe_sharded.py`` derives, the planted
   fault "one expert's gate dropped from the combine" over it, both
   paths timed; (c) the process group destroyed;
16. a ``kernels`` JSON line, the card line, and the final result line.

Without a CUDA card it prints nothing but an error and exits 2.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
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


PEAK_OPS_S = {"bf16": BF16_FLOPS_S, "int8": INT8_OPS_S, "f32": F32_FLOPS_S}


def bound_ms(nbytes, flops):
    """(ms, bound_by) of work that moves ``nbytes`` HBM bytes and does
    ``flops`` ({operand type: operations}), each type at its peak."""
    tb = nbytes / HBM_BYTES_S * 1e3
    to = sum(f / PEAK_OPS_S[t] for t, f in flops.items()) * 1e3
    return max(tb, to), ("bytes" if tb >= to else "operations")


def cost_bounds(ops, wrapper, *args, **kwargs):
    """{kernel: (bound ms, bound_by, flops, bytes)} of one call of ``ops``'
    ``wrapper`` on these arguments, from the kernel package's own count
    (``ops.cost``, ``src/repro_torch/kernels/cost.py``: each input read
    once, each output written once, the work this call's data needs),
    which the planner (``launch/dryrun.py``) charges too."""
    return {kernel: (*bound_ms(nbytes, flops), flops, nbytes)
            for kernel, flops, nbytes in ops.cost(wrapper, *args, **kwargs)}


def matmul_bound(name, x, w, sx, sw, out_dtype):
    """(bound ms, bound_by) of one call of kernel 1, 6, 5 or 4 (``name``)."""
    from repro_torch.kernels.ent_matmul import ops as ent_ops
    from repro_torch.kernels.int8_matmul import ops as int8_ops
    ops = int8_ops if name == "int8_matmul" else ent_ops
    return cost_bounds(ops, name, x, w, sx, sw, out_dtype)[name][:2]


def workspace_state(torch):
    """{key: (nonzero words, nonzero tickets)} of every split workspace
    that ``_build.stream_workspace`` holds, after the card is idle.  The
    paged kind's words are f32 partials that no call zeroes: None."""
    from repro_torch.kernels import _build
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return {key: (None if len(key) > 2 else int(torch.count_nonzero(ws)),
                  int(torch.count_nonzero(tk)))
            for key, (ws, tk) in _build._workspaces.items()}


def _ws_key(key):
    return "/".join(str(p) for p in key)


def check_workspace_zero(torch, where):
    """The invariant every split call keeps: the split-K workspaces of
    kernels 1, 4, 5 and 6 (one per device and CUDA stream, both routes)
    hold zero words and zero tickets, and the paged kind's tickets are
    zero.  A nonzero word is a partial sum an earlier call left behind,
    which the next split call would add to its own."""
    state = workspace_state(torch)
    bad = {k: v for k, v in state.items() if v[0] or v[1]}
    if bad:
        raise AssertionError(f"after {where}: split workspaces not zero: "
                             + "; ".join(f"{_ws_key(k)} {w} nonzero words, {t} nonzero tickets"
                                         for k, (w, t) in bad.items()))
    print(f"  workspace invariant after {where}: "
          + (", ".join(_ws_key(k) for k in state) or "no workspace") + " all zero", flush=True)


DIAG_POSITIONS = 4096   # differing places a failed exact check recomputes on the CPU
DIAG_SHOWN = 5          # of which it prints the first


def diagnose_exact(torch, what, got, want, x, sx, sw, w8, route, tc_bm=128, sms=None):
    """The three-way reading of a failed exact check of kernel 1, 4, 5 or
    6 (``got``) against the card's plain version (``want``), for the
    caller's AssertionError.  At up to DIAG_POSITIONS of the differing
    places (evenly strided), the product is recomputed on the CPU in int64
    from the operands copied to the host (X quantized there from X and sx
    when the kernel quantizes it; the int8 weights ``w8``, whose product
    all four kernels' accumulators equal), with the plain epilogue for a
    float output.  Returns the text: how many places differ; how many of
    the recomputed ones the kernel, the card's reference, or both get
    wrong; the first DIAG_SHOWN (row, column, kernel, card ref, CPU ref);
    where the differing places fall on ``route``'s plan (strips of 64
    columns and M chunks of the stream, 128-column tiles of the tensor-core
    loop, and for an int32 output each wrong kernel value read as one K
    split's partial sum missing or counted twice); and the split
    workspaces' nonzero words and tickets after the call."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.ent_matmul import ent_matmul as em
    from repro_torch.kernels.ent_matmul.ref import quantize_with_scale
    m, k = x.shape
    n = w8.shape[1]
    sms = _build.sm_count(got.device) if sms is None else sms
    if route == "stream":
        mb, kslice, splits, _ = em.stream_plan(m, n, k, sms)
        where = f"stream plan mb {mb}, kslice {kslice}, {splits} splits"
    else:
        kslice, splits, _ = em.tc_plan(m, n, k, sms, tc_bm)
        mb = tc_bm
        where = f"tensor-core plan {tc_bm}-row tiles, kslice {kslice}, {splits} splits"
    bad = (got != want).nonzero().cpu()
    n_bad = bad.shape[0]
    pick = bad[::max(1, -(-n_bad // DIAG_POSITIONS))]
    rows, cols = pick[:, 0], pick[:, 1]
    xh = x.cpu()
    xq = xh if xh.dtype == torch.int8 else quantize_with_scale(xh.float(), sx.cpu())
    wh, sxh, swh = w8.cpu(), sx.cpu().float(), sw.cpu().float()
    ends = [min((s + 1) * kslice, k) - 1 for s in range(splits)]
    accs, parts = [], []
    for lo in range(0, rows.numel(), 256):
        r, c = rows[lo:lo + 256], cols[lo:lo + 256]
        run = (xq[r].long() * wh[:, c].t().long()).cumsum(1)[:, ends]
        accs.append(run[:, -1])
        parts.append(torch.diff(run, dim=1, prepend=torch.zeros_like(run[:, :1])))
    acc = torch.cat(accs) if accs else torch.zeros(0, dtype=torch.long)
    part = torch.cat(parts) if parts else torch.zeros((0, splits), dtype=torch.long)
    if got.dtype == torch.int32:
        cpu = acc.to(torch.int32)
    else:
        cpu = (acc.to(torch.float32) * sxh[rows, 0] * swh[0, cols]).to(got.dtype)
    kv, rv = got[rows, cols].cpu(), want[rows, cols].cpu()
    k_ok, r_ok = kv == cpu, rv == cpu
    lines = [f"{what}: {n_bad} of {got.numel()} places differ from the card's plain version; "
             f"recomputed on the CPU in int64 at {rows.numel()}: the kernel wrong at "
             f"{int((~k_ok & r_ok).sum())}, the card's reference wrong at "
             f"{int((k_ok & ~r_ok).sum())}, both wrong at {int((~k_ok & ~r_ok).sum())}"]
    lines.append("  first (row, column, kernel, card ref, CPU ref): " + "; ".join(
        f"({int(rows[i])}, {int(cols[i])}, {kv[i].item()}, {rv[i].item()}, {cpu[i].item()})"
        for i in range(min(DIAG_SHOWN, rows.numel()))))
    cw = 64 if route == "stream" else 128
    strips = sorted({int(c) // cw for c in bad[:, 1]})
    chunks = sorted({int(r) // mb for r in bad[:, 0]})
    lines.append(f"  where ({where}): {len(strips)} of {-(-n // cw)} {cw}-column "
                 f"{'strips' if route == 'stream' else 'tiles'} {strips[:16]}, "
                 f"{len(chunks)} of {-(-m // mb)} M chunks of {mb} rows {chunks[:16]}")
    if got.dtype == torch.int32 and rows.numel():
        delta = (kv.long() - acc)[:, None]
        missing, twice = (delta == -part), (delta == part) & (part != 0)
        wrong = ~k_ok
        lines.append("  a wrong kernel value as one split's partial sum: missing "
                     + str({s: int((missing[:, s] & wrong).sum()) for s in range(splits)
                            if (missing[:, s] & wrong).any()})
                     + ", twice " + str({s: int((twice[:, s] & wrong).sum()) for s in range(splits)
                                         if (twice[:, s] & wrong).any()})
                     + f", neither {int((wrong & ~(missing | twice).any(1)).sum())}")
    lines.append("  split workspaces after the call (nonzero words, tickets): " + (", ".join(
        f"{_ws_key(key)} {v}" for key, v in workspace_state(torch).items()) or "none"))
    text = "\n".join(lines)
    print(text, flush=True)
    return text


def assert_exact(torch, what, got, want, x, sx, sw, w8, route, tc_bm=128, sms=None):
    """``torch.equal(got, want)``, else the three-way reading of
    ``diagnose_exact`` and an AssertionError."""
    if not torch.equal(got, want):
        raise AssertionError(diagnose_exact(torch, what, got, want, x, sx, sw, w8, route,
                                            tc_bm, sms))


def check_matmuls(torch, timer):
    """The four serving matmuls at the full-width projection shapes:
    kernel 1 (``ent_matmul_packed_fused``) and kernels 6 / A
    (``int8_matmul``), 5 / C (``ent_matmul``, 4-plane) and 4 / D
    (``ent_matmul_packed``), at M = 8 (on the split-K stream) and M = 512
    (on the tensor-core loop).  Each is held bit for
    bit against its plain version; the four int32 accumulators at the same
    Xq (kernel 1 quantizes X with the same sx) must all be equal, the EN-T
    identity; one planted fault per kernel (one weight or plane code off
    by one) must fail the exact check at both M; and all four, their plain
    versions and ``torch._int_mm`` are timed, each on the route its
    wrapper takes at that M.  Returns {kernel name: [row per shape]}."""
    from repro_torch.core.multiplier import ent_packed_planes
    from repro_torch.kernels.ent_matmul import ent_matmul as em
    from repro_torch.kernels.ent_matmul.ent_matmul import (ent_matmul, ent_matmul_packed,
                                                           ent_matmul_packed_fused)
    from repro_torch.kernels.ent_matmul.ops import encode_weights, row_scale
    from repro_torch.kernels.ent_matmul.ref import (ent_matmul_ref, ent_packed_matmul_ref,
                                                    quantize_with_scale)
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
            x_of = lambda name: x if name == "ent_matmul_packed_fused" else xq  # noqa: E731
            # the EN-T identity: one int32 accumulator for all four
            acc = int8_matmul_int32_ref(xq, w8)
            for name, (kern, w, _) in cases.items():
                got = kern(w, torch.int32)
                torch.cuda.synchronize()
                assert_exact(torch, f"EN-T identity: {name} M={m} K={k} N={n}: int32 "
                             f"accumulator against X @ W", got, acc, x_of(name), sx, sw, w8,
                             matmul_route(name, m), em.tc_bm(name))
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
                assert_exact(torch, f"{name} M={m} K={k} N={n}: f32 output against the plain "
                             f"version (max abs err {err})", got, want, x_of(name), sx, sw, w8,
                             matmul_route(name, m), em.tc_bm(name))
                if name == "int8_matmul":
                    assert_exact(torch, f"int8_matmul M={m} K={k} N={n}: bf16 output",
                                 kern(w, torch.bfloat16),
                                 int8_matmul_ref(xq, w8, sx, sw, torch.bfloat16), xq, sx, sw, w8,
                                 matmul_route(name, m))
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
                b, by = matmul_bound(name, x if name == "ent_matmul_packed_fused" else xq,
                                     w, sx, sw, torch.float32)
                extra = dict(route=matmul_route(name, m))
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


# starcoder2-15b's projections (d_model 6144, 4 kv heads of 128, d_ff
# 24576, GELU): q and o, k and v, up, down; and the M its ring serving runs
# kernel 1 at: a decode tick's 8 slots (the split-K stream), a second
# prefill chunk's ragged rows (a 4,097..4,600-token prompt less the ring's
# 4,096) and a whole first chunk (both on the tensor-core loop)
RING_SHAPES = [(6144, 6144), (6144, 512), (6144, 24576), (24576, 6144)]
RING_MATMUL_M = (8, 497, 4096)


# mamba2-370m's projections (d_model 1024, d_inner 2048, 32 heads, N 128,
# one group): in_proj 1024 -> 4384 (z, x, B, C, dt) and out_proj 2048 ->
# 1024; at a decode tick's 8 slots and a 512-token admission
MAMBA_SHAPES = [(1024, 4384), (2048, 1024)]
MAMBA_MATMUL_M = (8, 512)


def check_ring_matmuls(torch, timer, shapes=RING_SHAPES, m_values=RING_MATMUL_M,
                       model="starcoder2-15b", seed=16):
    """Kernel 1 (``ent_matmul_packed_fused``) at ``shapes`` x ``m_values`` (by
    default starcoder2-15b's RING_SHAPES x RING_MATMUL_M; mamba2-370m's are
    MAMBA_SHAPES x MAMBA_MATMUL_M) through its public wrapper, each call
    one launch on the route its cut gives that M: bit for bit against its
    plain version in f32 and bf16 outputs, its int32 accumulator equal to X
    @ W (the EN-T identity); one plane code off by one must fail the exact
    check at every M; timed against the plain version and
    ``torch._int_mm``.  Returns rows."""
    from repro_torch.core.multiplier import ent_packed_planes
    from repro_torch.kernels.ent_matmul.ent_matmul import ent_matmul_packed_fused as kern1
    from repro_torch.kernels.ent_matmul.ops import row_scale
    from repro_torch.kernels.ent_matmul.ref import ent_packed_matmul_ref, quantize_with_scale
    from repro_torch.kernels.int8_matmul.ref import int8_matmul_int32_ref
    g = torch.Generator(device=DEV).manual_seed(seed)
    rows = []
    for k, n in shapes:
        w8 = torch.randint(-127, 128, (k, n), generator=g, device=DEV, dtype=torch.int8)
        packed = ent_packed_planes(w8).contiguous()
        sw = torch.rand((1, n), generator=g, device=DEV) * 1e-2 + 1e-4
        for m in m_values:
            x = torch.randn((m, k), generator=g, device=DEV).to(torch.bfloat16)
            sx = row_scale(x)
            xq = quantize_with_scale(x, sx)
            route = matmul_route("ent_matmul_packed_fused", m)
            what = f"ent_matmul_packed_fused ({model}) M={m} K={k} N={n}"
            acc = int8_matmul_int32_ref(xq, w8)
            for o in (torch.int32, torch.float32, torch.bfloat16):
                want = acc if o == torch.int32 else ent_packed_matmul_ref(xq, packed, sx, sw, o)
                before = kern1.launches, getattr(kern1, f"{route}_launches")
                got = kern1(x, packed, sx, sw, o)
                torch.cuda.synchronize()
                if (kern1.launches - before[0],
                        getattr(kern1, f"{route}_launches") - before[1]) != (1, 1):
                    raise AssertionError(f"{what}: not one launch on the {route} route")
                assert_exact(torch, f"{what} out {o}: against the plain version", got, want,
                             x, sx, sw, w8, route)
            bad = packed.clone()
            flat = bad.view(-1)
            flat[k * n // 2] += 1 if int(flat[k * n // 2]) < 1 else -1
            n_bad = int((kern1(x, bad, sx, sw, torch.int32) != acc).sum())
            if not n_bad:
                raise AssertionError(f"{what}: the exact check misses a wrong code")
            del bad, flat, acc
            xq_lib = torch.cat([xq, xq.new_zeros((max(0, 32 - m), k))]) if m < 32 else xq
            library_ms = timer(lambda: torch._int_mm(xq_lib, w8))
            ms = timer(lambda: kern1(x, packed, sx, sw, torch.bfloat16))
            plain_ms = timer(lambda: ent_packed_matmul_ref(xq, packed, sx, sw, torch.bfloat16),
                             reps=3)
            b, by = matmul_bound("ent_matmul_packed_fused", x, packed, sx, sw, torch.bfloat16)
            print(f"kernel {what} route={route} ms={ms:.4f} plain_ms={plain_ms:.4f} "
                  f"library_ms={library_ms:.4f} bound_ms={b:.4f} ({by}) max_abs_err=0.0 "
                  f"bit_exact=True (int32 / f32 / bf16); planted fault 'one code off by one': "
                  f"{n_bad} of {m * n} outputs differ", flush=True)
            rows.append(dict(M=m, K=k, N=n, route=route, out="bf16", ms=ms, plain_ms=plain_ms,
                             library_ms=library_ms, bound_ms=b, bound_by=by, max_abs_err=0.0))
        del w8, packed
        torch.cuda.empty_cache()
    return rows


# the four projection shapes and a ragged one
STREAM_SHAPES = [(2048, 2048), (2048, 256), (2048, 11008), (11008, 2048), (1000, 300)]
# kernels 1, 6, 5 and 4 on the stream: M up to the cut (decode: 8), and one
# M past it at which check_cut times the stream (in chunks of 8 rows); on
# the tensor-core loop at these M as well (check_cut and the decode ticks'
# route comparison run it there)
STREAM_CHECK_M = (1, 3, 8, 16, 32)
# the matmuls on the tensor-core loop: one tile, the M just past it, and
# the serving prefills' range (260..505 prompt tokens) and cap
TC_CHECK_M = (128, 129, 260, 505, 512)
CUT_M = (8, 16, 32, 64, 96, 128)   # where check_cut times the two routes
# kernels 1, 6, 5 and 4: the matmuls routed by M, each by its own cut
MATMULS = ("ent_matmul_packed_fused", "int8_matmul", "ent_matmul", "ent_matmul_packed")


def matmul_cuts():
    """{kernel 1, 6, 5 or 4: (the wrapper module, the name of its cut)}."""
    from repro_torch.kernels.ent_matmul import ent_matmul as em
    from repro_torch.kernels.int8_matmul import int8_matmul as im
    return {"ent_matmul_packed_fused": (em, "M_STREAM"), "int8_matmul": (im, "M_STREAM"),
            "ent_matmul": (em, "M_STREAM_PLANES"), "ent_matmul_packed": (em, "M_STREAM_PACKED")}


def matmul_cut(name):
    """The cut of kernel 1, 6, 5 or 4, read at call time."""
    mod, attr = matmul_cuts()[name]
    return getattr(mod, attr)


def matmul_route(name, m):
    """The route the wrapper of kernel 1, 6, 5 or 4 takes at ``m`` rows."""
    from repro_torch.kernels.ent_matmul import ent_matmul as em
    return em.route_of(m, matmul_cut(name))


def _routed(torch, g, k, n):
    """Operands of kernels 1, 6, 5 and 4 at one projection shape (weights,
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

    def k4(x, sx, xq, route, o, planes=packed):
        if route is None:
            return em.ent_matmul_packed(xq, planes, sx, sw, o)
        return em._launch_packed(xq, planes, sx, sw, o, route)
    return w8, (packed, digits), sw, {"ent_matmul_packed_fused": (k1, em.ent_matmul_packed_fused),
                                      "int8_matmul": (k6, im.int8_matmul),
                                      "ent_matmul": (k5, em.ent_matmul),
                                      "ent_matmul_packed": (k4, em.ent_matmul_packed)}


def check_routes_exact(torch, what, ms, route, x_dtypes, seed):
    """Kernels 1, 6, 5 and 4 on ``route`` at every M of ``ms`` ({kernel name:
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
                            assert_exact(torch, f"{what} {name} M={m} K={k} N={n} X {xdt} out "
                                         f"{o}: against the plain version", got, want,
                                         x if name == "ent_matmul_packed_fused" else xq, sx, sw,
                                         w8, route, em.tc_bm(name))
                            n_checked += 1
                    if m == max(ms[name]) and xdt == x_dtypes[0]:   # planted fault
                        bad = {"ent_matmul_packed_fused": packed, "int8_matmul": w8,
                               "ent_matmul": digits, "ent_matmul_packed": packed}[name].clone()
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
    kernels 1, 6, 5 and 4 alike."""
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
                 out.data_ptr(), 0), em.TC_BM_PLANES),
            "ent_matmul_packed": (
                _build.entry("ent_matmul", f"ent_matmul_packed_{route}"),
                (x8.data_ptr(), planes.data_ptr(), sx.data_ptr(), sw.data_ptr(),
                 out.data_ptr(), 0), em.TC_BM)}
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
    print("  stream and tensor-core launchers (kernels 1, 6, 5 and 4): a ticket short, a sum "
          "short and a K slice off its step refused", flush=True)


def time_routes(torch, timer, ms, routes, seed, names=MATMULS):
    """Kernels ``names`` of 1, 6, 5 and 4 (X bf16, f32 out) on each of ``routes``
    at every M of ``ms`` on the four projection shapes, beside the bound
    and ``torch._int_mm`` (one plane, M padded to 32 rows).  Returns rows."""
    from repro_torch.kernels.ent_matmul.ops import row_scale
    from repro_torch.kernels.ent_matmul.ref import quantize_with_scale
    g = torch.Generator(device=DEV).manual_seed(seed)
    rows = []
    for k, n in STREAM_SHAPES[:4]:
        w8, (packed, digits), sw, kernels = _routed(torch, g, k, n)
        weights = {"ent_matmul_packed_fused": packed, "int8_matmul": w8, "ent_matmul": digits,
                   "ent_matmul_packed": packed}
        for m in ms:
            x = torch.randn((m, k), generator=g, device=DEV).to(torch.bfloat16)
            sx = row_scale(x)
            xq = quantize_with_scale(x, sx)
            xq_lib = torch.cat([xq, xq.new_zeros((max(0, 32 - m), k))]) if m < 32 else xq
            library_ms = timer(lambda: torch._int_mm(xq_lib, w8))
            for name in names:
                call = kernels[name][0]
                t = {r: timer(lambda: call(x, sx, xq, r, torch.float32)) for r in routes}
                b, by = matmul_bound(name, x if name == "ent_matmul_packed_fused" else xq,
                                     weights[name], sx, sw, torch.float32)
                print(f"kernel {name} M={m} K={k} N={n}: "
                      + " ".join(f"{r} ms={v:.4f}" for r, v in t.items())
                      + f" bound_ms={b:.4f} ({by}) library_ms={library_ms:.4f}", flush=True)
                rows.append(dict(kernel=name, M=m, K=k, N=n, bound_ms=b, bound_by=by,
                                 library_ms=library_ms, **{f"{r}_ms": v for r, v in t.items()}))
    return rows


def check_stream(torch):
    """The split-K weight stream (``csrc/int8_stream.cuh``) of kernels 1,
    6, 5 and 4, which their wrappers take up to their cuts: bit for bit at
    STREAM_CHECK_M (``check_routes_exact``), then the launchers'
    refusals.  Returns the number of calls checked."""
    n = check_routes_exact(torch, "stream", dict.fromkeys(MATMULS, STREAM_CHECK_M), "stream",
                           (torch.bfloat16, torch.float32), 13)
    check_launchers_refuse(torch)
    return n


def check_tc(torch):
    """The int8 tensor-core loop (``csrc/int8_tc.cuh``) of kernels 1, 6, 5
    and 4, which their wrappers take above their cuts: bit for bit at STREAM_CHECK_M,
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
        xr, sxr = x[:rows].contiguous(), sx[:rows].contiguous()
        got = em._launch_fused(xr, packed, sxr, sw, torch.int32, route)
        assert_exact(torch, f"{route} K={x.shape[1]} N={w8.shape[1]}: {what}, X {x.dtype}",
                     got, want[:rows], xr, sxr, sw, w8, route)
    return 2


# projections a layer by shape (K, N): q and o, k and v, gate and up, down
LAYER_SHAPES = {(2048, 2048): 2, (2048, 256): 2, (2048, 11008): 2, (11008, 2048): 1}


def check_cut(torch, timer):
    """The stream against the tensor-core loop at CUT_M, kernels 1, 6, 5
    and 4, on the four projection shapes: the table each wrapper's cut is set
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


# the tuning phase's two shapes: kernel 1 at a decode tick's gate / up
# projection (m, k, n), over the stream's K slices; kernel 3 at the serving
# tick's paged read, over pages a split
TUNE_MATMUL = (8, 2048, 11008)
TUNE_PAGED = "tick"


def tuning_phase(torch, timer):
    """``kernels/tuning`` on the card, with its cache in a temporary
    directory: ``autotune`` (CUDA events, the L2 flushed by a read) of
    kernel 1 at TUNE_MATMUL over the stream's K slices at the default
    plan's rows a block, and of kernel 3 (bf16 pools) at PAGED_CASES'
    serving tick over pages a split.  Every candidate's output is held
    against the default plan's: kernel 1's int32 accumulator bit for bit
    (the default's equal to X @ W), kernel 3's within 2 TOL_BF16 att|v| of
    it and TOL_BF16 of the plain version (a split changes the sum order;
    each plan is within TOL_BF16 of the plain version).  Then the cache is
    reloaded in-process, each wrapper must resolve its winner from it, and
    each winner's time through the wrapper is printed beside the default
    plan's, with the host microseconds of one memoised plan lookup beside
    a direct ``stream_plan`` call.  The table is emptied at the end: the
    later phases run on the heuristics.  Returns the figures."""
    from repro_torch.core.multiplier import ent_packed_planes
    from repro_torch.kernels import _build, tuning
    from repro_torch.kernels.ent_matmul import ent_matmul as em
    from repro_torch.kernels.ent_matmul.ops import row_scale
    from repro_torch.kernels.ent_matmul.ref import quantize_with_scale
    from repro_torch.kernels.int8_matmul.ref import int8_matmul_int32_ref
    from repro_torch.kernels.paged_attention.paged_attention import paged_attention_kernel
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    sms = _build.sm_count(torch.device(DEV, 0))
    fam, (m, k, n) = "ent_matmul_packed_fused", TUNE_MATMUL
    g = torch.Generator(device=DEV).manual_seed(31)
    w8 = torch.randint(-127, 128, (k, n), generator=g, device=DEV, dtype=torch.int8)
    packed = ent_packed_planes(w8).contiguous()
    sw = torch.rand((1, n), generator=g, device=DEV) * 1e-2 + 1e-4
    x = torch.randn((m, k), generator=g, device=DEV).to(torch.bfloat16)
    sx = row_scale(x)
    default_mm = dict(tuning.get_block_config(fam, (m, k, n), sms=sms))
    if default_mm != dict(tuning._heuristic(fam, (m, k, n), sms)) or default_mm["route"] != "stream":
        raise AssertionError(f"tuning: kernel 1's plan at {TUNE_MATMUL} on an empty table is "
                             f"{default_mm}, not the stream's heuristic")
    mm_cands = [c for c in tuning.matmul_candidates(fam, m, k, n, sms=sms, route="stream")
                if c["mb"] == default_mm["mb"]]
    base = em._launch_fused(x, packed, sx, sw, torch.int32, "stream", plan=default_mm)
    assert_exact(torch, f"tuning: kernel 1 {TUNE_MATMUL} default plan {default_mm}", base,
                 int8_matmul_int32_ref(quantize_with_scale(x, sx), w8), x, sx, sw, w8, "stream")
    for c in mm_cands:
        if not torch.equal(em._launch_fused(x, packed, sx, sw, torch.int32, "stream", plan=c),
                           base):
            raise AssertionError(f"tuning: kernel 1 {TUNE_MATMUL} plan {c} differs from the "
                                 f"default plan's int32 accumulator")

    b, hq, hkv, d, page, pps = PAGED_CASES[TUNE_PAGED][:6]
    q, kp, vp, table, pos, start, _ = paged_case(torch, PAGED_CASES[TUNE_PAGED], False)
    default_pa = dict(tuning.get_block_config("paged_attention", (b, hkv, pps), sms=sms))
    pa_cands = tuning.paged_attention_candidates(b, hkv, pps, sms=sms)

    def paged(plan=None):
        return paged_attention_kernel(q, kp, vp, table, pos, start, page_size=page, plan=plan)
    att = paged_attention_ref(q.float(), kp.float(), vp.float().abs(), table, pos, start,
                              page_size=page)
    plain = paged_attention_ref(q, kp, vp, table, pos, start, page_size=page)
    base_pa = paged(default_pa)
    reads = {}
    for c in pa_cands:
        got = paged(c)
        reads[c["pages"]] = (excess(got, base_pa, att, 2 * TOL_BF16),
                             excess(got, plain, att, TOL_BF16))
        if max(reads[c["pages"]]) > 1:
            raise AssertionError(f"tuning: kernel 3 plan {c} reads {reads[c['pages']]} against "
                                 f"the default plan's output (2 TOL_BF16) and the plain "
                                 f"version's (TOL_BF16)")

    old = os.environ.get("REPRO_TORCH_TUNING_CACHE")
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tuning_") as tmp:
        os.environ["REPRO_TORCH_TUNING_CACHE"] = os.path.join(tmp, "tuning.json")
        try:
            tuning.reload()
            t0 = time.perf_counter()
            win_mm = tuning.autotune(fam, (m, k, n), lambda c: em._launch_fused(
                x, packed, sx, sw, torch.bfloat16, "stream", plan=c), mm_cands, sms=sms)
            win_pa = tuning.autotune("paged_attention", (b, hkv, pps), paged, pa_cands, sms=sms)
            tune_s = time.perf_counter() - t0
            with open(tuning.cache_path()) as f:
                saved = json.load(f)
            tuning.reload()   # the winners from the file, in this process
            for fam_, shape, win in ((fam, (m, k, n), win_mm),
                                     ("paged_attention", (b, hkv, pps), win_pa)):
                got = dict(tuning.get_block_config(fam_, shape, sms=sms))
                if got != {**tuning._heuristic(fam_, shape, sms), **win}:
                    raise AssertionError(f"tuning: {fam_} {shape} resolves {got} after the "
                                         f"reload, not the winner {win} (file {saved})")
            wrap = lambda: em.ent_matmul_packed_fused(x, packed, sx, sw, torch.bfloat16)  # noqa: E731
            out["ent_matmul_packed_fused"] = dict(
                shape=TUNE_MATMUL, candidates=mm_cands, default=default_mm, winner=win_mm,
                winner_ms=timer(wrap),
                default_ms=timer(lambda: em._launch_fused(x, packed, sx, sw, torch.bfloat16,
                                                          "stream", plan=default_mm)))
            out["paged_attention"] = dict(
                shape=(b, hkv, pps), candidates=pa_cands, default=default_pa, winner=win_pa,
                winner_ms=timer(paged), default_ms=timer(lambda: paged(default_pa)),
                err_over_limit=reads)
            reps = 100_000
            args = (fam, (m, k, n))
            t0 = time.perf_counter()
            for _ in range(reps):
                tuning.get_block_config(*args, sms=sms, route="stream")
            lookup_us = (time.perf_counter() - t0) / reps * 1e6
            t0 = time.perf_counter()
            for _ in range(reps):
                em.stream_plan(m, n, k, sms)
            plan_us = (time.perf_counter() - t0) / reps * 1e6
        finally:
            tuning.clear()
            if old is None:
                os.environ.pop("REPRO_TORCH_TUNING_CACHE", None)
            else:
                os.environ["REPRO_TORCH_TUNING_CACHE"] = old
    if not tuning.empty():
        raise AssertionError("tuning: the table is not empty after the phase")
    for name, r in out.items():
        print(f"tuning {name} {r['shape']} ({len(r['candidates'])} candidates "
              f"{[dict(c) for c in r['candidates']]}): winner {r['winner']} {r['winner_ms']:.4f} "
              f"ms through the wrapper after the reload, default {r['default']} "
              f"{r['default_ms']:.4f} ms", flush=True)
    print(f"tuning: every kernel 1 candidate's int32 accumulator equal to the default plan's; "
          f"kernel 3 err/limit (vs default at 2 TOL_BF16, vs plain at TOL_BF16) by pages a split "
          + ", ".join(f"{p}: {a:.3f} / {c:.3f}" for p, (a, c) in reads.items())
          + f"; autotune {tune_s:.2f} s; cache {sorted(saved)}; a memoised plan lookup "
          f"{lookup_us:.3f} us, stream_plan {plan_us:.3f} us (host)", flush=True)
    out.update(autotune_s=tune_s, lookup_us=lookup_us, stream_plan_us=plan_us)
    return out


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
# (q_offset > 0); a ragged, windowed D = 64 case for the route's other
# instantiation; and the prefix cache's two shapes: the peek of a fully
# cached prompt (Sq = 1 at q_offset = n - 1, not a multiple of the 64-row
# q tile) and a tail-padded suffix at a page-aligned q_offset that is not a
# multiple of the 64-column kv tile (Skv = q_offset + its bucket).  Last,
# the ring's prefill at starcoder2-15b's heads (Hq 48 over Hkv 4: G = 12):
# a 1,024-row chunk after a full ring of 4,096 (q_offset 4096) under the
# 4,096 window, with keys aligned to the queries (``align_edges``) so that
# one key more or less at a row's window edge or at its start shows.  A
# case's optional last item: {"heads": (Hq, Hkv), "aligned": True}.
FLASH_CASES = [(1, 64, 64, (12,), 0, None, 128), (1, 200, 200, (40,), 0, None, 128),
               (1, 512, 512, (102,), 0, None, 128), (1, 512, 512, (102,), 0, 128, 128),
               (3, 300, 300, (0, 150, 290), 0, None, 128),
               (1, 128, 512, (37,), 384, None, 128), (2, 200, 200, (17, 90), 0, 96, 64),
               (1, 1, 761, (0,), 760, None, 128), (1, 256, 528, (0,), 272, None, 128),
               (1, 1024, 5120, (37,), 4096, 4096, 128, dict(heads=(48, 4), aligned=True))]


def align_edges(q, k, start, q_offset, window):
    """Make the keys at a B = 1 case's mask edges carry their rows'
    weight: query row t's window edge is column e(t) = q_offset + t -
    window (the key ``window + 1`` adds), so column e(t) gets the sum of
    row t's group's queries where it lies past ``start``; the rows whose
    edge lies below ``start`` are made equal to row 0, and column
    ``start`` (the key ``start + 1`` drops from them) gets row 0's sum.
    Works on q [1, Hq, Sq, D] and k [1, Hkv, Skv, D] in place."""
    hq, sq, d = q.shape[1:]
    hkv = k.shape[1]
    edge = q_offset - window
    below = min(sq, max(0, start - edge))   # rows whose window edge lies below start
    q[0, :, :below] = q[0, :, :1]
    sums = q[0].reshape(hkv, hq // hkv, sq, d).sum(1)
    rows = [t for t in range(sq) if edge + t > start]
    k[0, :, edge + rows[0]:edge + rows[-1] + 1] = sums[:, rows[0]:rows[-1] + 1]
    k[0, :, start] = sums[:, 0]


def check_flash(torch, timer):
    """Kernel 2 at FLASH_CASES against ``masked_attention_ref``: bf16 (the
    tensor-core route) and float32 (the CUDA-core route) through
    ``attn_check``, with the planted faults start + 1 (where Sq > 1: one
    key more or less in a single row of ~760 stays within the bf16 limit),
    window + 1 and q_offset 0 (where they are set);
    query rows before their start must be exact zeros; every bf16 call one
    tensor-core launch.  Timed against the plain version and SDPA.
    Returns rows."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import ops as attn_ops
    from repro_torch.kernels.flash_attention.ref import masked_attention_ref
    kern2 = fa.flash_attention_masked
    g = torch.Generator(device=DEV).manual_seed(12)
    rows = []
    for b, sq, skv, starts, qo, window, d, *extra in FLASH_CASES:
        extra = extra[0] if extra else {}
        hq, hkv = extra.get("heads", (16, 2))
        q = torch.randn((b, hq, sq, d), generator=g, device=DEV)
        k = torch.randn((b, hkv, skv, d), generator=g, device=DEV)
        v = torch.randn((b, hkv, skv, d), generator=g, device=DEV)
        if extra.get("aligned"):
            align_edges(q, k, starts[0], qo, window)
        q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
        start = torch.tensor(starts, dtype=torch.int32, device=DEV)
        kw = dict(q_offset=qo, window=window)
        faults = {}
        if sq > 1:
            faults["start + 1"] = lambda q, k, v, st: kern2(q, k, v, st + 1, **kw)
        if qo:
            faults["q_offset 0"] = lambda q, k, v, st: kern2(q, k, v, st, q_offset=0,
                                                             window=window)
        if window:
            faults["window + 1"] = lambda q, k, v, st: kern2(
                q, k, v, st, q_offset=qo, window=window + 1)
        what = (f"flash_attention_masked B={b} Hq={hq} Hkv={hkv} Sq={sq} Skv={skv} "
                f"start={list(starts)} q_offset={qo} window={window} D={d}")
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
        bnd, by = cost_bounds(attn_ops, "flash_attention_masked", q, k, v, start,
                              **kw)["flash_attention_masked"][:2]
        print(f"kernel {what} ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"library_ms={library_ms:.4f} bound_ms={bnd:.5f} ({by}) max_abs_err={err}",
              flush=True)
        rows.append(dict(B=b, Hq=hq, Hkv=hkv, S=sq, Skv=skv, start=list(starts), q_offset=qo,
                         window=window, D=d, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                         bound_ms=bnd, bound_by=by, max_abs_err=err))
    return rows


# kernel 2's per-sequence offsets (``q_offsets``) at the speculative path's
# shapes: (name, Sq, pos per slot, start per slot); B = 8 slots, Hq 16, Hkv
# 2, D 128 over W = 576 columns (max_len: the drafter's dense rows and the
# verify's gathered pages).  Sq = 1: the drafter's decode read; Sq = 5: a
# verify burst of K + 1.  pos and start are ragged as the spec phase's
# slots (prompts of 256..512 tokens bucketed to 512, so start = 512 - n and
# pos 512..575), with one short sequence (slot 7: 4 live keys at Sq = 1),
# where one key more or less moves the output past the limit in both
# dtypes, so that the planted faults show.
OFFSET_CASES = [
    ("drafter tick", 1, (512, 530, 547, 560, 571, 515, 523, 9),
     (0, 37, 120, 251, 4, 199, 88, 6)),
    ("verify burst", 5, (512, 526, 540, 566, 519, 531, 550, 9),
     (251, 0, 12, 140, 77, 3, 210, 6)),
]


def check_flash_offsets(torch, timer):
    """Kernel 2 with per-sequence offsets at OFFSET_CASES against
    ``masked_attention_ref(q_offsets=)`` through ``attn_check`` (bf16 on the
    tensor-core route, float32 on CUDA cores), with the planted faults
    "slot 0's offset for every slot" and "offset off by one"; every call
    one offset launch.  A CUDA ``valid`` mask must still raise.  Timed
    against the plain version and SDPA with the same bool mask
    (``burst_valid``), beside its bound from the live keys.  Returns rows."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import ops as attn_ops
    from repro_torch.kernels.flash_attention.ref import masked_attention_ref
    from repro_torch.models.kv_cache import burst_valid
    kern2 = fa.flash_attention_masked
    g = torch.Generator(device=DEV).manual_seed(14)
    rows = []
    b, hq, hkv, d, w = SLOTS, 16, 2, 128, 576
    for name, sq, poss, starts in OFFSET_CASES:
        q = torch.randn((b, hq, sq, d), generator=g, device=DEV).to(torch.bfloat16)
        k = torch.randn((b, hkv, w, d), generator=g, device=DEV).to(torch.bfloat16)
        v = torch.randn((b, hkv, w, d), generator=g, device=DEV).to(torch.bfloat16)
        pos = torch.tensor(poss, dtype=torch.int32, device=DEV)
        start = torch.tensor(starts, dtype=torch.int32, device=DEV)
        faults = {
            "slot 0's offset for every slot": lambda q, k, v, st, qo: kern2(
                q, k, v, st, q_offsets=qo[:1].expand(b).contiguous()),
            "offset off by one": lambda q, k, v, st, qo: kern2(q, k, v, st, q_offsets=qo + 1)}
        what = (f"flash_attention_masked q_offsets ({name}) B={b} Sq={sq} Skv={w} "
                f"pos={list(poss)} start={list(starts)} D={d}")
        n0 = kern2.launches, kern2.offset_launches
        err = attn_check(torch, what, lambda q, k, v, st, qo: kern2(q, k, v, st, q_offsets=qo),
                         lambda q, k, v, st, qo: masked_attention_ref(q, k, v, start=st,
                                                                      q_offsets=qo),
                         (q, k, v, start, pos), faults)
        if kern2.launches - n0[0] != kern2.offset_launches - n0[1]:
            raise AssertionError(f"{what}: a call launched without its offsets")
        mask = burst_valid(pos, start, sq, w)
        try:
            attn_ops.masked_attention(q, k, v, valid=mask)
        except NotImplementedError:
            pass
        else:
            raise AssertionError("a CUDA valid mask ran without raising")
        ms = timer(lambda: kern2(q, k, v, start, q_offsets=pos))
        plain_ms = timer(lambda: masked_attention_ref(q, k, v, start=start, q_offsets=pos),
                         reps=5)
        library_ms = timer(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask[:, None], enable_gqa=True))
        bnd, by = cost_bounds(attn_ops, "flash_attention_masked", q, k, v, start,
                              q_offsets=pos)["flash_attention_masked"][:2]
        print(f"kernel {what} ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
              f"bound_ms={bnd:.5f} ({by}) max_abs_err={err}", flush=True)
        rows.append(dict(case=name, B=b, S=sq, Skv=w, pos=list(poss), start=list(starts), D=d,
                         ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bnd,
                         bound_by=by, max_abs_err=err))
    return rows


# The ring decode (the paged kernel's ring form) at the starcoder2-15b
# decode tick: B = 8 slots, Hq 48 over Hkv 4 (G = 12), D 128, a ring of W =
# 4096 rows (its window) in the stored layout [B, W, Hkv, D].  pos per
# slot on both sides of the wrap: just past it (4100: the seam between rows
# 4 and 5), exactly full (4095), before it (3000), several laps (12345) and
# between; start inside the held range on two slots (4500 of 1905..6000,
# 4990 of 905..5000: 11 live keys, on both sides of a split's edge at 896)
# and below it on one.
RING_W = 4096
RING_POS = (4100, 4095, 3000, 6000, 4600, 12345, 4160, 5000)
RING_START = (0, 0, 0, 4500, 100, 0, 0, 4990)


def check_ring_decode(torch, timer):
    """The ring decode (``ring_decode_kernel``, kernels 3 / 3b's split-KV
    body over the ring's pools in place) against its plain version
    (``ring_decode_ref``: the ring cache's own mask) through
    ``attn_check``, bf16 q (tensor cores) and float32 q (CUDA cores), with
    bf16 pools and with int8 pools + bf16 scale pools as ``quantize_kv``
    writes them; planted faults "positions read unrotated" (fault 2: row
    j as position j), "window off by one" (window W - 1) and "last split
    dropped" (fault 1), each caught in both dtypes.  Slot 0's oldest
    position (pos - W + 1, in the row after the seam) holds a key aligned
    with its group's queries, which carries most of the row's weight, so
    that dropping it shows.  Every call one launch (int8: one int8-KV
    launch); two calls bit-identical.  Timed against the plain version,
    SDPA with the same bool mask on ``[B, Hkv, W, D]`` (bf16 pools) and
    the bytes bound (each live row read once).  Returns rows, bf16 pools
    first."""
    import torch.nn.functional as F
    from repro_torch.kernels._build import sm_count
    from repro_torch.kernels.flash_attention.ref import ring_valid
    from repro_torch.kernels.paged_attention import ops as paged_ops
    from repro_torch.kernels.paged_attention.paged_attention import (ring_decode_kernel,
                                                                     ring_split_plan)
    from repro_torch.kernels.paged_attention.ref import ring_decode_ref
    from repro_torch.models.kv_cache import quantize_kv
    g = torch.Generator(device=DEV).manual_seed(15)
    b, hq, hkv, d, w = SLOTS, 48, 4, 128, RING_W
    q = torch.randn((b, hq, 1, d), generator=g, device=DEV)
    k = torch.randn((b, w, hkv, d), generator=g, device=DEV)
    v = torch.randn((b, w, hkv, d), generator=g, device=DEV)
    k[0, (RING_POS[0] + 1) % w] = q[0, :, 0].reshape(hkv, hq // hkv, d).sum(1)
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    pos = torch.tensor(RING_POS, dtype=torch.int32, device=DEV)
    start = torch.tensor(RING_START, dtype=torch.int32, device=DEV)
    rows_a_split, splits = ring_split_plan(b, hkv, w, sm_count(q.device))
    mask = ring_valid(pos, start, w, w)
    live = int(mask.sum())   # ring rows a slot attends, summed over the slots

    def kernel(q, k, v, st, p, *sc, window=w, fault=0):
        return ring_decode_kernel(q, k, v, p, st, *sc, window=window, fault=fault)

    def plain(q, k, v, st, p, *sc):
        return ring_decode_ref(q, k, v, p, st, *sc, window=w)

    faults = {"positions read unrotated (fault 2)": lambda *a: kernel(*a, fault=2),
              "window off by one": lambda *a: kernel(*a, window=w - 1),
              "last split dropped (fault 1)": lambda *a: kernel(*a, fault=1)}
    rows = []
    for int8_kv in (False, True):
        scales = ()
        kp, vp = k, v
        if int8_kv:
            (kp, ks), (vp, vs) = quantize_kv(k), quantize_kv(v)
            scales = (ks, vs)
        name = "ring_decode_attention" + ("[int8_kv]" if int8_kv else "")
        what = (f"{name} B={b} Hq={hq} Hkv={hkv} W={w} pos={list(RING_POS)} "
                f"start={list(RING_START)} D={d}")
        n0 = ring_decode_kernel.launches, ring_decode_kernel.int8_kv_launches
        operands = (q, kp, vp, start, pos, *scales)
        err = attn_check(torch, what, kernel, plain, operands, faults)
        n = (ring_decode_kernel.launches - n0[0], ring_decode_kernel.int8_kv_launches - n0[1])
        if n != (8, 8 * int8_kv):   # 2 dtypes x (the check, 3 faults)
            raise AssertionError(f"{what}: launches {n}, expected 8, all int8-KV or none")
        for dt in (torch.bfloat16, torch.float32):   # the same inputs, the same bits
            ops = [t.to(dt) if t.is_floating_point() else t for t in (q, kp, vp)]
            if not torch.equal(kernel(*ops, start, pos, *scales),
                               kernel(*ops, start, pos, *scales)):
                raise AssertionError(f"{what} {dt}: two calls on the same inputs differ")
        ms = timer(lambda: kernel(*operands))
        plain_ms = timer(lambda: plain(*operands), reps=5)
        library_ms = None
        if not int8_kv:   # SDPA over the rows in [B, Hkv, W, D], the bool mask
            kt, vt = (t.transpose(1, 2).contiguous() for t in (k, v))
            library_ms = timer(lambda: F.scaled_dot_product_attention(
                q, kt, vt, attn_mask=mask[:, None, None, :], enable_gqa=True))
            del kt, vt
        bnd, by = cost_bounds(paged_ops, "ring_decode_kernel", q, kp, vp, pos, start, *scales,
                              window=w)["ring_decode_attention"][:2]
        print(f"kernel {what} split {rows_a_split} rows x {splits} ({b * hkv * splits} blocks) "
              f"live_rows={live} ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"library_ms={'None' if library_ms is None else f'{library_ms:.4f}'} "
              f"bound_ms={bnd:.5f} ({by}) max_abs_err={err}; two calls bit-identical",
              flush=True)
        rows.append(dict(case="ring tick", kv="int8" if int8_kv else "bf16", B=b, Hq=hq,
                         Hkv=hkv, W=w, pos=list(RING_POS), start=list(RING_START), D=d,
                         rows_a_split=rows_a_split, splits=splits, live_rows=live, ms=ms,
                         plain_ms=plain_ms, library_ms=library_ms, bound_ms=bnd, bound_by=by,
                         max_abs_err=err))
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


def live_pages(torch, table, pos, start, page):
    """Pages of one call that are non-null and meet [start, pos]."""
    b, pps = table.shape
    cols = torch.arange(pps * page, device=DEV)[None, :]
    mapped = torch.repeat_interleave(table != 0, page, dim=1)
    valid = mapped & (cols <= pos[:, None]) & (cols >= start[:, None])
    return int(valid.reshape(b, pps, page).any(-1).sum())


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
    from repro_torch.kernels.paged_attention import ops as paged_ops
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
        bnd, by = cost_bounds(paged_ops, "paged_attention_kernel", q, kp, vp, table, pos, start,
                              *scales, page_size=page)["paged_attention_kernel"][:2]
        n_live = live_pages(torch, table, pos, start, page)
        print(f"kernel {name} [{case}] B={b} Hq={hq} Hkv={hkv} D={d} page={page} pps={pps} "
              f"split {pages} pages x {splits} ({b * hkv * splits} blocks) "
              f"live_pages={n_live} ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms=None "
              f"bound_ms={bnd:.5f} ({by}) max_abs_err={err}; two calls bit-identical",
              flush=True)
        rows.append(dict(case=case, B=b, Hq=hq, Hkv=hkv, D=d, page=page, pps=pps,
                         pages_a_split=pages, splits=splits, live_pages=n_live, ms=ms,
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
    from repro_torch.kernels.flash_attention import ops as attn_ops
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
        bounds = {**cost_bounds(attn_ops, "flash_attention", qb, kb, vb, **fw),
                  **cost_bounds(attn_ops, "flash_attention_bwd", qb, kb, vb, o, lse, dob, **fw)}
        cases = {   # name -> (kernel, plain, library)
            "flash_attention": (lambda: flash_attention(qb, kb, vb, **fw),
                                lambda: flash_attention_ref(qb, kb, vb, **fw), lib_fwd,
                                err_f),
            "flash_attention_bwd_dkdv": (
                lambda: flash_attention_bwd_dkdv(qb, kb, vb, o, lse, dob, delta=delta,
                                                 **fw), None, lib_bwd, err_b),
            "flash_attention_bwd_dq": (
                lambda: flash_attention_bwd_dq(qb, kb, vb, o, lse, dob, **fw), None,
                lib_bwd, err_b),
        }
        for name, (kern, plain, lib_ms, err) in cases.items():
            ms = timer(kern)
            plain_ms = timer(plain, reps=3) if plain is not None else plain_bwd
            bnd, by = bounds[name][:2]
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
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
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
    # each input read once, each output written once, float32; the causal
    # half of the [Q, Q] chunk products (the pairs j <= i this run's data
    # needs) plus the [Q, P, N] state products
    bounds = {**cost_bounds(ssd_ops, "ssd_scan", x, dt, a, bm, cm, chunk=q),
              **cost_bounds(ssd_ops, "ssd_scan_bwd", x, dt, a, bm, cm, h0s, dy, chunk=q)}
    card = card_line()
    for name, (kern, plain) in cases.items():
        ms = timer(kern)
        plain_ms = timer(plain, reps=3)
        bnd, by, passes, nbytes = bounds[name]
        flops = passes["bf16"] // ssd_ops.SPLIT_PASSES
        f32_bnd, f32_by = bound_ms(nbytes, {"f32": flops})
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


# row 8p at mamba2-370m's serving shapes (B, H, P, G, N, chunk) with (L,
# left pads): a 512-token admission of a 475-token prompt, a chunked
# admission's 128-row chunk entered from a non-zero state, and an unpadded
# 300-token prompt (a drafter's shadow prefill), which 8p left-pads to 384
SSD_PREFILL_SHAPE = (1, 32, 64, 1, 128, 128)
SSD_PREFILL_CASES = ((512, 37), (128, 0), (300, 0))
SSD_PREFILL_OUT = ("y", "h_final")
SSD_PREFILL_FAULTS = {5: "entering state ignored", 6: "leaving state of the last-but-one chunk",
                      7: "pad rows decay the state (the wrapper's dt mask off)"}


def check_ssd_prefill(torch, timer):
    """Row 8p (``ssd_prefill``, kernel 8's prefill form) at SSD_PREFILL_CASES,
    float32, from a random non-zero entering state: y and the leaving state
    against the plain version (``ssd_prefill_ref`` on the operands the
    wrapper prepares, ``prefill_operands``), per element within (TOL_F32 +
    E) units, the units and E derived as ``ssd_units`` derives kernel 8's:
    the plain version on |x|, |B|, |C|, |h_init| is each output's unit, E
    = 8 Q 2^-24 |cum|max per (row, head).  The planted faults (5 and 6 in
    the carry, 7 the wrapper's pad mask, at the padded case) must read
    above 1.  Each case timed (the wrapper as the model calls it, CUDA
    events, L2 flushed) beside its plain version and its bound: bytes
    (x, dt, a, B, C, h_init read once, y and h_final written once) at the
    HBM rate against its flops as three bf16 passes at the tensor-core
    peak.  No PyTorch call computes it: library_ms is None.  Returns
    rows."""
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan.ref import _chunk_operands, ssd_prefill_ref
    from repro_torch.kernels.ssd_scan.ssd_scan import prefill_operands, ssd_prefill
    gen = torch.Generator(device=DEV).manual_seed(28)
    bsz, h, p, g, n, chunk = SSD_PREFILL_SHAPE
    card = card_line()
    rows = []
    for l, pads in SSD_PREFILL_CASES:
        tag = f"B={bsz} L={l} H={h} P={p} G={g} N={n} chunk={chunk} left pads={pads}"
        x, dt, a, bm, cm, _ = ssd_inputs(torch, gen, (bsz, l, h, p, g, n, chunk))
        h0 = torch.randn((bsz, h, p, n), generator=gen, device=DEV)
        mask = (torch.arange(l, device=DEV) >= pads)[None].expand(bsz, l).contiguous() \
            if pads else None
        xp, dtp, bp, cp, pad, q = prefill_operands(x, dt, bm, cm, mask, chunk)

        def plain():
            y, hf = ssd_prefill_ref(xp, dtp, a, bp, cp, h0, q)
            return y[:, pad:], hf

        want = plain()
        uy, uh = ssd_prefill_ref(xp.abs(), dtp, a, bp.abs(), cp.abs(), h0.abs(), q)
        units = dict(y=uy[:, pad:], h_final=uh)
        cum = _chunk_operands(xp, dtp, a, bp, cp, q)[4]                  # [B, nc, Q, H]
        e = 8 * q * 2.0**-24 * cum.abs().amax(dim=(1, 2))                  # [B, H]
        slack = dict(y=e[:, None, :, None], h_final=e[:, :, None, None])

        def call(fault=0):
            return ssd_prefill(x, dt, a, bm, cm, h0, mask=mask, chunk=chunk, fault=fault)

        before = (ssd_prefill.launches, *(getattr(ssd_prefill, f"{part}_launches")
                                          for part in SSD_FWD_PARTS))
        got = call()
        torch.cuda.synchronize()
        after = (ssd_prefill.launches, *(getattr(ssd_prefill, f"{part}_launches")
                                         for part in SSD_FWD_PARTS))
        if tuple(b - a for a, b in zip(before, after)) != (1, 1, 1, 1):
            raise AssertionError(f"ssd_prefill {tag}: not one call of three launches")
        if not all(torch.isfinite(t).all() for t in got) or got[1].shape != h0.shape:
            raise AssertionError(f"ssd_prefill {tag}: non-finite output or a wrong shape")
        reading = ssd_reading(got, want, units, slack, SSD_PREFILL_OUT)
        err = max(float((u - v).abs().max()) for u, v in zip(got, want))
        faults = {SSD_PREFILL_FAULTS[f]: ssd_reading(call(f), want, units, slack, SSD_PREFILL_OUT)
                  for f in ((5, 6, 7) if pads else (5, 6))}
        ms = timer(call)
        plain_ms = timer(plain, reps=3)
        bnd, by, passes, nbytes = cost_bounds(ssd_ops, "ssd_prefill", x, dt, a, bm, cm, h0,
                                              mask=mask, chunk=chunk)["ssd_prefill"]
        flops = passes["bf16"] // ssd_ops.SPLIT_PASSES
        print(f"kernel ssd_prefill {tag} ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms=None "
              f"bound_ms={bnd:.5f} ({by}; {nbytes:.4e} bytes, {flops:.4e} flops x3 bf16 passes) "
              f"max_abs_err={err:.3e}; err/limit {reading:.3f} (y and the leaving state); "
              + "; ".join(f"planted fault '{k}': {v:.1f}" for k, v in faults.items())
              + f" [{card}]", flush=True)
        if reading > 1:
            raise AssertionError(f"ssd_prefill {tag}: the kernel disagrees with its plain "
                                 f"version ({reading} of the limit)")
        missed = [k for k, v in faults.items() if v <= 1]
        if missed:
            raise AssertionError(f"ssd_prefill {tag}: the limits miss planted faults {missed}")
        rows.append(dict(shape=tag, reading=reading, faults=faults, max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, library_ms=None, bound_ms=bnd, bound_by=by))
        del x, dt, bm, cm, h0, xp, dtp, bp, cp, want, units, got
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
    from repro_torch.kernels.paged_attention.paged_attention import (paged_attention_kernel,
                                                                     ring_decode_kernel)
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan.ssd_scan import (ssd_prefill, ssd_scan,
                                                       ssd_scan_bwd_chunk, ssd_scan_bwd_state)
    kernels = (ent_matmul_packed_fused, flash_attention_masked, paged_attention_kernel,
               ring_decode_kernel, int8_matmul, ent_matmul, ent_matmul_packed, flash_attention,
               flash_attention_bwd_dkdv, flash_attention_bwd_dq, ssd_scan,
               ssd_scan_bwd_state, ssd_scan_bwd_chunk, ssd_prefill)
    plains = (ent_ops.ent_quantized_matmul_fused, ent_ops.ent_quantized_matmul,
              ent_ops.ent_quantized_matmul_packed, int8_ops.quantized_matmul,
              attn_ops.masked_attention, paged_ops.paged_attention, paged_ops.ring_attention,
              attn_ops.attention, ssd_ops.ssd)
    return kernels, plains, (paged_attention_kernel, ring_decode_kernel)


def reset_counts(torch):
    kernels, plains, decode = wrappers(torch)
    for f in kernels:
        f.launches = 0
        for route in ("tc_launches", "stream_launches", "offset_launches",
                      *(f"{part}_launches" for part in SSD_FWD_PARTS + SSD_BWD_STATE_PARTS)):
            if hasattr(f, route):
                setattr(f, route, 0)
    for f in decode:
        f.int8_kv_launches = 0
    for f in plains:
        f.plain_launches = 0


def read_counts(torch):
    """(kernel launches by JSON name, by ``ssd_scan[<part>]`` and
    ``ssd_prefill[<part>]`` each of the three launches of kernel 8 and of
    its prefill form 8p and by ``ssd_scan_bwd_state[<part>]`` each of 8b's
    two; the paged decode and its ring form (``ring_decode_attention``)
    apart from their int8-KV launches; plain versions run by op name)."""
    from repro_torch.kernels.ssd_scan.ssd_scan import ssd_prefill, ssd_scan, ssd_scan_bwd_state
    kernels, plains, (paged, ring) = wrappers(torch)
    launches = {f.__name__: f.launches for f in kernels}
    del launches[ring.__name__]
    launches["paged_attention_kernel"] = paged.launches - paged.int8_kv_launches
    launches["paged_attention_kernel[int8_kv]"] = paged.int8_kv_launches
    launches["ring_decode_attention"] = ring.launches - ring.int8_kv_launches
    launches["ring_decode_attention[int8_kv]"] = ring.int8_kv_launches
    for part in SSD_FWD_PARTS:
        launches[f"ssd_scan[{part}]"] = getattr(ssd_scan, f"{part}_launches")
        launches[f"ssd_prefill[{part}]"] = getattr(ssd_prefill, f"{part}_launches")
    for part in SSD_BWD_STATE_PARTS:
        launches[f"ssd_scan_bwd_state[{part}]"] = getattr(ssd_scan_bwd_state, f"{part}_launches")
    return launches, {f.__name__: f.plain_launches for f in plains}


def read_offset_launches(torch):
    """Kernel 2's launches with per-sequence offsets (``q_offsets``)."""
    from repro_torch.kernels.flash_attention.flash_attention import flash_attention_masked
    return flash_attention_masked.offset_launches


def read_ring_launches(torch):
    """The ring decode's launches (``ring_decode_kernel``, bf16 and int8
    KV)."""
    from repro_torch.kernels.paged_attention.paged_attention import ring_decode_kernel
    return ring_decode_kernel.launches


def read_tc_counts(torch):
    """Tensor-core launches of the kernels with two routes (2, 7, 7b, 7c),
    by JSON name; the rest of their ``launches`` took the CUDA-core route."""
    return {f.__name__: f.tc_launches for f in wrappers(torch)[0] if hasattr(f, "tc_launches")}


def read_matmul_routes(torch):
    """Launches of kernels 1, 6, 5 and 4 by route: {"<name>[stream]": n,
    "<name>[tc]": n}, which sum to their ``launches``."""
    from repro_torch.kernels.ent_matmul.ent_matmul import (ent_matmul, ent_matmul_packed,
                                                           ent_matmul_packed_fused)
    from repro_torch.kernels.int8_matmul.int8_matmul import int8_matmul
    return {f"{f.__name__}[{r}]": getattr(f, f"{r}_launches")
            for f in (ent_matmul_packed_fused, int8_matmul, ent_matmul, ent_matmul_packed)
            for r in ("stream", "tc")}


TRAIN_KERNELS = ("flash_attention", "flash_attention_bwd_dkdv", "flash_attention_bwd_dq")
# the serving configurations chip_smoke runs at full width: name ->
# (launch.build keyword arguments, kernels that must launch, kernels that
# must not)
RING_KERNELS = ("ring_decode_attention", "ring_decode_attention[int8_kv]")
SERVE_CONFIGS = {
    "EN-T w8a8, bf16 KV": (
        dict(quantize=True),
        ("ent_matmul_packed_fused", "flash_attention_masked", "paged_attention_kernel"),
        ("int8_matmul", "paged_attention_kernel[int8_kv]", *RING_KERNELS, *TRAIN_KERNELS,
         *SSD_KERNELS, "ssd_prefill")),
    "w8a8 int8, int8 KV": (
        dict(quant="int8", kv_quant=True),
        ("int8_matmul", "flash_attention_masked", "paged_attention_kernel[int8_kv]"),
        ("ent_matmul_packed_fused", "paged_attention_kernel", *RING_KERNELS, *TRAIN_KERNELS,
         *SSD_KERNELS, "ssd_prefill")),
}


def build_kw(kw):
    from repro_torch.configs.base import QuantConfig
    if kw.get("quant") == "int8":   # the plain int8 records of launch/specs.py:111-113
        kw = dict(kw, quant=QuantConfig(enabled=True, ent_encode=False))
    return kw


@contextlib.contextmanager
def emitted_rows(engine, rows):
    """While inside, ``rows[(uid, i)]`` <- the logits row that token i of
    request ``uid`` was sampled from: its admission prefill's, its decode
    tick's, or its verify burst's (burst position i - e0, e0 the slot's
    tokens before the tick).  Rows are views of the logits the engine
    computed anyway: nothing is launched for them."""
    model, last = engine.model, {}

    def wrap(name):
        real = getattr(model, name)

        def f(*a, **kw):
            out = real(*a, **kw)
            last.update(kind=name, logits=out[0],
                        e0={s: len(st.emitted) for s, st in engine._active.items()})
            return out
        return f

    real_emit = engine._emit

    def emit(slot, tok):
        st = engine._active[slot]
        i, lg = len(st.emitted), last["logits"]
        rows[(st.req.uid, i)] = (lg[0] if last["kind"] == "prefill" else lg[slot]
                                 if last["kind"] == "decode_step" else
                                 lg[slot, i - last["e0"][slot]])
        return real_emit(slot, tok)

    names = ("prefill", "decode_step", "verify_step")
    saved = {n: model.__dict__[n] for n in names if n in model.__dict__}
    for name in names:
        setattr(model, name, wrap(name))
    engine._emit = emit
    try:
        yield
    finally:
        for name in names:
            delattr(model, name)
        model.__dict__.update(saved)   # an enclosing wrapper's, when there is one
        del engine._emit


def serve_full_width(torch, config):
    """Serve 16 ragged greedy requests on full-width qwen2.5-3b in one of
    SERVE_CONFIGS; every kernel of its path must launch (counts set to 0
    just before the run and read just after), no other serving kernel
    and no plain version may; then profile decode ticks and one admission
    prefill.  Returns (launches, tokens/s, launches by route, the prefill's
    profile, the decode tick's matmul ms by route, the streams, the emitted
    rows, the decode tick's host-clock and busy ms)."""
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
    rows = {}   # the logits each token came from (the spec phase's near-tie check)
    reset_counts(torch)
    with emitted_rows(engine, rows) if "EN-T" in config else contextlib.nullcontext():
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
    tick_routes, tick = profile_decode_ticks(torch, engine, prompts[:SLOTS], cfg, config)
    prefill = profile_prefill(torch, engine, max(prompts, key=len), cfg, config)
    del engine, params, model
    torch.cuda.empty_cache()
    return launches, toks / dt, routes, prefill, tick_routes, results, rows, tick


def projections(cfg):
    """Quantized projections a layer: q, k, v, o and the MLP's (up, down;
    gate too when gated)."""
    return 4 + (3 if cfg.mlp_type == "swiglu" else 2)


SLOTS = 8         # the serving engine's slots: a full decode tick's M


PREFIX = 256      # the shared-prefix phase's common prefix: 16 pages of 16 tokens
SUFFIX = 200      # its profiled admission's unshared suffix


def serve_shared_prefix(torch):
    """Serve with prefix sharing on full-width qwen2.5-3b, EN-T, bf16 KV:
    the serve phase's 16 ragged greedy requests (seed 0) each behind one
    seeded PREFIX-token prefix, then two requests made of the full pages of
    the last two prompts (still decoding when these arrive, so their pages
    are pinned and cached: the full-match peek); 32 new tokens each, 8 slots, 16-token pages, max_len
    576 + PREFIX, ``prefix_cache="auto"``.  Asserts that every request
    returns 32 tokens, every admission after the first maps the PREFIX / 16
    shared pages, a peek ran, kernels 1, 2 and 3 launched (kernel 1 on the
    stream at every tick and peek, on the tensor-core loop at every suffix
    prefill), no plain version ran, and ``check_leaks`` passes.  Then one
    suffix prefill (SUFFIX tokens over the cached prefix) and the unshared
    admission of the same prompt (another engine, ``prefix_cache=False``),
    each unprofiled (host clock) and profiled (device time by kernel).
    Returns (launches, tokens/s, prefix stats, the two admissions)."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as launch
    from repro_torch.runtime.serve_loop import ServeEngine

    cfg = get_config("qwen2.5-3b")
    model, params = launch.build(cfg, seed=0, quantize=True)
    max_len = 576 + PREFIX
    engine = ServeEngine(model, params, slots=SLOTS, max_len=max_len, page_size=16,
                         prefix_cache="auto", seed=0)
    prefix = np.random.default_rng(1).integers(0, cfg.vocab_size, PREFIX).tolist()
    prompts = [prefix + p for p in launch.ragged_prompts(np.random.default_rng(0), 16, 256, 512,
                                                         cfg.vocab_size)]
    prompts += [p[:len(p) // 16 * 16] for p in prompts[-2:]]
    mapped, peeks = [], []
    map_prefix, peek = engine._map_prefix, engine._peek

    def counted_map(slot, req):
        pos0 = map_prefix(slot, req)
        if pos0 is not None:
            mapped.append(len(engine._slot_shared[slot]))
        return pos0

    def counted_peek(*a):
        peeks.append(a[-1])
        return peek(*a)
    engine._map_prefix, engine._peek = counted_map, counted_peek
    reset_counts(torch)
    results, dt = launch.serve(engine, prompts, max_new_tokens=32)
    launches, plain_runs = read_counts(torch)
    routes = {"flash_attention_masked[tensor-core]": read_tc_counts(torch)[
        "flash_attention_masked"], **read_matmul_routes(torch)}
    engine.check_leaks()
    stats = engine.prefix_stats
    n = len(prompts)
    if sorted(results) != list(range(n)) or any(len(v) != 32 for v in results.values()):
        raise AssertionError(f"shared prefix: {len(results)} results, lengths "
                             f"{sorted(len(v) for v in results.values())}")
    if len(mapped) != n or mapped[0] != 0 or min(mapped[1:]) < PREFIX // 16:
        raise AssertionError(f"shared prefix: shared pages mapped by admission {mapped}")
    if not peeks:
        raise AssertionError("shared prefix: no full-match peek ran")
    if any(launches[k] < 1 for k in ("ent_matmul_packed_fused", "flash_attention_masked",
                                     "paged_attention_kernel")):
        raise AssertionError(f"shared prefix: a kernel of the path never launched: {launches}")
    if any(plain_runs.values()):
        raise AssertionError(f"shared prefix: plain versions ran on the path: {plain_runs}")
    per = projections(cfg) * cfg.num_layers
    ticks = launches["paged_attention_kernel"] // cfg.num_layers
    want = {"paged_attention_kernel": cfg.num_layers * ticks,
            "flash_attention_masked": cfg.num_layers * n,
            "flash_attention_masked[tensor-core]": cfg.num_layers * n,
            "ent_matmul_packed_fused[stream]": per * (ticks + len(peeks)),
            "ent_matmul_packed_fused[tc]": per * (n - len(peeks))}
    got = {k: {**launches, **routes}[k] for k in want}
    if got != want:
        raise AssertionError(f"shared prefix: launches {got}, expected {want} ({ticks} ticks, "
                             f"{n} admissions, {len(peeks)} peeks)")
    toks = sum(len(v) for v in results.values())
    print(f"serve [EN-T w8a8, bf16 KV, shared prefix]: {n} requests ({PREFIX}-token prefix + "
          f"{min(map(len, prompts)) - PREFIX}..{max(map(len, prompts)) - PREFIX} tokens) x 32 new "
          f"tokens on 8 slots: {toks} tokens in {dt:.3f}s = {toks / dt:.2f} tok/s; shared pages "
          f"mapped by admission {mapped}; {len(peeks)} peeks (at positions {peeks}); prefix "
          f"stats {stats}; copy-on-write copies {stats['cow_copies']}; page stats "
          f"{engine.page_stats}; decode ticks {ticks}; launches {got}", flush=True)

    # one suffix prefill beside the unshared admission of the same prompt
    rng = np.random.default_rng(3)
    suffixes = [rng.integers(0, cfg.vocab_size, SUFFIX).tolist() for _ in range(2)]
    unshared = ServeEngine(model, params, slots=SLOTS, max_len=max_len, page_size=16,
                           prefix_cache=False, seed=0)
    admissions = {}
    for label, eng in (("suffix prefill over the cached prefix", engine),
                       ("unshared admission", unshared)):
        runs = {}
        for profiled, sfx in zip((False, True), suffixes):
            runs[profiled] = admit_profiled(torch, eng, prefix + sfx, profiled)
            eng.run()
        host, busy, dev = runs[False][0], runs[True][1], runs[True][2]
        admissions[label] = dict(host_ms=host, busy_ms=busy, by_kernel=dev)
        print(f"{label} ({PREFIX} + {SUFFIX} tokens, full width): {host:.3f} ms host-clock "
              f"({runs[True][0]:.3f} ms under the profiler); device busy {busy:.3f} ms "
              + (f"({100 * (1 - busy / host):.1f}% idle)" if busy else "(not measured)"),
              flush=True)
        for name, ms in list(dev.items())[:10]:
            print(f"  {ms:9.3f} ms/admission  {name[:90]}")
        eng.check_leaks()
    del engine, unshared, params, model
    torch.cuda.empty_cache()
    return launches, toks / dt, stats, admissions


SPEC_K = 4        # the speculative phase's drafts a tick


def spec_drafters(cfg, model, params):
    """The speculative phase's two drafters: arm -> (draft model, params).
    "weight-shared": the target itself (the reference CLI's same-arch
    pairing); "truncated (layer 0)": the target's own first layer with the
    shared embedding, final norm and LM head (the reference benchmark's
    drafter)."""
    from repro_torch.models.transformer import Model
    one = Model(dataclasses.replace(cfg, num_layers=1), device=model.device)
    head = {k: v for k, v in params.items() if k != "layers"}
    return {"weight-shared": (model, params),
            "truncated (layer 0)": (one, dict(head, layers=params["layers"][:1]))}


def flip_margins(plain_rows, spec_rows, plain_streams, streams):
    """At each stream's first divergence from plain decode: the plain
    path's top-1 minus top-2 logit, the plain logit of its token minus that
    of the token the speculative path emitted, and the largest |logit
    difference| between the two paths there; against the largest |logit
    difference| over the positions before every divergence (the same
    prefix read through kernel 3 in plain decode and through kernel 2 in
    the verify).  A flip whose gap exceeds twice that is not a near-tie:
    a fault.  Returns (flips, the prefix positions' largest difference)."""
    ordinary, flips = 0.0, []
    for u in sorted(streams):
        i = first_difference(streams[u], plain_streams[u])
        for j in range(i):
            ordinary = max(ordinary, float((plain_rows[(u, j)] - spec_rows[(u, j)]).abs().max()))
        if i == len(streams[u]):
            continue
        p, sp = plain_rows[(u, i)].float(), spec_rows[(u, i)].float()
        top = p.topk(2).values
        a, b = plain_streams[u][i], streams[u][i]
        flips.append(dict(uid=u, index=i, top1_minus_top2=float(top[0] - top[1]),
                          gap=float(p[a] - p[b]), delta=float((p - sp).abs().max())))
    for f in flips:
        f["fault"] = f["gap"] > 2 * ordinary
    return flips, ordinary


def serve_spec(torch, plain_streams, plain_tok_s, model, params, plain_rows):
    """Speculative decoding on full-width qwen2.5-3b, EN-T, bf16 KV: the EN-T
    serve phase's 16 ragged greedy prompts, 32 new tokens each, 8 slots,
    plain paged admission (``prefix_cache=False``), k = SPEC_K, with each
    drafter of ``spec_drafters``.  Counts set to 0 just before each run and
    read just after must show, per spec tick T and admission A: kernel 1
    once per projection and layer on the split-K stream for each of the
    K + 1 drafter steps, and on the tensor-core loop for the verify (M = 8
    (K + 1) = 40) and for both prefills of each admission; kernel 2 with
    per-sequence offsets once per layer for each drafter step and the
    verify, all on the tensor-core route, and plainly once per layer of
    both prefills; kernel 3 never; no plain version.  ``check_leaks``
    passes, and the weight-shared arm accepts >= 0.95 of its drafts.
    Counts the streams equal to the plain EN-T phase's (with the token
    where each first differs) and to the earlier arm's, and profiles one
    spec tick (``profile_spec_tick``).  ``model`` / ``params``: full-width
    qwen2.5-3b EN-T, built once for this phase and the scheduler phase.
    Returns {arm: numbers}."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as launch
    from repro_torch.runtime.serve_loop import ServeEngine

    cfg = get_config("qwen2.5-3b")
    prompts = launch.ragged_prompts(np.random.default_rng(0), 16, 256, 512, cfg.vocab_size)
    arms = {}
    for arm, (dm, dp) in spec_drafters(cfg, model, params).items():
        engine = ServeEngine(model, params, slots=SLOTS, max_len=576, page_size=16,
                             prefix_cache=False, seed=0, draft_model=dm, draft_params=dp,
                             spec_k=SPEC_K)
        rows = {}
        reset_counts(torch)
        with emitted_rows(engine, rows) if arm == "weight-shared" else contextlib.nullcontext():
            results, dt = launch.serve(engine, prompts, max_new_tokens=32)
        launches, plain_runs = read_counts(torch)
        got = {**launches, **read_matmul_routes(torch),
               "flash_attention_masked[offsets]": read_offset_launches(torch),
               "flash_attention_masked[tensor-core]": read_tc_counts(torch)[
                   "flash_attention_masked"]}
        engine.check_leaks()
        if sorted(results) != list(range(16)) or any(len(v) != 32 for v in results.values()):
            raise AssertionError(f"spec [{arm}]: {len(results)} results, lengths "
                                 f"{sorted(len(v) for v in results.values())}")
        st, rate = dict(engine.spec_stats), engine.acceptance_rate
        ticks, adm, nl, dl = st["ticks"], len(prompts), cfg.num_layers, dm.cfg.num_layers
        offsets = (nl + (SPEC_K + 1) * dl) * ticks
        want = {"ent_matmul_packed_fused[stream]": (SPEC_K + 1) * projections(cfg) * dl * ticks,
                "ent_matmul_packed_fused[tc]": projections(cfg) * (nl * ticks + (nl + dl) * adm),
                "flash_attention_masked": offsets + (nl + dl) * adm,
                "flash_attention_masked[tensor-core]": offsets + (nl + dl) * adm,
                "flash_attention_masked[offsets]": offsets,
                "paged_attention_kernel": 0, "paged_attention_kernel[int8_kv]": 0}
        seen = {k: got[k] for k in want}
        if seen != want:
            raise AssertionError(f"spec [{arm}]: launches {seen}, expected {want} ({ticks} "
                                 f"spec ticks, {adm} admissions)")
        if any(plain_runs.values()):
            raise AssertionError(f"spec [{arm}]: plain versions ran on the path: {plain_runs}")
        if arm == "weight-shared" and rate < 0.95:
            raise AssertionError(f"spec [{arm}]: acceptance {rate} < 0.95")
        toks = sum(len(v) for v in results.values())
        same = sum(results[u] == plain_streams[u] for u in results)
        first = [first_difference(results[u], plain_streams[u]) for u in sorted(results)]
        arms_same = {a: sum(results[u] == r["streams"][u] for u in results)
                     for a, r in arms.items()}
        per_slot = st["emitted"] / (st["drafted"] / SPEC_K)   # an active slot's a tick
        print(f"serve [EN-T w8a8, bf16 KV, speculative k={SPEC_K}, {arm} drafter]: 16 "
              f"requests x 32 new tokens on 8 slots: {toks} tokens in {dt:.3f}s = "
              f"{toks / dt:.2f} tok/s ({toks / dt / plain_tok_s:.3f} of the plain EN-T phase's "
              f"{plain_tok_s:.2f}); acceptance {rate:.4f}; spec stats {st}; "
              f"{st['emitted'] / ticks:.3f} tokens a tick ({per_slot:.3f} an active slot); streams "
              f"equal to the plain EN-T phase's: {same} of 16 (first differing token of each: "
              f"{first}); equal to the other arms': {arms_same}; launches {seen}", flush=True)
        near_ties = None
        if rows:
            flips, ordinary = flip_margins(plain_rows, rows, plain_streams, results)
            faults = [f for f in flips if f["fault"]]
            print(f"  spec [{arm}]: at each stream's first divergence from plain decode, plain "
                  "top-1 minus top-2 / plain gap to the emitted token / |logit difference| "
                  "between the paths: "
                  + "; ".join(f"uid {f['uid']} token {f['index']}: {f['top1_minus_top2']:.4f} / "
                              f"{f['gap']:.4f} / {f['delta']:.4f}" for f in flips)
                  + f"; the paths' largest |logit difference| before any divergence "
                  f"{ordinary:.4f}; flips above twice it (faults): {len(faults)} of "
                  f"{len(flips)}", flush=True)
            near_ties = dict(flips=flips, ordinary_delta=ordinary, faults=len(faults))
            rows.clear()
        tick = profile_spec_tick(torch, engine, prompts[:SLOTS], arm)
        arms[arm] = dict(tok_s=toks / dt, of_plain=toks / dt / plain_tok_s, acceptance=rate,
                         near_ties=near_ties,
                         stats=st, tokens_per_tick=st["emitted"] / ticks,
                         tokens_per_slot_tick=per_slot,
                         streams_equal_plain=same, first_difference=first,
                         streams_equal_arms=arms_same, streams=results, launches=got,
                         tick=tick)
        del engine
    torch.cuda.empty_cache()
    return arms


def first_difference(a, b):
    """Index of the first token where streams ``a`` and ``b`` differ (their
    length when equal)."""
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), len(a))


def profile_spec_tick(torch, engine, prompts, arm):
    """Where a full-batch spec tick's time goes: fill the 8 slots, then one
    tick on the host clock; one with its parts timed (the K + 1 drafter
    steps and the verify, each synchronised; the verify's page gathers,
    ``verify_view``, between CUDA events); one under torch.profiler (device
    busy and time by kernel).  Returns the numbers."""
    from torch.profiler import ProfilerActivity, profile

    for p in prompts:
        engine.submit(p, max_new_tokens=40)
    engine.step()                      # admits all 8 (prefills) + 1 spec tick
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.step()
    torch.cuda.synchronize()
    host = (time.perf_counter() - t0) * 1e3
    parts = {"drafter steps": 0.0, "verify": 0.0}
    events = []

    def timed(fn, part):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            parts[part] += (time.perf_counter() - t) * 1e3
            return out
        return run

    def evented(fn):
        def run(*a, **kw):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            out = fn(*a, **kw)
            e.record()
            events.append((s, e))
            return out
        return run

    dm, tm = engine.draft_model, engine.model
    layers = engine.cache["layers"]
    dm.decode_step = timed(dm.decode_step, "drafter steps")
    tm.verify_step = timed(tm.verify_step, "verify")
    for c in layers:
        c.verify_view = evented(c.verify_view)
    try:
        engine.step()
        torch.cuda.synchronize()
    finally:
        for obj in (dm, tm):   # the weight-shared drafter is the target itself
            vars(obj).pop("decode_step", None)
            vars(obj).pop("verify_step", None)
        for c in layers:
            vars(c).pop("verify_view", None)
    gather = sum(s.elapsed_time(e) for s, e in events)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.step()
        torch.cuda.synchronize()
        under = (time.perf_counter() - t0) * 1e3
    dev = device_ms_by_kernel(prof)
    busy = sum(dev.values())
    # indexing kernels: the verify's page gathers, the rows' writes, the embedding lookups
    index_ms = sum(ms for name, ms in dev.items() if "index" in name)
    idle = "not measured" if not busy else f"{100 * (1 - busy / host):.1f}% idle"
    print(f"spec tick [{arm}] (8 slots, k={SPEC_K}, full width): {host:.3f} ms host-clock "
          f"({under:.3f} ms under the profiler); parts, each synchronised: drafter steps "
          f"{parts['drafter steps']:.3f} ms ({SPEC_K + 1} steps), verify {parts['verify']:.3f} ms, "
          f"of which the page gathers span {gather:.3f} ms of the stream (CUDA events around "
          f"{len(events)} verify_view calls, host dispatch included); device busy {busy:.3f} ms "
          f"({idle}), indexing kernels (gathers, row writes, embedding lookups) "
          f"{index_ms:.3f} ms", flush=True)
    top = dict(sorted(dev.items(), key=lambda kv: -kv[1])[:10])
    for name, ms in top.items():
        print(f"  {ms:9.3f} ms/tick  {name[:90]}")
    engine.run()
    engine.check_leaks()
    return dict(host_ms=host, drafter_ms=parts["drafter steps"], verify_ms=parts["verify"],
                gather_stream_ms=gather, index_kernels_ms=index_ms, busy_ms=busy, by_kernel=top)


SCHED_CHUNK = 128   # the scheduler phase's prefill chunk grid (windows end at its multiples)
SCHED_WATCHDOG = 3.0   # its fault-tolerant runs' watchdog budget, seconds (a tick takes < 0.5)
FT_TOKENS = 16         # new tokens a request in its fault-tolerant runs


def shared_prefix_prompts(cfg):
    """The shared-prefix phase's prompts: 16 ragged prompts (seed 0) behind
    one seeded PREFIX-token prefix, then the full pages of the last two
    (fully cached once those two are admitted: the peek)."""
    import numpy as np
    from repro_torch.launch import serve as launch
    prefix = np.random.default_rng(1).integers(0, cfg.vocab_size, PREFIX).tolist()
    prompts = [prefix + p for p in launch.ragged_prompts(np.random.default_rng(0), 16, 256, 512,
                                                         cfg.vocab_size)]
    return prompts + [p[:len(p) // 16 * 16] for p in prompts[-2:]]


def sched_engine(model, params):
    """The scheduler phase's engine: 8 slots, 16-token pages, max_len 576 +
    PREFIX, the prefix cache, prefill_chunk SCHED_CHUNK."""
    from repro_torch.runtime.serve_loop import ServeEngine
    return ServeEngine(model, params, slots=SLOTS, max_len=576 + PREFIX, page_size=16,
                       prefix_cache="auto", seed=0, prefill_chunk=SCHED_CHUNK)


class SyncCounter:
    """Counts host syncs (``torch.cuda.set_sync_debug_mode("warn")``'s
    warnings) that the program's code (``src/repro_torch``) causes while
    on, except inside ``exempt`` calls (entry processing, whose pull is
    the pipeline's one intended sync); each with the innermost frame of
    the program that caused it.  Syncs with no program frame on the stack
    (this script's own instrumentation) are kept apart in ``other``."""

    def __init__(self, torch):
        self.torch, self.records, self.other, self._on = torch, [], [], False

    def exempt(self, fn):
        def run(*a, **kw):
            self.torch.cuda.set_sync_debug_mode(0)
            try:
                return fn(*a, **kw)
            finally:
                self.torch.cuda.set_sync_debug_mode(1 if self._on else 0)
        return run

    def _show(self, message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        import traceback
        stack = traceback.extract_stack()[:-1]
        ours = [f for f in stack if f.filename.startswith(os.path.join(HERE, "src"))]
        if ours:
            self.records.append(f"{os.path.relpath(ours[-1].filename, HERE)}:{ours[-1].lineno}")
        else:
            self.other.append(f"{message} at " + " <- ".join(
                f"{os.path.basename(f.filename)}:{f.lineno}" for f in stack[-4:][::-1]))

    @contextlib.contextmanager
    def counting(self):
        import warnings
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = self._show
            self._on = True
            self.torch.cuda.set_sync_debug_mode(1)
            try:
                yield self
            finally:
                self.torch.cuda.set_sync_debug_mode(0)
                self._on = False

    def where(self):
        """The distinct source lines of the repo that synced, with counts."""
        out = {}
        for key in self.records:
            out[key] = out.get(key, 0) + 1
        return out


def scheduled_run(torch, model, params, prompts, depth, syncs=None):
    """Serve ``prompts`` (32 greedy new tokens each) through a
    ``PipelinedScheduler`` at ``depth`` over ``sched_engine``; counts set
    to 0 just before and read just after, host syncs counted by ``syncs``
    if given.  Returns {streams (in prompt order), launches (kernels 1, 2
    and 3 by route, checked), counts (decode ticks, chunks, peeks),
    seconds, tok_s, stats (the scheduler's metrics document)}."""
    from repro_torch.runtime.scheduler import PipelinedScheduler
    engine = sched_engine(model, params)
    sched = PipelinedScheduler(engine, pipeline_depth=depth, prefill_chunk=SCHED_CHUNK)
    n = {"ticks": 0, "chunks": 0, "peeks": 0}

    def counted(fn, key):
        def run(*a, **kw):
            n[key] += 1
            return fn(*a, **kw)
        return run
    sched._dispatch_decode = counted(sched._dispatch_decode, "ticks")
    sched._advance_chunk = counted(sched._advance_chunk, "chunks")
    engine._peek = counted(engine._peek, "peeks")
    if syncs is not None:
        sched._process_entry = syncs.exempt(sched._process_entry)
    uids = [sched.submit(p, max_new_tokens=32) for p in prompts]
    torch.cuda.synchronize()
    reset_counts(torch)
    t0 = time.perf_counter()
    with syncs.counting() if syncs is not None else contextlib.nullcontext():
        while sched.tick():
            pass
    sched.flush()
    dt = time.perf_counter() - t0
    launches, plain_runs = read_counts(torch)
    routes = {"flash_attention_masked[tensor-core]": read_tc_counts(torch)[
        "flash_attention_masked"], **read_matmul_routes(torch)}
    engine.check_leaks()
    if any(plain_runs.values()):
        raise AssertionError(f"scheduler depth {depth}: plain versions ran: {plain_runs}")
    results = sched.results
    if sorted(results) != sorted(uids) or any(len(v) != 32 for v in results.values()):
        raise AssertionError(f"scheduler depth {depth}: {len(results)} results, lengths "
                             f"{sorted(len(v) for v in results.values())}")
    from repro_torch.configs import get_config
    return dict(streams=[results[u] for u in uids], counts=n, seconds=dt,
                tok_s=sum(map(len, results.values())) / dt, stats=sched.stats(),
                launches=check_sched_launches(get_config("qwen2.5-3b"), depth, launches,
                                              routes, n))


def check_sched_launches(cfg, depth, launches, routes, n):
    """Per decode tick kernel 1 on the stream (252) and kernel 3 (36); per
    prefill chunk kernel 1 on the tensor-core loop (252) and kernel 2 on
    its tensor-core route (36); per peek kernel 1 on the stream and kernel
    2 (tensor-core); nothing else."""
    per, nl = projections(cfg) * cfg.num_layers, cfg.num_layers
    ticks, chunks, peeks = n["ticks"], n["chunks"], n["peeks"]
    want = {"ent_matmul_packed_fused[stream]": per * (ticks + peeks),
            "ent_matmul_packed_fused[tc]": per * chunks,
            "flash_attention_masked": nl * (chunks + peeks),
            "flash_attention_masked[tensor-core]": nl * (chunks + peeks),
            "paged_attention_kernel": nl * ticks, "paged_attention_kernel[int8_kv]": 0,
            "int8_matmul": 0, "ent_matmul": 0, "ent_matmul_packed": 0}
    got = {k: {**launches, **routes}[k] for k in want}
    if got != want:
        raise AssertionError(f"scheduler depth {depth}: launches {got}, expected {want} "
                             f"({ticks} decode ticks, {chunks} chunks, {peeks} peeks)")
    return got


def profile_sched_ticks(torch, model, params, prompts, ticks=3):
    """Host ms per scheduler tick and the device's idle share at depth 0
    and depth 1: fill 8 slots through a depth-1 scheduler (64 new tokens
    each), then, on the same full batch, in the order depth 0, 1, 1, 0
    (``sched.depth`` set between runs; the reservation slack of depth 1
    covers both), ``ticks`` ticks on the host clock (flushed) and
    ``ticks`` under torch.profiler (device busy).  Returns {depth: {...}}."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.runtime.scheduler import PipelinedScheduler
    engine = sched_engine(model, params)
    sched = PipelinedScheduler(engine, pipeline_depth=1, prefill_chunk=SCHED_CHUNK)
    for p in prompts[:SLOTS]:
        sched.submit(p, max_new_tokens=64)
    while len(engine._active) < SLOTS or sched._prefill is not None or sched._queued:
        sched.tick()
    sched.flush()
    out = {0: {"host_ms": [], "busy_ms": [], "profiled_ms": []},
           1: {"host_ms": [], "busy_ms": [], "profiled_ms": []}}
    for depth in (0, 1, 1, 0):
        sched.depth = depth
        sched.flush()
        t0 = time.perf_counter()
        for _ in range(ticks):
            sched.tick()
        sched.flush()
        out[depth]["host_ms"].append((time.perf_counter() - t0) * 1e3 / ticks)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(ticks):
                sched.tick()
            sched.flush()
            under = (time.perf_counter() - t0) * 1e3 / ticks
        out[depth]["busy_ms"].append(sum(device_ms_by_kernel(prof, ticks).values()))
        out[depth]["profiled_ms"].append(under)
        if len(engine._active) < SLOTS:
            raise AssertionError(f"scheduler profile: a slot finished mid-measurement "
                                 f"({len(engine._active)} active)")
    sched.run()
    for depth, r in out.items():
        host, busy = statistics.mean(r["host_ms"]), statistics.mean(r["busy_ms"])
        r.update(mean_host_ms=host, mean_busy_ms=busy,
                 idle=None if not busy else 1 - busy / host)
        print(f"scheduler tick at depth {depth} (8 slots decoding, full width): host "
              f"{' / '.join(f'{v:.3f}' for v in r['host_ms'])} ms a tick (A B B A order: "
              f"depth 0, 1, 1, 0); device busy "
              f"{' / '.join(f'{v:.3f}' for v in r['busy_ms'])} ms a tick; "
              + (f"{100 * r['idle']:.1f}% idle" if busy else "idle not measured")
              + f"; under the profiler {' / '.join(f'{v:.3f}' for v in r['profiled_ms'])} ms",
              flush=True)
    return out


def hits_at_first_admission(uid):
    """An empty fault plan that records every site's hit count at ``uid``'s
    first ``prefill.dispatch`` (``.at``)."""
    from repro_torch.runtime.faults import FaultPlan

    class Recorder(FaultPlan):
        at = None

        def observe(self, site, ctx):
            if self.at is None and site == "prefill.dispatch" and ctx.get("uid") == uid:
                self.at = dict(self.hits)
            super().observe(site, ctx)
    return Recorder([])


def ft_plan(uid, at):
    """Phase (b)'s fixed plan, from the hit counts ``at`` of the fault-free
    run when request ``uid`` first reached ``prefill.dispatch``: an error
    there for that uid (the run is the fault-free one up to it), then one
    error each at decode.dispatch, sampler and allocator.alloc, and a
    decode.dispatch hang past the watchdog."""
    from repro_torch.runtime.faults import Fault, FaultPlan
    return FaultPlan([Fault("prefill.dispatch", at=at["prefill.dispatch"], uid=uid),
                      Fault("decode.dispatch", at=at["decode.dispatch"] + 2),
                      Fault("sampler", at=at["sampler"] + 3),
                      Fault("allocator.alloc", at=at["allocator.alloc"] + 2),
                      Fault("decode.dispatch", at=at["decode.dispatch"] + 8, kind="hang",
                            seconds=SCHED_WATCHDOG + 1.0)])


def ft_run(torch, model, params, prompts, plan=None, keep_generators=False, snap_times=None):
    """8 requests (FT_TOKENS new tokens at temperature 0.9) through a
    fault-tolerant scheduler (max_retries 3, the watchdog at
    SCHED_WATCHDOG s), under ``plan`` if given.  ``keep_generators``
    plants the fault "restore skips the generator states".
    ``snap_times`` collects each engine snapshot's (host ms, device ms,
    bytes).  Returns (streams, scheduler stats, errors, fired)."""
    from repro_torch.runtime.scheduler import PipelinedScheduler
    engine = sched_engine(model, params)
    sched = PipelinedScheduler(engine, prefill_chunk=SCHED_CHUNK, max_retries=3,
                               watchdog_timeout=SCHED_WATCHDOG)
    if keep_generators:
        restore = engine.restore

        def restore_keeping_generators(snap):
            keys = engine._keys
            restore(snap)
            engine._keys = keys
        engine.restore = restore_keeping_generators
    if snap_times is not None:
        snapshot = engine.snapshot

        def timed_snapshot():
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            s.record()
            snap = snapshot()
            e.record()
            snap_times.append(((time.perf_counter() - t0) * 1e3, (s, e), snap.nbytes))
            return snap
        engine.snapshot = timed_snapshot
    uids = [sched.submit(p, max_new_tokens=FT_TOKENS, temperature=0.9) for p in prompts]
    with plan if plan is not None else contextlib.nullcontext():
        results = sched.run()
    engine.check_leaks()
    fired = [] if plan is None else [(f.site, f.hit, f.kind, f.uid) for f in plan.fired]
    streams = [results.get(u) for u in uids]
    return streams, sched.stats(), dict(sched.errors), fired, uids


def serve_scheduler(torch, model, params):
    """The scheduler phase on full-width qwen2.5-3b, EN-T, bf16 KV (phase
    4's model): (a) the shared-prefix phase's 18 prompts through a
    ``PipelinedScheduler`` at depth 1 and at depth 0 (chunked admission,
    SCHED_CHUNK-token windows), against the synchronous engine with the
    same prefill_chunk; (b) 8 of them at temperature 0.9 through the
    fault-tolerant scheduler under a fixed fault plan, retried ≡ fault-free,
    with the planted fault "restore skips the generator states"; (c) park
    and resume under ``ElasticSupervisor`` over 2 simulated hosts; (d) the
    ``--http --http-smoke`` path of ``launch/serve.py``.  Returns the
    numbers."""
    import argparse
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as launch
    from repro_torch.runtime.elastic import ElasticSupervisor, HealthMonitor
    from repro_torch.runtime.scheduler import PARKED, PipelinedScheduler

    cfg = get_config("qwen2.5-3b")
    prompts = shared_prefix_prompts(cfg)
    out = {}

    # (a) pipelined and chunked serving
    engine = sched_engine(model, params)
    t0 = time.perf_counter()
    for p in prompts:
        engine.submit(p, max_new_tokens=32)
    sync = engine.run()
    torch.cuda.synchronize()
    sync_s = time.perf_counter() - t0
    sync_streams = [sync[u] for u in sorted(sync)]
    del engine
    syncs = SyncCounter(torch)
    runs = {depth: scheduled_run(torch, model, params, prompts, depth,
                                 syncs if depth == 1 else None) for depth in (1, 0)}
    if runs[1]["streams"] != runs[0]["streams"]:
        raise AssertionError("scheduler: depth-1 streams differ from depth-0 streams: first "
                             "differences " + str([first_difference(a, b) for a, b in zip(
                                 runs[1]["streams"], runs[0]["streams"])]))
    n_syncs = len(syncs.records)
    if n_syncs:
        raise AssertionError(f"scheduler depth 1: {n_syncs} host syncs outside entry "
                             f"processing, at {syncs.where()}")
    same_sync = sum(a == b for a, b in zip(runs[1]["streams"], sync_streams))
    for depth, r in runs.items():
        print(f"scheduler [depth {depth}, chunk {SCHED_CHUNK}]: 18 requests x 32 new tokens "
              f"on 8 slots in {r['seconds']:.3f}s = {r['tok_s']:.2f} tok/s; "
              f"{r['counts']['ticks']} decode ticks, {r['counts']['chunks']} prefill chunks, "
              f"{r['counts']['peeks']} peeks; launches {r['launches']}", flush=True)
    print(f"scheduler: depth 1 ≡ depth 0, 18 of 18 streams; equal to the synchronous "
          f"engine's (prefill_chunk {SCHED_CHUNK}, {sync_s:.3f}s = "
          f"{576 / sync_s:.2f} tok/s): {same_sync} of 18; host syncs in depth-1 ticks "
          f"outside entry processing: {n_syncs} (syncs of this script's instrumentation, "
          f"not counted: {syncs.other[:3]})", flush=True)
    lat = runs[1]["stats"]     # latency under the scheduler: the depth-1 run's metrics
    print(f"scheduler [depth 1] ServingMetrics: TTFT p50 {lat['ttft']['p50_us']} us, p99 "
          f"{lat['ttft']['p99_us']} us; ITL p50 {lat['inter_token']['p50_us']} us, p99 "
          f"{lat['inter_token']['p99_us']} us; queue wait p50 "
          f"{lat['queue_wait']['p50_us']} us; {lat['tokens']['per_s']} tok/s", flush=True)
    prof = profile_sched_ticks(torch, model, params, prompts)
    out["a"] = dict(runs={d: {k: v for k, v in r.items() if k not in ("streams", "stats")}
                          for d, r in runs.items()},
                    equal_sync=same_sync, host_syncs=n_syncs, latency=dict(
                        ttft=lat["ttft"], inter_token=lat["inter_token"],
                        queue_wait=lat["queue_wait"]), profile=prof,
                    sync_seconds=sync_s)

    # (b) retried ≡ fault-free
    few = prompts[:SLOTS]
    rec = hits_at_first_admission(5)           # the sixth request's uid
    clean, _, _, _, uids = ft_run(torch, model, params, few, plan=rec)
    snap_times = []
    plan = ft_plan(uids[5], rec.at)
    faulty, stats, errors, fired, _ = ft_run(torch, model, params, few, plan=plan,
                                             snap_times=snap_times)
    torch.cuda.synchronize()
    # each planned fault fired once: at its hit, or (uid filter) for its uid
    as_planned = len(fired) == len(plan.faults) and all(
        any(site == f.site and kind == f.kind and (hit == f.at if f.uid is None else uid == f.uid)
            for site, hit, kind, uid in fired) for f in plan.faults)
    if faulty != clean:
        raise AssertionError("scheduler FT: retried streams differ from the fault-free run's "
                             f"(first differences {[first_difference(a, b) for a, b in zip(faulty, clean)]})")
    if not as_planned:
        raise AssertionError(f"scheduler FT: fired {fired}, planned {plan.faults}")
    if errors or stats["faults"]["quarantined"]:
        raise AssertionError(f"scheduler FT: quarantined {errors}")
    if stats["faults"]["watchdog_trips"] != 1:
        raise AssertionError(f"scheduler FT: watchdog trips {stats['faults']}")
    planted, *_ = ft_run(torch, model, params, few, plan=ft_plan(uids[5], rec.at),
                                      keep_generators=True)
    if planted == clean:
        raise AssertionError("scheduler FT: the planted fault 'restore skips the generator "
                             "states' kept the streams equal")
    host_ms = [h for h, _, _ in snap_times]
    dev_ms = [s.elapsed_time(e) for _, (s, e), _ in snap_times]
    nbytes = snap_times[-1][2]
    print(f"scheduler FT (8 requests x {FT_TOKENS} tokens at temperature 0.9, max_retries 3, "
          f"watchdog "
          f"{SCHED_WATCHDOG}s): fired {fired}; faults {stats['faults']}; retried ≡ fault-free, "
          f"8 of 8 streams; planted fault 'restore skips the generator states': "
          f"{sum(a == b for a, b in zip(planted, clean))} of 8 equal (caught); snapshot "
          f"{nbytes / 2**20:.1f} MiB ({nbytes} bytes), {len(snap_times)} snapshots: host "
          f"median {statistics.median(host_ms):.3f} ms, device median "
          f"{statistics.median(dev_ms):.3f} ms (CUDA events around snapshot())", flush=True)
    out["b"] = dict(fired=fired, faults=stats["faults"], snapshot_bytes=nbytes,
                    snapshot_host_ms=statistics.median(host_ms),
                    snapshot_device_ms=statistics.median(dev_ms), snapshots=len(snap_times),
                    planted_equal=sum(a == b for a, b in zip(planted, clean)))

    # (c) park and resume under the elastic supervisor
    engine = sched_engine(model, params)
    sched = PipelinedScheduler(engine, pipeline_depth=1, prefill_chunk=SCHED_CHUNK)
    uids = [sched.submit(p, max_new_tokens=32) for p in few]
    sup = ElasticSupervisor(sched, hosts=2, clock=lambda: 0.0,
                            monitor=HealthMonitor(timeout_s=10.0))
    while len(engine._active) < SLOTS or sched._prefill is not None or sched._queued:
        sched.tick()
    sup.beat(0, now=20.0)                      # host 1 goes silent
    ev = sup.poll(now=20.0)
    parked = [u for u in uids if sched.status(u) == PARKED]
    if ev["capacity"] != SLOTS // 2 or len(parked) != SLOTS // 2:
        raise AssertionError(f"elastic: event {ev}, parked {parked}")
    engine.check_leaks()
    for _ in range(3):
        sched.tick()
    for h in range(2):
        sup.beat(h, now=21.0)
    ev2 = sup.poll(now=21.0)
    results = sched.run()
    parked_streams = [results[u] for u in uids]
    if parked_streams != runs[1]["streams"][:SLOTS] or engine.parked_uids:
        raise AssertionError("elastic: parked streams differ from the uninterrupted run's")
    print(f"elastic (2 simulated hosts, depth 1): host 1 lost -> {ev}, {len(parked)} streams "
          f"parked mid-generation; back -> {ev2}; 8 of 8 streams equal the uninterrupted "
          f"run's; parked {sched.metrics.parked_total}, resumed {sched.metrics.resumed_total}; "
          "leak check clean", flush=True)
    out["c"] = dict(events=[ev, ev2], parked=len(parked))
    del sched, engine

    # (d) the --http --http-smoke path of launch/serve.py
    smoke = {}
    for plan_name in ("", "ci-chaos"):
        args = argparse.Namespace(
            fault_plan=plan_name, max_retries=0, pipeline_depth=1, max_queue=256,
            prefill_chunk=SCHED_CHUNK, watchdog=0.0, host="127.0.0.1", port=0,
            http_smoke=True, prompt_len=PREFIX, steps=32)
        res = launch.serve_http(args, cfg, sched_engine(model, params))
        m = res["metrics"]
        smoke[plan_name or "no plan"] = dict(
            tokens=len(res["tokens"]), fired=res["fired"], ttft=m["ttft"],
            inter_token=m["inter_token"], faults=m["faults"])
    out["d"] = smoke
    torch.cuda.empty_cache()
    return out


def check_serve_routes(cfg, config, launches, routes, ticks):
    """Per decode tick and per prefill, each layer launches its path's
    matmul (kernel 1 or 6) once per projection, on the route its wrapper's
    cut gives the tick's 8 rows (the split-K stream) and on the tensor-core
    loop at prefill sizes of M, and kernel 2 once per prefill, all of it
    on the tensor-core route."""
    per = projections(cfg) * cfg.num_layers
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


def copy_ms(prof, per=1):
    """The copies of a torch.profiler run, over ``per``: ``aten::copy_``'s
    device time (op_ms), and the device time and launches of the kernels
    named for a copy (kernels_ms, launches)."""
    out = dict(op_ms=0.0, kernels_ms=0.0, launches=0.0)
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
        if ev.key == "aten::copy_":
            out["op_ms"] += us / 1e3 / per
        elif str(getattr(ev, "device_type", "")).endswith("CUDA") and (
                "copy" in ev.key.lower() or "memcpy" in ev.key.lower()):
            out["kernels_ms"] += us / 1e3 / per
            out["launches"] += ev.count / per
    return out


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
    runs = {}
    for profiled in (False, True):
        runs[profiled] = admit_profiled(torch, engine, prompt, profiled)
        if not profiled:
            launches, _ = read_counts(torch)
            check_serve_routes(cfg, config, launches, {
                "flash_attention_masked[tensor-core]": launches["flash_attention_masked"],
                **read_matmul_routes(torch)}, 0)
        engine.run()
    host, (under, busy, dev) = runs[False][0], runs[True]
    print(f"admission prefill ({len(prompt)} tokens, full width): {host:.3f} ms "
          f"host-clock ({under:.3f} ms under the profiler); device busy {busy:.3f} ms "
          f"({100 * (1 - busy / host):.1f}% idle)" if busy else "device time not measured")
    for name, ms in dev.items():
        print(f"  {ms:9.3f} ms/prefill  {name[:90]}")
    engine.check_leaks()
    return dict(host_ms=host, busy_ms=busy, by_kernel=dev)


def admit_profiled(torch, engine, prompt, profiled):
    """Admit ``prompt`` into the idle ``engine`` (``_admit``: the prefill
    alone, no decode tick; launch counts set to 0 just before it), under
    torch.profiler if ``profiled``; the caller drains the engine.  Returns
    (host ms, device busy ms, device ms by kernel, the top ten)."""
    from torch.profiler import ProfilerActivity, profile
    engine.submit(prompt, max_new_tokens=2)
    torch.cuda.synchronize()
    reset_counts(torch)
    ctx = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) if profiled \
        else contextlib.nullcontext()
    with ctx as prof:
        t0 = time.perf_counter()
        engine._admit()
        torch.cuda.synchronize()
        host = (time.perf_counter() - t0) * 1e3
    dev = device_ms_by_kernel(prof) if profiled else {}
    return host, sum(dev.values()), dict(sorted(dev.items(), key=lambda kv: -kv[1])[:10])


def profile_decode_ticks(torch, engine, prompts, cfg, config, ticks=3):
    """Where a full-batch decode tick's time goes: fill the 8 slots, then
    profile ``ticks`` pure decode ticks (host clock around synchronised
    ticks; device time per kernel from torch.profiler).  The unprofiled
    ticks must launch their path's matmul once per projection and layer,
    all on the split-K stream, and no prefill.  Then the matmul's two
    routes in the same process, the wrapper's and the other (its cut set
    to 0 or to the tick's M for the run), in the order A B B A, ``ticks``
    profiled ticks each: its device ms a tick on each route, the decode
    tick's measure of the cut.  Returns ({route: [ms a tick, ms a tick]},
    {"host_ms", "busy_ms"} of the unprofiled / profiled ticks)."""
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
    return by_route, {"host_ms": plain_wall, "busy_ms": busy}


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


def context_after_write(real):
    """The planted fault "context read after the chunk's write", around
    ``attention.prefill_step`` (``real``): a ring chunk attends the context
    its ring holds once the chunk is written (the step is first run on a
    clone of the cache, whose ``context`` the cache then serves)."""
    from repro_torch.models import kv_cache

    def step(cfg, p, x, cache, *a, **kw):
        if not isinstance(cache, kv_cache.RingCache):
            return real(cfg, p, x, cache, *a, **kw)
        cache.context = real(cfg, p, x, cache.clone(), *a, **kw)[1].context
        try:
            return real(cfg, p, x, cache, *a, **kw)
        finally:
            del cache.context
    return step


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


def kernels_vs_plain_prefix(torch, bound):
    """The prefix cache's model-level path at 2 layers of full-width
    qwen2.5-3b (bf16, EN-T), with the kernels and with the plain versions,
    on one paged pool of 2 slots: a 256-token prefix prefilled into slot 0,
    a 200-token suffix at pos0 = 256 tail-padded to 256 rows with the real
    last row picked (``last_index``), a read-only peek of a fully cached
    448-token prompt from slot 1 (whose table maps slot 0's first 28 pages),
    then 4 teacher-forced decode ticks of both slots.  Fails when the
    logits' relative L2 difference exceeds ``bound``, when the peek writes
    the pool on the kernel path, or when a planted fault (kernel 2 called
    with q_offset 0; ``last_index`` ignored) stays within the limit.
    Returns the kernel launches of the kernel run."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as attn_ops
    from repro_torch.launch import serve as launch
    from repro_torch.models.transformer import Model

    cfg = dataclasses.replace(get_config("qwen2.5-3b"), num_layers=2, compute_dtype="bfloat16")
    model, params = launch.build(cfg, seed=1, quantize=True)
    plain_model = Model(cfg, use_kernels=False)
    rng = np.random.default_rng(2)
    dev = model.device
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 456))).to(dev)
    suffix = torch.cat([toks[:, 256:], toks.new_zeros((1, 56))], dim=1)   # 200 + 56 pad rows
    forced = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 2))).to(dev)
    shared = 448 // 16   # slot 1 maps slot 0's first 28 pages: a cached 448-token prompt

    def run(m, last_index=199, check_peek=False):
        cache = m.init_cache(2, 576, kind="paged", page_size=16)
        table = cache["layers"][0].block_table.clone()
        table[1, :shared] = table[0, :shared]
        for c in cache["layers"]:
            c.with_table(table)

        def view(slot, pos):
            return {"layers": [c.prefill_view(slot) for c in cache["layers"]], "pos": pos}
        first, _ = m.prefill(params, view(0, 0), toks[:, :256])
        out = m.apply(params, suffix, cache=view(0, 256), write_cache=True, last_only=True,
                      pos0=256, last_index=last_index)
        pools = [t.clone() for c in cache["layers"] for t in (c.k, c.v)]
        peek = m.apply(params, toks[:, 447:448], cache=view(1, 447), write_cache=True, peek=True,
                       last_only=True, pos0=447)
        if check_peek and not all(torch.equal(a, b) for a, b in zip(
                pools, [t for c in cache["layers"] for t in (c.k, c.v)])):
            raise AssertionError("the peek wrote the KV pool")
        seq = [first, out["logits"][:, 0], peek["logits"][:, 0]]
        cache["pos"] = torch.tensor([456, 448], dtype=torch.int32, device=dev)
        cache["start"] = torch.zeros((2,), dtype=torch.int32, device=dev)
        for i in range(4):
            logits, cache = m.decode_step(params, cache, forced[i])
            seq.append(logits)
        return torch.cat(seq)

    def rel(a, b):
        return float((a - b).norm() / b.norm())

    reset_counts(torch)
    a = run(model, check_peek=True)
    launches, plain_runs = read_counts(torch)
    launches.update(read_matmul_routes(torch))
    if any(plain_runs.values()):
        raise AssertionError(f"prefix case: the kernel run ran plain versions {plain_runs}")
    b = run(plain_model)
    if a.shape != (11, cfg.padded_vocab) or not torch.isfinite(a).all():
        raise AssertionError(f"prefix case: logits shape {tuple(a.shape)} / finite "
                             f"{bool(torch.isfinite(a).all())}")
    sound = rel(a, b)
    agree = float((a.argmax(-1) == b.argmax(-1)).float().mean())
    print(f"2-layer full width, bfloat16, EN-T weights, prefix cache: 256-token prefix, 200-token "
          f"suffix at pos0 256 tail-padded to 256, peek at 447 over 28 shared pages, 4 decode "
          f"ticks of 2 slots; kernels vs plain: relative L2 {sound:.3e} (limit {bound}), max abs "
          f"diff {float((a - b).abs().max()):.3e}, greedy agreement {agree:.3f}; the peek left "
          f"the pools unchanged; kernel launches {launches}", flush=True)
    faults = {"kernel 2 called with q_offset 0": lambda: planted(
                  attn_ops, "flash_attention_masked",
                  lambda f: lambda q, k, v, st, **kw: f(q, k, v, st, **{**kw, "q_offset": 0})),
              "last_index ignored": None}
    missed = []
    for name, plant in faults.items():
        if plant is None:
            reading = rel(run(model, last_index=None), b)
        else:
            with plant():
                reading = rel(run(model), b)
        print(f"  planted fault '{name}': relative L2 {reading:.3e} "
              f"({'over' if reading > bound else 'within'} the limit)", flush=True)
        if reading <= bound:
            missed.append(name)
    if sound > bound:
        raise AssertionError(f"prefix case: kernel path disagrees with the plain path "
                             f"(relative L2 {sound} > {bound})")
    if missed:
        raise AssertionError(f"prefix case: the limit {bound} misses planted faults {missed}")
    return launches


def kernels_vs_plain_spec(torch, weights, bound, kv_quant=False):
    """The speculative path's model-level calls at 2 layers of full-width
    qwen2.5-3b (bf16), with the kernels and with the plain versions, on
    the same tokens: a paged prefill (2 x 256 tokens, one left-padded to
    200), a verify burst of K + 1 tokens at pos 256, the rollback to the
    accepted (1 and 3 drafts: pos 258 and 260), a second burst there; and
    the drafter's dense read (a dense prefill of the same prompts, then
    K + 1 decode steps).  Readings, each the largest relative L2 over the
    three parts (each burst's logits, the dense steps'): kernels vs plain;
    the kernels' verify bursts vs K + 1 kernel decode steps (kernel 3) of
    the same tokens; and the planted rollback fault (``pos`` not reset
    after the first burst) against the plain run, which must exceed
    ``bound`` where the first two stay within it.  Returns the kernel
    run's launches."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as launch
    from repro_torch.models.transformer import Model

    cfg = dataclasses.replace(get_config("qwen2.5-3b"), num_layers=2, compute_dtype="bfloat16")
    model, params = launch.build(cfg, seed=1, kv_quant=kv_quant, **build_kw(E2E_WEIGHTS[weights]))
    plain_model = Model(cfg, use_kernels=False, kv_quant=kv_quant)
    label = f"{weights} weights{', int8 KV' if kv_quant else ''}"
    rng = np.random.default_rng(4)
    dev = model.device
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 256))).to(dev)
    mask = torch.ones((2, 256), dtype=torch.bool, device=dev)
    mask[1, :56] = False
    bursts = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 2, SPEC_K + 1))).to(dev)
    i32 = dict(dtype=torch.int32, device=dev)
    accepted = torch.tensor([1, 3], **i32)

    def prefilled(m, kind):
        cache = m.init_cache(2, 288, kind=kind)
        _, cache = m.prefill(params, cache, toks, pad_mask=mask)
        cache["pos"] = torch.full((2,), 256, **i32)
        cache["start"] = torch.tensor([0, 56], **i32)
        return cache

    def run(m, rollback=True, sequential=False):
        cache, parts = prefilled(m, "paged"), []
        for burst in bursts:
            pos = cache["pos"]
            if sequential:
                steps = []
                for t in range(burst.shape[1]):
                    logits, cache = m.decode_step(params, cache, burst[:, t])
                    steps.append(logits)
                logits = torch.stack(steps, dim=1)
            else:
                logits, cache, _ = m.verify_step(params, cache, burst)
            parts.append(logits)
            if rollback:
                cache["pos"] = pos + accepted + 1
        dense, steps = prefilled(m, "dense"), []
        for t in range(SPEC_K + 1):
            logits, dense = m.decode_step(params, dense, bursts[0][:, t])
            steps.append(logits)
        return parts + [torch.stack(steps, dim=1)]

    def rel(a, b):
        return max(float((x - y).norm() / y.norm()) for x, y in zip(a, b))

    reset_counts(torch)
    a = run(model)
    launches, plain_runs = read_counts(torch)
    launches["flash_attention_masked[offsets]"] = read_offset_launches(torch)
    if any(plain_runs.values()):
        raise AssertionError(f"spec 2-layer ({label}): the kernel run ran plain versions "
                             f"{plain_runs}")
    offsets = cfg.num_layers * (2 + SPEC_K + 1)   # two bursts, K + 1 dense steps
    if launches["flash_attention_masked[offsets]"] != offsets:
        raise AssertionError(f"spec 2-layer ({label}): {launches} (expected {offsets} offset "
                             "launches of kernel 2)")
    b = run(plain_model)
    if any(x.shape != (2, SPEC_K + 1, cfg.padded_vocab) or not torch.isfinite(x).all()
           for x in a):
        raise AssertionError(f"spec 2-layer ({label}): logits shapes "
                             f"{[tuple(x.shape) for x in a]} or non-finite")
    sound = rel(a, b)
    seq = rel(a[:2], run(model, sequential=True)[:2])
    fault = rel(run(model, rollback=False), b)
    print(f"2-layer full width, bfloat16, {label}, speculative path: verify bursts of "
          f"{SPEC_K + 1} at pos 256 and after the rollback, the drafter's dense steps; "
          f"kernels vs plain: relative L2 {sound:.3e} (limit {bound}); verify bursts vs "
          f"{SPEC_K + 1} kernel decode steps: {seq:.3e}; planted fault 'pos not reset after a "
          f"rejection': {fault:.3e} ({'over' if fault > bound else 'within'} the limit); "
          f"kernel launches {launches}", flush=True)
    if sound > bound or seq > bound:
        raise AssertionError(f"spec 2-layer ({label}): kernels vs plain {sound}, burst vs "
                             f"decode steps {seq}, limit {bound}")
    if fault <= bound:
        raise AssertionError(f"spec 2-layer ({label}): the limit {bound} misses the planted "
                             f"rollback fault ({fault})")
    return launches


# The ring phase: full-width starcoder2-15b (window 4096) served through
# the ring.  Prompts bucket to powers of two as the reference's engine
# left-pads them: 4,097..4,600 tokens to 8,192 (two 4,096-row chunks, the
# ring wrapped during the prefill), 4,080 and 4,095 to 4,096 (one chunk,
# wrapped by the first decode write); so max_len is 8,192 + 32 positions
# (the ring itself is min(max_len, window) = 4,096 rows a slot).
RING_MAX_LEN = 8192 + 32
RING_LONG = (4097, 4600)    # the 14 prompts' lengths, drawn from this range
RING_SHORT = (4080, 4095)
RING_CHECK = (5120, 5220)   # the 2-layer ring case: prompt tokens, max_len


def ring_prompts(cfg):
    """14 prompts of 4,097..4,600 tokens and two of RING_SHORT (seed 0), the
    short ones third and eleventh (one in each wave of 8 slots)."""
    import numpy as np
    from repro_torch.launch import serve as launch
    rng = np.random.default_rng(0)
    prompts = launch.ragged_prompts(rng, 14, *RING_LONG, cfg.vocab_size)
    for at, n in zip((2, 10), RING_SHORT):
        prompts.insert(at, rng.integers(0, cfg.vocab_size, n).tolist())
    return prompts


def step_counts(torch):
    """The serving kernels' counters: kernel 1 by route, kernel 2 (its
    tensor-core and offset launches), kernel 3, the ring decode (and its
    int8-KV launches), 8p (and each of its three launches), training's
    kernel 8, the plain versions."""
    launches, plain_runs = read_counts(torch)
    return {**read_matmul_routes(torch), "flash_attention_masked": launches[
        "flash_attention_masked"], "flash_attention_masked[tensor-core]": read_tc_counts(
        torch)["flash_attention_masked"], "flash_attention_masked[offsets]":
        read_offset_launches(torch), "ring_decode_attention": read_ring_launches(torch),
        "ring_decode_attention[int8_kv]": launches["ring_decode_attention[int8_kv]"],
        "paged_attention_kernel": launches["paged_attention_kernel"]
        + launches["paged_attention_kernel[int8_kv]"],
        **{k: launches[k] for k in ("ssd_prefill", *(f"ssd_prefill[{part}]"
                                                     for part in SSD_FWD_PARTS), "ssd_scan")},
        "plain": sum(plain_runs.values())}


@contextlib.contextmanager
def counted_steps(torch, model, calls):
    """Append ("tick", counter deltas) for each ``model.decode_step`` and
    ("chunk", deltas, kernel 2's windows) for each cache-writing
    ``model.apply`` (a prefill chunk) while inside; kernel 2's calls are
    recorded through its ops-level name (their windows)."""
    from repro_torch.kernels.flash_attention import ops as attn_ops
    seen = []

    def record(f):
        def g(*a, **kw):
            seen.append(kw.get("window"))
            return f(*a, **kw)
        return g

    def wrap(name, kind):
        real = getattr(model, name)

        def f(*a, **kw):
            before, n = step_counts(torch), len(seen)
            out = real(*a, **kw)
            after = step_counts(torch)
            calls.append((kind, {k: after[k] - before[k] for k in after}, seen[n:]))
            return out
        return f

    saved = {n: model.__dict__[n] for n in ("decode_step", "apply") if n in model.__dict__}
    model.decode_step = wrap("decode_step", "tick")
    model.apply = wrap("apply", "chunk")
    try:
        with planted(attn_ops, "flash_attention_masked", record):
            yield
    finally:
        del model.decode_step, model.apply
        model.__dict__.update(saved)   # an enclosing wrapper's, when there is one


def check_ring_steps(cfg, calls, int8_kv=False):
    """Every decode tick: kernel 1 once per projection and layer, all on the
    split-K stream, and the ring decode once per layer (``int8_kv``: its
    int8-KV launches), kernel 2 never; every prefill chunk: kernel 1 once
    per projection and layer on the tensor-core loop and kernel 2 once per
    layer with window 4096, all on the tensor-core route, the ring decode
    never; kernel 3 and the plain versions never."""
    per, nl, w = projections(cfg) * cfg.num_layers, cfg.num_layers, cfg.sliding_window
    want = {"tick": {"ent_matmul_packed_fused[stream]": per, "ent_matmul_packed_fused[tc]": 0,
                     "flash_attention_masked": 0, "flash_attention_masked[tensor-core]": 0,
                     "flash_attention_masked[offsets]": 0, "ring_decode_attention": nl,
                     "ring_decode_attention[int8_kv]": nl * int8_kv,
                     "paged_attention_kernel": 0, "plain": 0},
            "chunk": {"ent_matmul_packed_fused[stream]": 0, "ent_matmul_packed_fused[tc]": per,
                      "flash_attention_masked": nl, "flash_attention_masked[tensor-core]": nl,
                      "flash_attention_masked[offsets]": 0, "ring_decode_attention": 0,
                      "ring_decode_attention[int8_kv]": 0, "paged_attention_kernel": 0,
                      "plain": 0}}
    args = {"tick": [], "chunk": [w] * nl}
    for i, (kind, got, seen) in enumerate(calls):
        got = {k: got[k] for k in want[kind]}
        if got != want[kind] or seen != args[kind]:
            raise AssertionError(f"ring {kind} {i}: launches {got}, kernel 2's windows "
                                 f"{sorted(set(seen))} x {len(seen)}; expected {want[kind]}, "
                                 f"{args[kind][:1]} x {len(args[kind])}")
    return {k: sum(kind == k for kind, _, _ in calls) for k in want}


def param_bytes(tree):
    """Bytes of every tensor in a param tree."""
    if isinstance(tree, dict):
        return sum(param_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(param_bytes(v) for v in tree)
    return tree.numel() * tree.element_size() if hasattr(tree, "numel") else 0


def serve_ring(torch):
    """Sliding-window serving on full-width starcoder2-15b (40 layers,
    d_model 6144, 48/4 heads, head_dim 128, d_ff 24576, GELU, LayerNorm,
    biases, vocab 49152; EN-T weights from seed 0, quantized layer by layer
    on the card; bf16 KV): 16 greedy requests (``ring_prompts``), 32 new
    tokens each, on 8 slots of a 4096-row ring (``cache_kind="ring"``).
    Counts per decode tick and per prefill chunk (``check_ring_steps``);
    ``check_leaks``.  Then the first wave's 8 prompts again, each admitted
    into a slot whose ring still holds a second-wave request's rows: their
    first 8 tokens must equal the run's; 3 full-batch decode ticks timed by
    host clock, then 3 under torch.profiler (device busy, the ring decode's
    share by its kernel's name, the copies: ``aten::copy_``'s device time
    and the copy kernels').  Returns the numbers."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as launch
    from repro_torch.runtime.serve_loop import ServeEngine

    cfg = get_config("starcoder2-15b")
    gc.collect()   # earlier phases' engines and schedulers hold their models in cycles
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, params = launch.build(cfg, seed=0, quantize=True)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights = param_bytes(params)
    engine = ServeEngine(model, params, slots=SLOTS, max_len=RING_MAX_LEN, cache_kind="ring",
                         prefix_cache=False, seed=0)
    ring = engine.cache["layers"][0]
    print(f"starcoder2-15b full width ({cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.num_heads}/{cfg.num_kv_heads} heads, head_dim {cfg.head_dim}, d_ff "
          f"{cfg.d_ff}, {cfg.mlp_type}, {cfg.norm_type}, vocab {cfg.vocab_size}, window "
          f"{cfg.sliding_window}), EN-T w8a8, bf16 KV: init + quantize {init_s:.2f}s, params "
          f"{weights / 2**30:.2f} GiB (int8 codes and packed planes, f32 embedding and head), "
          f"{before / 2**30:.2f} GiB live before the build; ring {type(ring).__name__} of "
          f"{ring.width} rows x "
          f"{SLOTS} slots, pools {engine.pool_bytes / 2**30:.3f} GiB", flush=True)
    if engine.cache_kind != "ring" or ring.width != RING_W or ring.window != RING_W:
        raise AssertionError(f"ring phase: backend {engine.cache_kind}, width {ring.width}")
    prompts = ring_prompts(cfg)
    calls = []
    reset_counts(torch)
    with counted_steps(torch, model, calls):
        results, dt = launch.serve(engine, prompts, max_new_tokens=32)
    engine.check_leaks()
    if sorted(results) != list(range(16)) or any(len(v) != 32 for v in results.values()):
        raise AssertionError(f"ring serve: {len(results)} results, lengths "
                             f"{sorted(len(v) for v in results.values())}")
    n = check_ring_steps(cfg, calls)
    toks = sum(len(v) for v in results.values())
    peak = torch.cuda.max_memory_allocated()
    print(f"serve [starcoder2-15b, EN-T w8a8, ring]: 16 requests (prompts "
          f"{min(map(len, prompts))}..{max(map(len, prompts))} tokens) x 32 new tokens on 8 "
          f"slots: {toks} tokens in {dt:.3f}s = {toks / dt:.2f} tok/s; {n['tick']} decode "
          f"ticks, {n['chunk']} prefill chunks; per tick kernel 1 "
          f"{projections(cfg) * cfg.num_layers} on the stream and the ring decode "
          f"{cfg.num_layers} (kernel 2 0), per chunk kernel 1 {projections(cfg) * cfg.num_layers} "
          f"on the tensor-core loop and kernel 2 {cfg.num_layers} "
          f"(window {cfg.sliding_window}); kernel 3 and plain versions 0; peak "
          f"{peak / 2**30:.2f} GiB", flush=True)

    # refill over stale rows, and a full batch to time
    first = list(range(SLOTS))
    for u in first:
        engine.submit(prompts[u], max_new_tokens=8)
    engine.step()                       # 8 admissions over stale rings + 1 tick
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        engine.step()
    torch.cuda.synchronize()
    host = (time.perf_counter() - t0) * 1e3 / 3
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            engine.step()
        torch.cuda.synchronize()
        under = (time.perf_counter() - t0) * 1e3 / 3
    again = engine.run()
    engine.check_leaks()
    same = sum(again[16 + i] == results[u][:8] for i, u in enumerate(first))
    if same != SLOTS:
        raise AssertionError(f"ring refill over stale rows: {same} of {SLOTS} streams equal "
                             "the first admission's")
    dev = device_ms_by_kernel(prof, 3)
    busy = sum(dev.values())
    ring_ms = sum(v for k, v in dev.items() if "paged_decode_tc" in k)
    copies = copy_ms(prof, 3)
    idle = "not measured" if not busy else f"{100 * (1 - busy / host):.1f}% idle"
    print(f"ring refill: the first wave's 8 prompts re-admitted over stale rings, 8 of 8 "
          f"streams equal; decode tick (8 slots, full width): {host:.3f} ms host-clock "
          f"({under:.3f} ms under the profiler); device busy {busy:.3f} ms/tick ({idle}); "
          f"the ring decode (paged_decode_tc, ring form) {ring_ms:.3f} ms/tick"
          + (f" ({100 * ring_ms / busy:.1f}% of busy)" if busy else "")
          + f"; copies: aten::copy_ {copies['op_ms']:.3f} ms/tick on the device, copy "
          f"kernels {copies['kernels_ms']:.3f} ms/tick ({copies['launches']:.0f} launches)",
          flush=True)
    for name, ms in sorted(dev.items(), key=lambda kv: -kv[1])[:8]:
        print(f"  {ms:9.3f} ms/tick  {name[:90]}")
    ring_launches = sum(c[1]["ring_decode_attention"] for c in calls)
    del engine, params, model
    torch.cuda.empty_cache()
    return dict(tok_s=toks / dt, seconds=dt, ticks=n["tick"], chunks=n["chunk"],
                peak_gib=peak / 2**30, weights_gib=weights / 2**30,
                live_before_gib=before / 2**30, init_s=init_s,
                tick_host_ms=host, tick_busy_ms=busy, tick_ring_ms=ring_ms,
                tick_copies=copies, ring_launches=ring_launches, by_kernel=dict(
                    sorted(dev.items(), key=lambda kv: -kv[1])[:10]))


def kernels_vs_plain_ring(torch, bound, kv_quant=False):
    """The ring's model-level path at 2 layers of full-width starcoder2-15b
    (bf16, EN-T; ``kv_quant``: an int8 KV ring, whose decode reads take the
    ring decode's int8-KV form), with the kernels and with the plain versions: a
    RING_CHECK-token prompt in two chunks (4,096 rows, then 1,024 over the
    wrap), the logits of every row of the second chunk, and 4
    teacher-forced decode ticks.  Fails when the logits' relative L2
    difference exceeds ``bound`` or when the planted fault "context read
    after the chunk's write" stays within it: the fault hands query t of
    the second chunk its own chunk's rows in place of the retained
    positions t + 1 .. 1,023, which only that chunk's rows see (the last
    row's window starts past them), so every row of it is compared."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as launch
    from repro_torch.models import attention
    from repro_torch.models.transformer import Model

    cfg = dataclasses.replace(get_config("starcoder2-15b"), num_layers=2)
    model, params = launch.build(cfg, seed=1, quantize=True, kv_quant=kv_quant)
    plain_model = Model(cfg, use_kernels=False, kv_quant=kv_quant)
    rng = np.random.default_rng(3)
    dev = model.device
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, RING_CHECK[0]))).to(dev)
    forced = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 1))).to(dev)

    w = cfg.sliding_window

    def run(m):
        cache = m.init_cache(1, RING_CHECK[1], kind="ring")
        cache = m.apply(params, toks[:, :w], cache=cache, write_cache=True,
                        need_logits=False)["cache"]
        out = m.apply(params, toks[:, w:], cache=cache, write_cache=True, pos0=w)
        cache, seq = out["cache"], [out["logits"][0]]
        for i in range(4):
            logits, cache = m.decode_step(params, cache, forced[i])
            seq.append(logits)
        return torch.cat(seq)

    def rel(a, b):
        return float((a - b).norm() / b.norm())

    reset_counts(torch)
    a = run(model)
    counts = step_counts(torch)
    nl = cfg.num_layers
    if counts["plain"] or counts["ring_decode_attention"] != 4 * nl or \
            counts["ring_decode_attention[int8_kv]"] != 4 * nl * kv_quant:
        raise AssertionError(f"ring case: kernel run counts {counts}")
    t0 = time.perf_counter()
    b = run(plain_model)
    plain_s = time.perf_counter() - t0
    if a.shape != (RING_CHECK[0] - w + 4, cfg.padded_vocab) or not torch.isfinite(a).all():
        raise AssertionError(f"ring case: logits shape {tuple(a.shape)} / finite "
                             f"{bool(torch.isfinite(a).all())}")
    sound = rel(a, b)
    with planted(attention, "prefill_step", context_after_write):
        fault = rel(run(model), b)
    print(f"2-layer full width, bfloat16, EN-T weights, {'int8' if kv_quant else 'bf16'} KV "
          f"ring: a {RING_CHECK[0]}-token prompt "
          f"(chunks {w} + {RING_CHECK[0] - w} over the wrap, every row of the second compared) "
          f"and 4 decode ticks; kernels vs plain: relative L2 "
          f"{sound:.3e} (limit {bound}), max abs diff {float((a - b).abs().max()):.3e}, greedy "
          f"agreement {float((a.argmax(-1) == b.argmax(-1)).float().mean()):.3f}; planted fault "
          f"'context read after the chunk's write': relative L2 {fault:.3e} "
          f"({'over' if fault > bound else 'within'} the limit); kernel counts {counts}; the "
          f"plain run took {plain_s:.1f}s", flush=True)
    if sound > bound:
        raise AssertionError(f"ring case: kernel path disagrees with the plain path "
                             f"(relative L2 {sound} > {bound})")
    if fault <= bound:
        raise AssertionError(f"ring case: the limit {bound} misses the planted fault")
    return dict(relative_l2=sound, fault=fault, counts=counts)


SERVE_MAX_LEN = 576   # the 256..512-token serve phases' engine width: prompt bucket + 32 new
MIXTRAL_LAYERS = 16   # of mixtral-8x7b's 32: its bf16 experts are 2.8 GB a layer


def check_steps(label, calls, want, windows=None):
    """Every recorded step (``counted_steps``) launched what ``want[kind]``
    says (the keys it names), kernel 2 with ``windows[kind]`` when given.
    Returns the steps by kind."""
    for i, (kind, got, seen) in enumerate(calls):
        got = {k: got[k] for k in want[kind]}
        if got != want[kind] or (windows is not None and seen != windows[kind]):
            raise AssertionError(f"{label} {kind} {i}: launches {got}, kernel 2's windows "
                                 f"{sorted(set(seen))} x {len(seen)}; expected {want[kind]}")
    return {k: sum(kind == k for kind, _, _ in calls) for k in want}


def serving_want(cfg, tick, chunk):
    """The counters of ``step_counts`` at 0 for every serving kernel but
    those ``tick`` and ``chunk`` name (their counts a decode tick and a
    prefill chunk)."""
    keys = ("ent_matmul_packed_fused[stream]", "ent_matmul_packed_fused[tc]",
            "flash_attention_masked", "flash_attention_masked[tensor-core]",
            "flash_attention_masked[offsets]", "ring_decode_attention",
            "ring_decode_attention[int8_kv]", "paged_attention_kernel", "ssd_prefill",
            *(f"ssd_prefill[{part}]" for part in SSD_FWD_PARTS), "ssd_scan", "plain")
    return {kind: {k: want.get(k, 0) for k in keys}
            for kind, want in (("tick", tick), ("chunk", chunk))}


def profile_full_ticks(torch, engine, prompts, what, ticks=3):
    """Fill the engine's slots with ``prompts`` (8 new tokens each), then
    ``ticks`` decode ticks by host clock and ``ticks`` more under
    torch.profiler: device busy a tick, its idle share, the CUDA kernels
    launched a tick, device ms by kernel.  Drains the engine."""
    from torch.profiler import ProfilerActivity, profile
    for p in prompts:
        engine.submit(p, max_new_tokens=8)
    engine.step()                       # the admissions + 1 tick
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ticks):
        engine.step()
    torch.cuda.synchronize()
    host = (time.perf_counter() - t0) * 1e3 / ticks
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(ticks):
            engine.step()
        torch.cuda.synchronize()
        under = (time.perf_counter() - t0) * 1e3 / ticks
    engine.run()
    engine.check_leaks()
    dev = device_ms_by_kernel(prof, ticks)
    busy = sum(dev.values())
    kernels = sum(ev.count for ev in prof.key_averages()
                  if getattr(ev, "device_type", None) is not None
                  and str(ev.device_type).endswith("CUDA")) / ticks
    idle = None if not busy else 1 - busy / host
    print(f"{what}: decode tick (8 slots, full width) {host:.3f} ms host-clock ({under:.3f} ms "
          f"under the profiler); device busy {busy:.3f} ms/tick ("
          + ("idle not measured" if idle is None else f"{100 * idle:.1f}% idle")
          + f"); {kernels:.0f} CUDA kernels launched a tick", flush=True)
    for name, ms in sorted(dev.items(), key=lambda kv: -kv[1])[:8]:
        print(f"  {ms:9.3f} ms/tick  {name[:90]}")
    return dict(host_ms=host, under_ms=under, busy_ms=busy, idle=idle, kernels_a_tick=kernels,
                by_kernel=dict(sorted(dev.items(), key=lambda kv: -kv[1])[:10]))


def serve_mamba2(torch):
    """SSM serving on full-width mamba2-370m (48 layers, d_model 1024, 32
    SSD heads of P 64, N 128, conv width 4, vocab 50280; EN-T weights from
    seed 0, quantized layer by layer on the card): the paged engine, 8
    slots, prefix caching "auto" (off: SSM layers), 16 greedy requests of
    256..512 prompt tokens (``ragged_prompts``, seed 0), 32 new tokens
    each.  Every decode tick must launch kernel 1 twice a layer (in_proj,
    out_proj) on the split-K stream and nothing else of the port's kernels;
    every admission prefill kernel 1 twice a layer on the tensor-core loop
    and 8p once a layer (each of its three launches once); no attention
    kernel, no plain version.  Then 3 full-batch ticks timed and profiled.
    Then speculative decoding (k = SPEC_K, the target's own layer 0 as the
    drafter) on the first 8 prompts: its launches, acceptance and tokens a
    tick, its streams against the plain run's under ``flip_margins``
    (every flip must sit on a near-tie).  Returns the numbers."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as launch
    from repro_torch.runtime.serve_loop import ServeEngine

    cfg = get_config("mamba2-370m")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, params = launch.build(cfg, seed=0, quantize=True)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    engine = ServeEngine(model, params, slots=SLOTS, max_len=SERVE_MAX_LEN, page_size=16, seed=0)
    if engine.cache_kind != "paged" or engine.prefix_stats is not None:
        raise AssertionError(f"mamba2 serve: backend {engine.cache_kind}, prefix cache "
                             f"{engine.prefix_stats}")
    print(f"mamba2-370m full width ({cfg.num_layers} layers, d_model {cfg.d_model}, SSD "
          f"{cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim} heads x P {cfg.ssm.head_dim}, N "
          f"{cfg.ssm.state_dim}, conv width {cfg.ssm.conv_width}, vocab {cfg.vocab_size}), EN-T "
          f"w8a8: init + quantize {init_s:.2f}s, params {param_bytes(params) / 2**30:.3f} GiB; "
          f"SSM states {engine.ssm_bytes} bytes ({engine.ssm_bytes / 2**20:.1f} MiB) for 8 "
          f"slots, KV pools {engine.pool_bytes - engine.ssm_bytes} bytes", flush=True)
    prompts = launch.ragged_prompts(np.random.default_rng(0), 16, 256, 512, cfg.vocab_size)
    nl = cfg.num_layers
    want = serving_want(cfg, {"ent_matmul_packed_fused[stream]": 2 * nl},
                        {"ent_matmul_packed_fused[tc]": 2 * nl, "ssd_prefill": nl,
                         **{f"ssd_prefill[{part}]": nl for part in SSD_FWD_PARTS}})
    calls, rows = [], {}
    reset_counts(torch)
    with emitted_rows(engine, rows), counted_steps(torch, model, calls):
        results, dt = launch.serve(engine, prompts, max_new_tokens=32)
    engine.check_leaks()
    if sorted(results) != list(range(16)) or any(len(v) != 32 for v in results.values()):
        raise AssertionError(f"mamba2 serve: {len(results)} results, lengths "
                             f"{sorted(len(v) for v in results.values())}")
    n = check_steps("mamba2 serve", calls, want)
    if n["chunk"] != 16:
        raise AssertionError(f"mamba2 serve: {n['chunk']} prefills for 16 admissions")
    toks = sum(len(v) for v in results.values())
    peak = torch.cuda.max_memory_allocated()
    prefill_launches = sum(c[1]["ssd_prefill"] for c in calls)
    print(f"serve [mamba2-370m, EN-T w8a8]: 16 requests (prompts {min(map(len, prompts))}.."
          f"{max(map(len, prompts))} tokens) x 32 new tokens on 8 slots: {toks} tokens in "
          f"{dt:.3f}s = {toks / dt:.2f} tok/s; {n['tick']} decode ticks, {n['chunk']} prefills; "
          f"per tick kernel 1 {2 * nl} on the stream, per prefill kernel 1 {2 * nl} on the "
          f"tensor-core loop and 8p {nl} (x3 launches); attention kernels and plain versions "
          f"0; peak {peak / 2**30:.2f} GiB", flush=True)
    ssm_bytes = engine.ssm_bytes
    tick = profile_full_ticks(torch, engine, prompts[:SLOTS], "mamba2-370m")
    del engine
    spec = serve_mamba2_spec(torch, cfg, model, params, prompts[:SLOTS],
                             {u: results[u] for u in range(SLOTS)}, rows)
    rows.clear()
    del model, params
    torch.cuda.empty_cache()
    return dict(tok_s=toks / dt, seconds=dt, ticks=n["tick"], prefills=n["chunk"],
                ssd_prefill_launches=prefill_launches, peak_gib=peak / 2**30, init_s=init_s,
                ssm_bytes=ssm_bytes, tick=tick, spec=spec,
                launches_by_part={part: sum(c[1][f"ssd_prefill[{part}]"] for c in calls)
                                  for part in SSD_FWD_PARTS},
                kernel1={r: sum(c[1][f"ent_matmul_packed_fused[{r}]"] for c in calls)
                         for r in ("stream", "tc")})


def serve_mamba2_spec(torch, cfg, model, params, prompts, plain_streams, plain_rows):
    """Speculative decoding on full-width mamba2-370m: the 8 ``prompts``
    (uids 0..7 of the plain run), 32 new tokens each, k = SPEC_K, the
    target's own layer 0 as the drafter (``spec_drafters``).  Its launches,
    counted over the run, must be per spec tick T and admission A: kernel
    1 on the split-K stream 2 a layer for each of the drafter's K + 1
    steps, on the tensor-core loop 2 a layer for the verify burst (M = 8
    (K + 1)) and for both prefills of each admission, 8p a layer of both
    prefills, nothing else of the port's kernels and no plain version.
    Reports acceptance and tokens a tick; the streams against the plain
    run's, every flip at a near-tie (``flip_margins``).  Returns the
    numbers."""
    from repro_torch.launch import serve as launch
    from repro_torch.runtime.serve_loop import ServeEngine
    dm, dp = spec_drafters(cfg, model, params)["truncated (layer 0)"]
    engine = ServeEngine(model, params, slots=SLOTS, max_len=SERVE_MAX_LEN, page_size=16,
                         seed=0, draft_model=dm, draft_params=dp, spec_k=SPEC_K)
    rows = {}
    reset_counts(torch)
    with emitted_rows(engine, rows):
        results, dt = launch.serve(engine, prompts, max_new_tokens=32)
    got = step_counts(torch)
    engine.check_leaks()
    if sorted(results) != list(range(SLOTS)) or any(len(v) != 32 for v in results.values()):
        raise AssertionError(f"mamba2 spec: {len(results)} results")
    st, rate = dict(engine.spec_stats), engine.acceptance_rate
    ticks, adm, nl, dl = st["ticks"], len(prompts), cfg.num_layers, dm.cfg.num_layers
    want = serving_want(cfg, {"ent_matmul_packed_fused[stream]": (SPEC_K + 1) * 2 * dl * ticks,
                              "ent_matmul_packed_fused[tc]": 2 * nl * ticks
                              + 2 * (nl + dl) * adm, "ssd_prefill": (nl + dl) * adm,
                              **{f"ssd_prefill[{part}]": (nl + dl) * adm
                                 for part in SSD_FWD_PARTS}}, {})["tick"]
    seen = {k: got[k] for k in want}
    if seen != want:
        raise AssertionError(f"mamba2 spec: launches {seen}, expected {want} ({ticks} spec "
                             f"ticks, {adm} admissions)")
    flips, ordinary = flip_margins(plain_rows, rows, plain_streams, results)
    faults = [f for f in flips if f["fault"]]
    same = sum(results[u] == plain_streams[u] for u in results)
    toks = sum(len(v) for v in results.values())
    print(f"serve [mamba2-370m, EN-T w8a8, speculative k={SPEC_K}, truncated (layer 0) "
          f"drafter]: 8 requests x 32 new tokens: {toks} tokens in {dt:.3f}s = {toks / dt:.2f} "
          f"tok/s; acceptance {rate:.4f}; {st['emitted'] / ticks:.3f} tokens a tick; spec stats "
          f"{st}; streams equal to plain decode's {same} of 8; at each first divergence plain "
          "top-1 minus top-2 / plain gap to the emitted token / |logit difference|: "
          + ("; ".join(f"uid {f['uid']} token {f['index']}: {f['top1_minus_top2']:.4f} / "
                       f"{f['gap']:.4f} / {f['delta']:.4f}" for f in flips) or "none")
          + f"; the paths' largest |logit difference| before any divergence {ordinary:.4f}; "
          f"flips above twice it (faults) {len(faults)} of {len(flips)}; launches {seen}",
          flush=True)
    if faults:
        raise AssertionError(f"mamba2 spec: flips off the near-ties {faults}")
    rows.clear()
    return dict(tok_s=toks / dt, acceptance=rate, tokens_per_tick=st["emitted"] / ticks,
                stats=st, streams_equal_plain=same, flips=flips, ordinary_delta=ordinary,
                launches=seen)


def serve_mixtral(torch):
    """MoE serving on mixtral-8x7b at full width, MIXTRAL_LAYERS of its 32
    layers (d_model 4096, 32 / 8 heads of 128, d_ff 14336, 8 experts top-2,
    vocab 32000, window 4096, rope theta 1e6; ``param_dtype`` bfloat16:
    the reference casts every expert to the compute dtype before its
    product, so bf16 storage changes no product; weights from seed 0, the
    attention projections EN-T, the router and the experts float, bf16 KV
    on the ring, the cache "auto"): 8 slots, the same 16 requests x 32 new
    tokens.  Every decode tick must launch kernel 1 four times a layer (q,
    k, v, o) on the split-K stream and the ring decode once a layer; every
    admission prefill kernel 1 four times a layer on the tensor-core loop
    and kernel 2 once a layer (window 4096, tensor-core); nothing else of
    the port's kernels, no plain version.  Prints each tick's dropped
    expert assignments (the capacity at T = 8 tokens is 3).  Then 3
    full-batch ticks timed and profiled.  Returns the numbers."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as launch
    from repro_torch.models import moe
    from repro_torch.runtime.serve_loop import ServeEngine

    cfg = dataclasses.replace(get_config("mixtral-8x7b"), num_layers=MIXTRAL_LAYERS,
                              param_dtype="bfloat16")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, params = launch.build(cfg, seed=0, quantize=True)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    experts = sum(param_bytes({k: v for k, v in layer["ffn"].items() if k != "router"})
                  for layer in params["layers"])
    engine = ServeEngine(model, params, slots=SLOTS, max_len=SERVE_MAX_LEN, seed=0)
    ring = engine.cache["layers"][0]
    print(f"mixtral-8x7b full width, {cfg.num_layers} of 32 layers (d_model {cfg.d_model}, "
          f"{cfg.num_heads}/{cfg.num_kv_heads} heads, head_dim {cfg.head_dim}, d_ff {cfg.d_ff}, "
          f"{cfg.moe.num_experts} experts top-{cfg.moe.top_k}, capacity factor "
          f"{cfg.moe.capacity_factor}, vocab {cfg.vocab_size}, window {cfg.sliding_window}), "
          f"EN-T attention, float router and experts, param_dtype {cfg.param_dtype}: init + "
          f"quantize {init_s:.2f}s, params {param_bytes(params) / 2**30:.2f} GiB (experts "
          f"{experts / 2**30:.2f} GiB); {engine.cache_kind} of {ring.width} rows x {SLOTS} slots, "
          f"KV {engine.pool_bytes / 2**20:.1f} MiB", flush=True)
    if engine.cache_kind != "ring":
        raise AssertionError(f"mixtral serve: backend {engine.cache_kind}")
    prompts = launch.ragged_prompts(np.random.default_rng(0), 16, 256, 512, cfg.vocab_size)
    nl = cfg.num_layers
    want = serving_want(cfg, {"ent_matmul_packed_fused[stream]": 4 * nl,
                              "ring_decode_attention": nl},
                        {"ent_matmul_packed_fused[tc]": 4 * nl, "flash_attention_masked": nl,
                         "flash_attention_masked[tensor-core]": nl})
    calls, dropped = [], []

    def count_drops(f):
        def dispatch(cfg_, idx):
            flat, pos, keep = f(cfg_, idx)
            dropped.append((len(calls), idx.shape[0], (~keep).sum()))
            return flat, pos, keep
        return dispatch

    reset_counts(torch)
    with counted_steps(torch, model, calls), planted(moe, "dispatch", count_drops):
        results, dt = launch.serve(engine, prompts, max_new_tokens=32)
    engine.check_leaks()
    if sorted(results) != list(range(16)) or any(len(v) != 32 for v in results.values()):
        raise AssertionError(f"mixtral serve: {len(results)} results, lengths "
                             f"{sorted(len(v) for v in results.values())}")
    n = check_steps("mixtral serve", calls, want,
                    {"tick": [], "chunk": [cfg.sliding_window] * nl})
    by_call = [0] * len(calls)
    for i, _, d in dropped:
        by_call[i] += int(d)
    tick_drops = [d for (kind, _, _), d in zip(calls, by_call) if kind == "tick"]
    prefill_drops = [d for (kind, _, _), d in zip(calls, by_call) if kind == "chunk"]
    toks = sum(len(v) for v in results.values())
    peak = torch.cuda.max_memory_allocated()
    print(f"serve [mixtral-8x7b {nl} layers, EN-T attention, float experts, ring]: 16 requests "
          f"(prompts {min(map(len, prompts))}..{max(map(len, prompts))} tokens) x 32 new tokens "
          f"on 8 slots: {toks} tokens in {dt:.3f}s = {toks / dt:.2f} tok/s; {n['tick']} decode "
          f"ticks, {n['chunk']} prefills; per tick kernel 1 {4 * nl} on the stream and the ring "
          f"decode {nl}, per prefill kernel 1 {4 * nl} on the tensor-core loop and kernel 2 {nl} "
          f"(window {cfg.sliding_window}); plain versions 0; dropped expert assignments a tick "
          f"(of {2 * SLOTS * nl}, capacity {moe.capacity(cfg, SLOTS)} a layer) {tick_drops}, a "
          f"prefill {prefill_drops}; peak {peak / 2**30:.2f} GiB", flush=True)
    tick = profile_full_ticks(torch, engine, prompts[:SLOTS], "mixtral-8x7b")
    del engine, params, model
    torch.cuda.empty_cache()
    return dict(tok_s=toks / dt, seconds=dt, ticks=n["tick"], prefills=n["chunk"],
                tick_drops=tick_drops, prefill_drops=prefill_drops, peak_gib=peak / 2**30,
                init_s=init_s, experts_gib=experts / 2**30, tick=tick,
                ring_launches=sum(c[1]["ring_decode_attention"] for c in calls),
                flash_launches=sum(c[1]["flash_attention_masked"] for c in calls),
                kernel1={r: sum(c[1][f"ent_matmul_packed_fused[{r}]"] for c in calls)
                         for r in ("stream", "tc")})


def kernels_vs_plain_serving(torch, arch, bound):
    """The serving path of 2 full-width layers of ``arch`` (mamba2-370m, or
    mixtral-8x7b with bf16 params), bf16, EN-T, with the kernels and with
    the plain versions: a 300-token prompt with 20 left pads prefilled in
    chunks of 256 rows (the second chunk enters from the first one's
    state), then 4 teacher-forced decode ticks.  Readings: the relative L2
    of the 5 logits rows and, for mamba2, of each SSM layer's SSD state
    after the prefill (the larger); both must stay within ``bound``.  For
    mamba2 the planted faults "entering state ignored" and "leaving state
    of the last-but-one chunk" (8p's faults 5 and 6, at the model's call)
    must read over it.  Returns the readings."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.launch import serve as launch
    from repro_torch.models.kv_cache import SSMCache
    from repro_torch.models.transformer import Model

    extra = {"param_dtype": "bfloat16"} if arch == "mixtral-8x7b" else {}
    cfg = dataclasses.replace(get_config(arch), num_layers=2, **extra)
    model, params = launch.build(cfg, seed=1, quantize=True)
    plain_model = Model(cfg, use_kernels=False)
    rng = np.random.default_rng(5)
    dev = model.device
    n, pads = 300, 20
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, n))).to(dev)
    mask = (torch.arange(n, device=dev) >= pads)[None]
    forced = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 1))).to(dev)

    def run(m):
        cache = m.init_cache(1, 512, kind="auto")
        logits, cache = m.prefill(params, cache, toks, pad_mask=mask, chunk=256)
        states = [c.ssd.clone() for c in cache["layers"] if isinstance(c, SSMCache)]
        seq = [logits]
        for i in range(4):
            logits, cache = m.decode_step(params, cache, forced[i])
            seq.append(logits)
        return torch.cat(seq), states

    def rel(a, b):
        return float((a.float() - b.float()).norm() / b.float().norm())

    def readings(run_a, run_b):
        (la, sa), (lb, sb) = run_a, run_b
        return rel(la, lb), max((rel(x, y) for x, y in zip(sa, sb)), default=0.0)

    reset_counts(torch)
    a = run(model)
    counts = step_counts(torch)
    if counts["plain"] or not torch.isfinite(a[0]).all() or a[0].shape != (5, cfg.padded_vocab):
        raise AssertionError(f"{arch} 2-layer case: counts {counts}, logits "
                             f"{tuple(a[0].shape)}, finite {bool(torch.isfinite(a[0]).all())}")
    b = run(plain_model)
    sound = readings(a, b)
    faults = {}
    if cfg.ssm is not None:
        for f in (5, 6):
            with planted(ssd_ops, "ssd_prefill",
                         lambda real, f=f: lambda *x, **kw: real(*x, fault=f, **kw)):
                faults[SSD_PREFILL_FAULTS[f]] = max(readings(run(model), b))
    print(f"2-layer {arch} full width, bfloat16, EN-T weights: a {n}-token prompt ({pads} left "
          f"pads, chunks of 256) and 4 decode ticks; kernels vs plain: relative L2 of the "
          f"logits {sound[0]:.3e}"
          + (f", of the leaving SSD states {sound[1]:.3e}" if cfg.ssm is not None else "")
          + f" (limit {bound}); greedy agreement "
          f"{float((a[0].argmax(-1) == b[0].argmax(-1)).float().mean()):.3f}; "
          + "".join(f"planted fault '{k}': {v:.3e}; " for k, v in faults.items())
          + f"kernel counts {counts}", flush=True)
    if max(sound) > bound:
        raise AssertionError(f"{arch} 2-layer case: the kernel path disagrees with the plain "
                             f"path ({sound} > {bound})")
    if any(v <= bound for v in faults.values()):
        raise AssertionError(f"{arch} 2-layer case: the limit {bound} misses a planted fault "
                             f"{faults}")
    del model, params, plain_model
    torch.cuda.empty_cache()
    return dict(relative_l2=sound[0], state_relative_l2=sound[1], faults=faults, counts=counts)


def generate_ent(torch, model, params, engine_streams, engine_rows):
    """``generate`` on full-width qwen2.5-3b EN-T (the serving phases'
    model): the EN-T serve phase's first 8 prompts left-padded to the
    longest with ``prompt_lens``, 32 greedy steps, ``cache_kind`` auto (dense
    rows).  The prefill launches kernel 1 once per projection and layer on
    the tensor-core loop and kernel 2 once per layer; each decode step
    kernel 1 on the split-K stream and kernel 2 with per-sequence offsets
    once per layer; kernel 3 and the plain versions never.  Counts the
    streams equal to the engine's for the same prompts (only tolerance is
    owed: the engine prefills each prompt alone, padded to a power of two,
    and decodes through kernel 3), and at each stream's first divergence
    from the engine's logs the margins of ``flip_margins`` (``engine_rows``:
    the logits each engine token was sampled from).  The prefill's logits
    are held against the plain model (``use_kernels=False``) on the same
    padded batch, beside the engine's first-token logits against the same
    plain logits: both paths' distance from the exact math.  Returns the
    numbers."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as launch
    from repro_torch.models.transformer import Model
    from repro_torch.runtime import sampling
    from repro_torch.runtime.serve_loop import _pad_mask_from_lens, generate

    cfg = get_config("qwen2.5-3b")
    prompts = launch.ragged_prompts(np.random.default_rng(0), 16, 256, 512,
                                    cfg.vocab_size)[:SLOTS]
    lens = [len(p) for p in prompts]
    s0 = max(lens)
    toks = np.zeros((SLOTS, s0), np.int64)
    for i, p in enumerate(prompts):
        toks[i, s0 - len(p):] = p
    calls, steps = [], []
    reset_counts(torch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with counted_steps(torch, model, calls), planted(sampling, "greedy", recorded(steps)):
        out = generate(model, params, toks, 32, prompt_lens=lens).cpu().numpy()
    dt = time.perf_counter() - t0
    per, nl = projections(cfg) * cfg.num_layers, cfg.num_layers
    ticks = [c for k, c, _ in calls if k == "tick"]
    chunks = [c for k, c, _ in calls if k == "chunk"]
    want_tick = {"ent_matmul_packed_fused[stream]": per, "ent_matmul_packed_fused[tc]": 0,
                 "flash_attention_masked[offsets]": nl, "flash_attention_masked": nl,
                 "paged_attention_kernel": 0, "plain": 0}
    want_chunk = {"ent_matmul_packed_fused[tc]": per, "ent_matmul_packed_fused[stream]": 0,
                  "flash_attention_masked": nl, "flash_attention_masked[offsets]": 0,
                  "paged_attention_kernel": 0, "plain": 0}
    bad = [c for c in ticks if {k: c[k] for k in want_tick} != want_tick] + \
        [c for c in chunks if {k: c[k] for k in want_chunk} != want_chunk]
    if out.shape != (SLOTS, 32) or len(ticks) != 31 or len(chunks) != 1 or bad:
        raise AssertionError(f"generate: out {out.shape}, {len(ticks)} decode steps, "
                             f"{len(chunks)} prefill chunks; off counts {bad[:2]}")
    streams = {i: out[i].tolist() for i in range(SLOTS)}
    same = sum(streams[i] == engine_streams[i] for i in range(SLOTS))
    first = [first_difference(streams[i], engine_streams[i]) for i in range(SLOTS)]
    rows = {(i, j): lg[i] for j, lg in enumerate(steps) for i in range(SLOTS)}
    flips, ordinary = flip_margins(engine_rows, rows, engine_streams, streams)
    faults = [f for f in flips if f["fault"]]
    logits = steps[0].float()
    mask, start = _pad_mask_from_lens(lens, SLOTS, s0, model.device)
    plain = Model(cfg, use_kernels=False)
    cache = plain.init_cache(SLOTS, s0 + 32, kind="auto")
    cache["start"] = start
    exact = plain.prefill(params, cache, torch.from_numpy(toks).to(model.device),
                          pad_mask=mask)[0].float()
    del cache, plain
    eng = torch.stack([engine_rows[(i, 0)] for i in range(SLOTS)]).float()

    def rel(a, b):
        return float((a - b).norm() / b.norm())

    agree = int((logits.argmax(-1) == eng.argmax(-1)).sum())
    vs_plain = dict(generate=rel(logits, exact), engine=rel(eng, exact),
                    generate_argmax_equal=int((logits.argmax(-1) == exact.argmax(-1)).sum()),
                    engine_argmax_equal=int((eng.argmax(-1) == exact.argmax(-1)).sum()))
    print(f"generate [qwen2.5-3b, EN-T w8a8, dense rows]: 8 prompts ({min(lens)}..{s0} tokens, "
          f"left-padded to {s0}) x 32 greedy steps in {dt:.3f}s ({8 * 32 / dt:.2f} tok/s); per "
          f"step kernel 1 {per} on the stream and kernel 2 {nl} with per-sequence offsets, the "
          f"prefill kernel 1 {per} on the tensor-core loop and kernel 2 {nl}; kernel 3 and plain "
          f"versions 0; streams equal to the engine's {same} of 8 (first differing token of "
          f"each: {first}); the prefill's logits against the engine's admissions': relative L2 "
          f"{rel(logits, eng):.3e}, argmax equal {agree} of 8; against the plain model's "
          f"prefill of the same padded batch: generate {vs_plain['generate']:.3e} (argmax "
          f"equal {vs_plain['generate_argmax_equal']} of 8), the engine's first-token logits "
          f"{vs_plain['engine']:.3e} (argmax equal {vs_plain['engine_argmax_equal']} of 8)",
          flush=True)
    print("  generate: at each stream's first divergence from the engine's, engine top-1 minus "
          "top-2 / engine gap to generate's token / |logit difference| between the paths: "
          + "; ".join(f"row {f['uid']} token {f['index']}: {f['top1_minus_top2']:.4f} / "
                      f"{f['gap']:.4f} / {f['delta']:.4f}" for f in flips)
          + f"; the paths' largest |logit difference| before any divergence {ordinary:.4f}; "
          f"flips above twice it (faults): {len(faults)} of {len(flips)}", flush=True)
    return dict(tok_s=8 * 32 / dt, streams_equal_engine=same, first_difference=first,
                prefill_relative_l2=rel(logits, eng), prefill_argmax_equal=agree,
                prefill_vs_plain=vs_plain,
                near_ties=dict(flips=flips, ordinary_delta=ordinary, faults=len(faults)))


def recorded(seen):
    """A ``planted`` wrap that appends each logits tensor the sampler is
    handed to ``seen`` and samples as before."""
    def wrap(real):
        def sample(logits, *a, **kw):
            seen.append(logits)
            return real(logits, *a, **kw)
        return sample
    return wrap


def kernels_vs_plain_generate(torch, bound):
    """``generate`` at 2 layers of full-width qwen2.5-3b (bf16, EN-T), with
    the kernels and with the plain versions: 8 ragged prompts (40..256
    tokens) left-padded with ``prompt_lens``, 16 greedy steps, cache_kind
    auto (dense rows).  Each row's logits are compared up to its first
    token where the two streams differ (past it the paths decode different
    inputs); fails when their relative L2 difference exceeds ``bound``, or
    when the planted fault "prompt_lens ignored" (no pad mask and no
    start: the prefill attends the left padding at absolute positions)
    stays within it.  Returns the numbers."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as launch
    from repro_torch.models.transformer import Model
    from repro_torch.runtime import sampling, serve_loop

    cfg = dataclasses.replace(get_config("qwen2.5-3b"), num_layers=2)
    model, params = launch.build(cfg, seed=1, quantize=True)
    plain_model = Model(cfg, use_kernels=False)
    prompts = launch.ragged_prompts(np.random.default_rng(4), SLOTS, 40, 256, cfg.vocab_size)
    lens = [len(p) for p in prompts]
    toks = np.zeros((SLOTS, max(lens)), np.int64)
    for i, p in enumerate(prompts):
        toks[i, max(lens) - len(p):] = p

    def run(m):
        seen = []
        with planted(sampling, "greedy", recorded(seen)):
            out = serve_loop.generate(m, params, toks, 16, prompt_lens=lens).cpu().tolist()
        return out, torch.stack(seen, 1).float()   # [B, steps, V]

    def compared(a, b):
        """Each row's logits up to its streams' first difference, stacked."""
        (sa, la), (sb, lb) = a, b
        cut = [min(first_difference(x, y), len(x) - 1) + 1 for x, y in zip(sa, sb)]
        return (torch.cat([la[i, :c] for i, c in enumerate(cut)]),
                torch.cat([lb[i, :c] for i, c in enumerate(cut)]), cut)

    def rel(a, b):
        return float((a - b).norm() / b.norm())

    reset_counts(torch)
    got = run(model)
    counts = step_counts(torch)
    if counts["plain"] or counts["flash_attention_masked[offsets]"] != 15 * cfg.num_layers:
        raise AssertionError(f"generate 2-layer: kernel run counts {counts}")
    want = run(plain_model)
    a, b, cut = compared(got, want)
    sound = rel(a, b)
    with planted(serve_loop, "_pad_mask_from_lens", lambda real: lambda *a: (None, None)):
        fa, fb, _ = compared(run(model), want)
    fault = rel(fa, fb)
    same = sum(x == y for x, y in zip(got[0], want[0]))
    print(f"2-layer full width, bfloat16, EN-T weights, generate: 8 prompts ({min(lens)}.."
          f"{max(lens)} tokens, left-padded) x 16 greedy steps, cache_kind auto (dense rows); "
          f"kernels vs plain over each row's logits up to its first differing token "
          f"({sum(cut)} rows; streams equal {same} of 8): relative L2 {sound:.3e} (limit "
          f"{bound}), argmax agreement {float((a.argmax(-1) == b.argmax(-1)).float().mean()):.3f}"
          f"; planted fault 'prompt_lens ignored': relative L2 {fault:.3e} "
          f"({'over' if fault > bound else 'within'} the limit); kernel counts {counts}",
          flush=True)
    if sound > bound:
        raise AssertionError(f"generate 2-layer: kernel path disagrees with the plain path "
                             f"(relative L2 {sound} > {bound})")
    if fault <= bound:
        raise AssertionError(f"generate 2-layer: the limit {bound} misses the planted fault")
    return dict(relative_l2=sound, fault=fault, rows_compared=sum(cut), streams_equal=same,
                counts=counts)


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


def check_train_step(rec, names, expected, tc_names):
    """One training step's record against its path: each kernel of the
    path launched its ``expected`` count, the ``tc_names`` all on the
    tensor-core route, nothing else of the port's kernels, no plain
    version or plain D_i pass, a finite loss and grad-norm."""
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


# the checkpoint phase's directory, inside the checkout (~5 GB for
# mamba2-370m's params, m and v in float32), removed when the phase ends
CKPT_DIR = os.path.join(HERE, "_ckpt_smoke")


class KeepingCheckpointer:
    """The port's checkpointer, keeping a device copy of the last tree it
    saved (the in-memory state the restore is held against, which the
    training step then overwrites in place)."""

    def __init__(self, torch, directory):
        from repro_torch.checkpoint.checkpointer import Checkpointer
        self.torch, self.inner = torch, Checkpointer(directory)
        self.kept = self.saved_step = None

    def save(self, step, tree, **kw):
        self.kept, self.saved_step = clone_tree(self.torch, tree), step
        self.inner.save(step, tree, **kw)

    def __getattr__(self, name):
        return getattr(self.inner, name)


def clone_tree(torch, tree):
    from repro_torch.tree import map_tree
    return map_tree(lambda x: x.detach().clone() if isinstance(x, torch.Tensor) else x, tree)


def named_leaves(tree, prefix=""):
    """(path, leaf) pairs of a param / optimizer tree."""
    if isinstance(tree, dict):
        return [p for k in tree for p in named_leaves(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree) for p in named_leaves(v, f"{prefix}/{i}")]
    return [(prefix, tree)]


def tree_difference(torch, a, b):
    """(max |a - b| over every tensor leaf, the paths of the leaves that
    differ, whether the non-tensor leaves (the step) agree)."""
    worst, differ, same_ints = 0.0, [], True
    for (path, x), (_, y) in zip(named_leaves(a), named_leaves(b)):
        if not isinstance(x, torch.Tensor):
            same_ints &= x == y
            continue
        if not torch.equal(x, y):
            differ.append(path)
            worst = max(worst, float((x.detach().double() - y.detach().double()).abs().max()))
    return worst, differ, same_ints


def checkpoint_resume(torch, ck, cfg, tcfg, ocfg, step_fn, params, opt, stream, read, check,
                      device):
    """The checkpoint phase on a training run that has saved step 2 (``ck``,
    a KeepingCheckpointer) and run step 3 in place into ``params`` /
    ``opt`` (the uninterrupted step 3): the save's snapshot and write
    seconds and bytes; a restore into a fresh ``build`` bit-identical to
    the state saved; step 3 run again from the in-memory state after step
    2 (the repeat) and from the restored one, each on the stream seeked to
    2, each step's launches read into its record by ``read`` and held by
    ``check``.  The repeat is held against
    the uninterrupted step: if bit-identical, the resumed step must be too,
    else it must stay within twice the repeat's difference."""
    from repro_torch.launch import train as launch

    t0 = time.perf_counter()
    ck.wait()
    save = dict(ck.last_save, wait_after_step_3_s=time.perf_counter() - t0)
    shard = os.path.join(ck._step_dir(2), "shard_00000.npz")
    save["file_bytes"] = os.path.getsize(shard)
    save["free_gib_after"] = shutil.disk_usage(HERE).free / 2**30
    print(f"checkpoint of step 2: {save['bytes']} bytes ({save['bytes'] / 2**30:.3f} GiB; "
          f"file {save['file_bytes']} bytes); host snapshot {save['snapshot_s']:.3f} s, write "
          f"(npz + sha256, beside step 3) {save['write_s']:.3f} s, waited "
          f"{save['wait_after_step_3_s']:.3f} s after step 3; {save['free_gib_after']:.2f} GiB "
          f"free", flush=True)
    kept = ck.kept
    t0 = time.perf_counter()
    _, fresh_p, fresh_o, _ = launch.build(cfg, tcfg, ocfg, seed=1)
    latest, restored = ck.restore_latest({"params": fresh_p, "opt": fresh_o})
    del fresh_p, fresh_o
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    worst, differ, same_ints = tree_difference(torch, restored, kept)
    print(f"restore of step {latest} into a fresh build (sha256 verified): {restore_s:.3f} s; "
          f"{len(differ)} of {len(named_leaves(kept))} leaves differ from the saved state, step "
          f"{restored['opt']['adam']['step']} ({'equal' if same_ints else 'DIFFERS'})",
          flush=True)
    if latest != 2 or differ or not same_ints:
        raise AssertionError(f"restored state is not the saved one: step {latest}, leaves "
                             f"{differ[:5]}, max |diff| {worst}, step counter equal {same_ints}")

    def step3(p, o):
        stream.seek(2)
        reset_counts(torch)
        t = time.perf_counter()
        p, o, m = step_fn(p, o, launch.to_device(stream.next(), device))
        rec = dict(step=3, loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                   lr=m["lr"], seconds=time.perf_counter() - t)
        read(rec)
        check(rec)
        return {"params": p, "opt": o}, rec

    uninterrupted = {"params": params, "opt": opt}
    repeat, rec_r = step3(*clone_tree(torch, (kept["params"], kept["opt"])))
    rep_worst, rep_differ, rep_ints = tree_difference(torch, repeat, uninterrupted)
    del repeat
    torch.cuda.empty_cache()
    resumed, rec_s = step3(restored["params"], restored["opt"])
    res_worst, res_differ, res_ints = tree_difference(torch, resumed, uninterrupted)
    del resumed, restored, kept
    ck.kept = None
    torch.cuda.empty_cache()
    deterministic = not rep_differ and rep_ints
    print(f"step 3 again from the in-memory state after step 2: "
          + ("bit-identical to the uninterrupted step 3" if deterministic else
             f"differs from the uninterrupted step 3 in {len(rep_differ)} leaves, max |diff| "
             f"{rep_worst:.3e} (first: {rep_differ[:6]})")
          + f"; loss {rec_r['loss']:.6f}", flush=True)
    print(f"step 3 resumed from the restored checkpoint: "
          + ("bit-identical to the uninterrupted step 3" if not res_differ and res_ints else
             f"differs in {len(res_differ)} leaves, max |diff| {res_worst:.3e} (first: "
             f"{res_differ[:6]})")
          + f"; loss {rec_s['loss']:.6f}", flush=True)
    if not res_ints:
        raise AssertionError("resumed step 3: the step counter differs")
    if deterministic and res_differ:
        raise AssertionError(f"the step is deterministic but the resumed step 3 differs in "
                             f"{res_differ[:5]} (max |diff| {res_worst})")
    if not deterministic and res_worst > 2 * rep_worst:
        raise AssertionError(f"resumed step 3 differs by {res_worst}, over twice the repeat's "
                             f"{rep_worst}")
    return dict(save=save, restore_s=restore_s, deterministic=deterministic,
                repeat=dict(max_abs=rep_worst, leaves=rep_differ, loss=rec_r["loss"],
                            seconds=rec_r["seconds"]),
                resumed=dict(max_abs=res_worst, leaves=res_differ, loss=rec_s["loss"],
                             launches=rec_s["launches"]))


# the multiplier phase's matmul shapes (M, K, N): quickstart's, then the
# decode tick's and a prefill's row count at qwen2.5-3b's widest projection
ENC_MATMUL_SHAPES = ((8, 64, 32), (8, 2048, 11008), (512, 2048, 11008))


def carry_dropped(real):
    """Planted fault for the encoder checks: ``ent_encode_unsigned`` with
    the carry into the next digit ignored (digit 3 still becomes -1), which
    changes every value with a radix-4 digit 3."""
    def ent_encode_unsigned(x, n_bits):
        import torch
        from repro_torch.core import encoding
        a = encoding.radix4_digits(x, n_bits)
        w = torch.where(a >= 3, a - 4, a)
        return w, torch.zeros(a.shape[:-1], dtype=torch.int32, device=a.device)
    return ent_encode_unsigned


def encoder_products(torch, dev, shapes=ENC_MATMUL_SHAPES, seed=23):
    """The checks that hold the encoders against integer ground truth on
    ``dev``: ``ent_multiply`` and ``mbe_multiply`` against a * b for all
    65,536 int8 pairs, decode(encode(x)) against x for every 16-bit value,
    and ``ent_plane_matmul`` / ``ent_packed_matmul`` (kernels 5 / 4 on the
    card) of planes encoded on ``dev`` against the CPU's int32 product at
    ``shapes``.  Returns {check: number of wrong values}."""
    from repro_torch.core import encoding, multiplier
    a = torch.arange(-128, 128, dtype=torch.int32)
    aa, bb = torch.meshgrid(a, a, indexing="ij")
    want = aa * bb
    bad = {}
    for name in ("ent_multiply", "mbe_multiply"):
        got = getattr(multiplier, name)(aa.to(dev), bb.to(dev), 8).cpu()
        bad[name] = int((got != want).sum())
    u16 = torch.arange(2**16, dtype=torch.int32)
    w, carry = encoding.ent_encode_unsigned(u16.to(dev), 16)
    bad["ent decode(encode(x)), 16-bit"] = int(
        (torch.from_numpy(encoding.ent_decode_unsigned(w, carry)) != u16.long()).sum())
    gen = torch.Generator().manual_seed(seed)
    for m, k, n in shapes:
        x = torch.randint(-128, 128, (m, k), generator=gen, dtype=torch.int8)
        wt = torch.randint(-128, 128, (k, n), generator=gen, dtype=torch.int8)
        ref = x.to(torch.int32) @ wt.to(torch.int32)
        planes = multiplier.ent_digit_planes(wt.to(dev))
        xd = x.to(dev)
        for name, out in (("ent_plane_matmul", multiplier.ent_plane_matmul(xd, planes)),
                          ("ent_packed_matmul", multiplier.ent_packed_matmul(
                              xd, multiplier.pack_planes(planes)))):
            bad[f"{name} M={m} K={k} N={n}"] = int((out.cpu() != ref).sum())
    return bad


def encoder_functions(torch, dev):
    """Every ``encoding`` function on ``dev`` against its CPU result over
    all 256 int8 / uint8 values and all 65,536 16-bit values; returns the
    names of those that differ."""
    from repro_torch.core import encoding as E
    wrong = []
    for n_bits, lo, hi in ((8, -128, 128), (16, -2**15, 2**15)):
        s = torch.arange(lo, hi, dtype=torch.int32)
        u = s - lo
        digits, _ = E.ent_encode_unsigned(u, n_bits)
        codes = E.pack_ent_digits(digits)
        cases = {"radix4_digits": (E.radix4_digits, u, n_bits),
                 "ent_encode_unsigned": (E.ent_encode_unsigned, u, n_bits),
                 "ent_encode_signed": (E.ent_encode_signed, s, n_bits),
                 "ent_encode_bitlevel": (E.ent_encode_bitlevel, u, n_bits),
                 "mbe_encode": (E.mbe_encode, s, n_bits),
                 "mbe_control_lines": (E.mbe_control_lines, s, n_bits),
                 "pack_ent_digits": (E.pack_ent_digits, digits),
                 "unpack_ent_digits": (E.unpack_ent_digits, codes)}
        for name, (fn, x, *rest) in cases.items():
            cpu, card = fn(x, *rest), fn(x.to(dev), *rest)
            cpu = cpu if isinstance(cpu, tuple) else (cpu,)
            card = card if isinstance(card, tuple) else (card,)
            on_dev = all(c.device.type == torch.device(dev).type for c in card)
            if not on_dev or not all(torch.equal(a, b.cpu()) for a, b in zip(cpu, card)):
                wrong.append(f"{name} ({n_bits}-bit)")
        signed = E.ent_encode_signed(s.to(dev), n_bits)
        if not (E.ent_decode_signed(*signed) == s.numpy()).all():
            wrong.append(f"ent_decode_signed ({n_bits}-bit)")
        if not (E.mbe_decode(E.mbe_encode(s.to(dev), n_bits)) == s.numpy()).all():
            wrong.append(f"mbe_decode ({n_bits}-bit)")
    return wrong


def check_encoders(torch):
    """The paper's encoders and multipliers on the card (``core/encoding``,
    ``core/multiplier``): every encoding function equal to its CPU result
    over all int8 / uint8 and 16-bit values; ``encoder_products`` with no
    wrong value, kernels 5 and 4 launched through ``ent_plane_matmul`` /
    ``ent_packed_matmul`` once per shape each (counted, on the routes
    their cuts give); the planted fault "carry into the next digit ignored"
    must break the EN-T products (exactly the int8 pairs whose |a| has a
    radix-4 digit 3 and b != 0; MBE's stay right), the 16-bit round trip
    and the matmuls."""
    from repro_torch.core import encoding
    from repro_torch.kernels.ent_matmul.ent_matmul import ent_matmul, ent_matmul_packed
    t0 = time.perf_counter()
    wrong = encoder_functions(torch, DEV)
    print(f"encoding on the card vs the CPU (int8, uint8, all 16-bit values): "
          f"{len(wrong)} functions differ {wrong}", flush=True)
    if wrong:
        raise AssertionError(f"encoding functions differ on the card: {wrong}")
    reset_counts(torch)
    bad = encoder_products(torch, DEV)
    launches = {"ent_matmul": ent_matmul.launches, "ent_matmul_packed": ent_matmul_packed.launches,
                **{k: v for k, v in read_matmul_routes(torch).items()
                   if k.startswith(("ent_matmul[", "ent_matmul_packed["))}}
    reset_counts(torch)
    print(f"multipliers and digit-plane matmuls on the card: wrong values {bad}; kernel "
          f"launches {launches}", flush=True)
    if any(bad.values()):
        raise AssertionError(f"encoder products wrong on the card: {bad}")
    want = {"ent_matmul": len(ENC_MATMUL_SHAPES), "ent_matmul_packed": len(ENC_MATMUL_SHAPES)}
    for name in list(want):
        for m, _, _ in ENC_MATMUL_SHAPES:
            key = f"{name}[{matmul_route(name, m)}]"
            want[key] = want.get(key, 0) + 1
    if {k: launches.get(k, 0) for k in want} != want:
        raise AssertionError(f"multiplier matmul launches {launches}, expected {want}")
    with planted(encoding, "ent_encode_unsigned", carry_dropped):
        faulty = encoder_products(torch, DEV, ENC_MATMUL_SHAPES[:1])
    reset_counts(torch)
    rows_with_3 = sum(any((v >> (2 * j)) & 3 == 3 for j in range(4))
                      for v in (abs(a) for a in range(-128, 128)))
    want_bad = rows_with_3 * 255   # a * 0 stays right
    print(f"planted fault 'carry into the next digit ignored': wrong values {faulty} "
          f"({rows_with_3} of 256 int8 values have a radix-4 digit 3 in |a|: {want_bad} wrong "
          f"EN-T products expected, none of MBE's)", flush=True)
    missed = [k for k, v in faulty.items()
              if (k == "ent_multiply" and v != want_bad) or (k == "mbe_multiply" and v)
              or (not k.endswith("multiply") and not v)]
    if missed:
        raise AssertionError(f"the planted encoder fault passed checks {missed}")
    print(f"encoder checks: {time.perf_counter() - t0:.2f}s", flush=True)
    return dict(launches=launches, wrong=bad, fault=faulty)


def paper_tables_headline(torch):
    """``core/paper_tables``' ALL_TABLES on this host (pure Python: a
    sanity line, not a check of the device; tests/test_torch_hwmodel.py
    holds the tables against the reference's): prints the Fig 7 headline."""
    from repro_torch.core import hwmodel, paper_tables
    rows = [fn() for fn in paper_tables.ALL_TABLES]
    heads = {s: hwmodel.scale_average(s) for s in ("256GOPS", "1TOPS", "4TOPS")}
    print(f"paper tables: {len(rows)} tables, {sum(len(r[0]) for r in rows)} rows; model "
          "area / energy efficiency gains (paper 8.7 / 12.2 / 11.0%, 13.0 / 17.5 / 15.5%): "
          + ", ".join(f"{k} +{100 * v['area_eff']:.1f}% / +{100 * v['energy_eff']:.1f}%"
                      for k, v in heads.items()), flush=True)
    return heads


def run_quickstart(torch):
    """``examples/torch_quickstart.py`` on the card: its digit-plane and
    packed matmuls must launch kernels 5 and 4 (once each)."""
    import importlib.util
    path = os.path.join(HERE, "examples", "torch_quickstart.py")
    spec = importlib.util.spec_from_file_location("torch_quickstart", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    from repro_torch.kernels.ent_matmul.ent_matmul import ent_matmul, ent_matmul_packed
    reset_counts(torch)
    loss = mod.main([])
    got = {"ent_matmul": ent_matmul.launches, "ent_matmul_packed": ent_matmul_packed.launches}
    reset_counts(torch)
    print(f"examples/torch_quickstart.py on the card: loss {loss:.4f}; launches {got}",
          flush=True)
    if got != {"ent_matmul": 1, "ent_matmul_packed": 1} or not math.isfinite(loss):
        raise AssertionError(f"quickstart: launches {got}, loss {loss}")
    return got


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


def train_full_width(torch, arch, checkpoint=False):
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
    (random weights: the head's unit-variance logits add ~0.5).  With
    ``checkpoint``, the run saves {"params", "opt"} after step 2 through
    ``train``'s checkpointer (non-blocking: the write runs beside step 3)
    and ``checkpoint_resume`` checks the restore and the resumed step 3.
    Then one more step under the profiler.  Returns the run's record."""
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
    ocfg = get_optim(arch)
    model, params, opt, step_fn = launch.build(cfg, tcfg, ocfg, seed=0)
    torch.cuda.synchronize()
    # what the build holds (the planning phase holds its planner to these)
    state = dict(params=param_bytes(params), m=param_bytes(opt["adam"]["m"]),
                 v=param_bytes(opt["adam"]["v"]), allocated=torch.cuda.memory_allocated())
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

    def read(rec):
        launches, plain_runs = read_counts(torch)
        tc = read_tc_counts(torch)
        reset_counts(torch)
        rec.update(launches=launches, plain_runs=plain_runs, tc_launches=tc,
                   delta_passes=delta_passes[0],
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        delta_passes[0] = 0

    def on_step(rec):
        read(rec)
        # the step right after a non-blocking save runs beside its write
        rec["beside_write"] = ck is not None and ck.saved_step == rec["step"] - 1
        launches, tc = rec["launches"], rec["tc_launches"]
        steps.append(rec)
        print(f"  step {rec['step']}: loss {rec['loss']:.4f} grad-norm "
              f"{rec['grad_norm']:.4f} lr {rec['lr']:.3e} time {rec['seconds']:.3f}s "
              f"tokens/s {rec['tokens_per_s']:.1f}"
              f"{' (beside the checkpoint write)' if rec['beside_write'] else ''} peak "
              f"{rec['peak_gib']:.2f} GiB; "
              f"launches {({n: launches[n] for n in names})}; tensor-core route "
              f"{({n: tc[n] for n in tc_names})}; bwd_delta passes "
              f"{rec['delta_passes']}", flush=True)

    ck = None
    if checkpoint:
        free = shutil.disk_usage(HERE).free
        print(f"checkpoint directory {CKPT_DIR}: {free / 2**30:.2f} GiB free on its disk "
              f"before the save", flush=True)
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
        ck = KeepingCheckpointer(torch, CKPT_DIR)
    reset_counts(torch)
    try:
        with planted(fa_mod, "bwd_delta", counted):
            params, opt, _ = launch.train(step_fn, params, opt, stream, 3,
                                          device=model.device, log_every=1, on_step=on_step,
                                          ckpt=ck, checkpoint_every=2)
        for rec in steps:
            check_train_step(rec, names, expected, tc_names)
        ckpt = None
        if checkpoint:
            with planted(fa_mod, "bwd_delta", counted):
                ckpt = checkpoint_resume(
                    torch, ck, cfg, tcfg, ocfg, step_fn, params, opt, stream, read,
                    lambda rec: check_train_step(rec, names, expected, tc_names), model.device)
    finally:
        if checkpoint:
            ck.wait()
            shutil.rmtree(CKPT_DIR, ignore_errors=True)
    print(f"first step's loss {steps[0]['loss']:.4f} beside ln(vocab) = "
          f"{math.log(cfg.vocab_size):.4f} (limit: within 2)", flush=True)
    if abs(steps[0]["loss"] - math.log(cfg.vocab_size)) > 2:
        raise AssertionError(f"{arch}: first loss {steps[0]['loss']} is not near ln(vocab)")
    step_wall = statistics.mean(r["seconds"] for r in steps[1:] if not r["beside_write"])
    with planted(fa_mod, "bwd_delta", counted):
        prof = profile_train_step(torch, step_fn, params, opt,
                                  launch.to_device(stream.next(), model.device), step_wall)
    if delta_passes[0]:
        raise AssertionError(f"profiled step: {delta_passes[0]} plain D_i passes ran")
    peak = torch.cuda.max_memory_allocated() / 2**30
    del model, params, opt, step_fn
    torch.cuda.empty_cache()
    return dict(steps=steps, expected=expected, profile=prof, peak_gib=peak, checkpoint=ckpt,
                state=state, tcfg=tkw,
                launches={n: sum(r["launches"][n] for r in steps) for n in names},
                tc_launches={n: sum(r["tc_launches"][n] for r in steps) for n in tc_names},
                tokens=tcfg.global_batch * tcfg.seq_len)


# --- phase 15: multi-device under an NCCL world of 1 ---------------------------
# The card's machine has one H100, and NCCL puts no two ranks of a
# communicator on one card: the partitioning across ranks is checked on
# the CPU with gloo worlds of 2..8 (tests/test_torch_{sharding,
# distributed,moe_sharded,pipeline}.py); here the sharded path runs on a
# 1x1 (data, model) mesh over NCCL: its wiring, the kernels under it, its
# memory at full width.

# relative L2 limit of apply_sharded against moe.apply in bf16 (outputs and
# gradients), derived in tests/test_torch_moe_sharded.py (MOE_BF16_RTOL):
# the paths' expert products may round 1 bf16 ulp apart (2^-8 relative)
MOE_SHARDED_RTOL = 2.0**-6
MOE_SHARDED_T = (8, 4096)   # a decode tick's slots, one 4,096-token row


@contextlib.contextmanager
def nccl_world(torch):
    """An NCCL process group of world 1 on cuda:0, rendezvous through a
    FileStore in a temporary directory, and a 1x1 ("data", "model") mesh
    over it; destroyed on the way out, so later phases run as before."""
    import tempfile

    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    tmp = tempfile.mkdtemp(prefix="chip_smoke_store_")
    try:
        dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
                                rank=0, world_size=1, device_id=torch.device(DEV, 0))
        try:
            yield make_mesh((1, 1), ("data", "model"))
        finally:
            dist.destroy_process_group()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def sharded_train_step(torch, mesh):
    """(a) Full-width mamba2-370m in phase 12's configuration: two copies of
    one seeded state (AdamW updates in place), one plain step and one
    through ``make_train_step(..., data_axes="data", grad_shardings=...)``
    on the 1x1 mesh, on the same batch.  Loss, grad-norm and every leaf of
    params, m and v must be bit-identical, and each step must launch
    kernels 8 / 8b / 8c as phase 12's steps do and nothing else.  Returns
    each step's time, peak, transient and launches."""
    from repro_torch import sharding
    from repro_torch.configs import get_config, get_optim
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.pipeline import SyntheticSource, TokenStream
    from repro_torch.launch import train as launch
    from repro_torch.models.transformer import build_model
    from repro_torch.runtime.train_loop import init_opt_state, make_train_step

    arch = "mamba2-370m"
    tkw, per_layer, _ = TRAIN_RUNS[arch]
    cfg, tcfg, ocfg = get_config(arch), TrainConfig(**tkw), get_optim(arch)
    model, params, opt, plain_step = launch.build(cfg, tcfg, ocfg, seed=0)
    specs = sharding.params_shardings(params, mesh)
    copies = {"plain": (plain_step, params, opt)}
    local = sharding.local_shard_tree(params, specs, mesh)
    sharded = make_train_step(build_model(cfg, dist=(mesh, "data")), ocfg, tcfg,
                              data_axes="data", grad_shardings=specs)
    copies["sharded"] = (sharded, local, init_opt_state(tcfg, local))
    stream = TokenStream(SyntheticSource(cfg.vocab_size, seed=1234),
                         global_batch=tcfg.global_batch, seq_len=tcfg.seq_len)
    batch = launch.to_device(stream.next(), model.device)
    n_micro = tcfg.global_batch // tcfg.microbatch
    expected = {n: k * cfg.num_layers * n_micro for n, k in per_layer.items()}
    names = tuple(per_layer)
    runs = {}
    for label, (step, p, o) in copies.items():
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(torch)
        t0 = time.perf_counter()
        p, o, m = step(p, o, batch)
        loss = float(m["loss"])
        seconds = time.perf_counter() - t0
        launches, plain_runs = read_counts(torch)
        rec = dict(step=label, loss=loss, grad_norm=float(m["grad_norm"]), seconds=seconds,
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                   transient_gib=(torch.cuda.max_memory_allocated() - before) / 2**30,
                   launches=launches, plain_runs=plain_runs, tc_launches=read_tc_counts(torch),
                   delta_passes=0, metrics=m, state=(p, o))
        check_train_step(rec, names, expected, ())
        runs[label] = rec
        print(f"  {label} step: loss {loss:.6f} grad-norm {rec['grad_norm']:.6f} time "
              f"{seconds:.3f}s peak {rec['peak_gib']:.2f} GiB (the step's own "
              f"{rec['transient_gib']:.2f} GiB); launches {({n: launches[n] for n in names})}",
              flush=True)
    a, b = runs["plain"], runs["sharded"]
    same = {k: bool(torch.equal(a["metrics"][k], b["metrics"][k])) for k in ("loss", "grad_norm")}
    (pa, oa), (pb, ob) = a["state"], b["state"]
    diffs = {}
    for k, x, y in (("params", pa, pb), ("m", oa["adam"]["m"], ob["adam"]["m"]),
                    ("v", oa["adam"]["v"], ob["adam"]["v"])):
        worst, differ, _ = tree_difference(torch, x, y)
        diffs[k] = dict(leaves=len(named_leaves(x)), differ=len(differ), max_abs=worst)
    differing = {k: f"{d['differ']} of {d['leaves']}" for k, d in diffs.items()}
    print(f"  sharded vs plain: loss / grad-norm bit-identical {same}; leaves differing "
          f"{differing}", flush=True)
    if not all(same.values()) or any(d["differ"] for d in diffs.values()):
        raise AssertionError(f"sharded step at world 1 differs from the plain step: {same}, "
                             f"{diffs}")
    for r in runs.values():
        del r["metrics"], r["state"]
    del copies, params, opt, local, model, a, b, pa, oa, pb, ob
    torch.cuda.empty_cache()
    return dict(runs=runs, expected=expected, leaves=diffs)


def rel_l2(torch, a, b):
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def drop_expert0_gate(real):
    """The planted fault "one expert's gate dropped from the combine":
    ``moe.route`` with every gate of expert 0 zeroed."""
    def route(cfg, p, xt, rows=False):
        probs, gates, idx = real(cfg, p, xt, rows)
        return probs, gates.masked_fill(idx == 0, 0.0), idx
    return route


def moe_layer_sharded(torch, mesh, timer):
    """(b) One full-width mixtral-8x7b MoE layer (d_model 4096, 8 experts of
    d_ff 14336, top-2, capacity factor 1.25, bf16), seeded, through
    ``apply_sharded`` on the 1x1 mesh and through ``moe.apply``, at T = 8
    and T = 4096 tokens: outputs within MOE_SHARDED_RTOL (relative L2); at
    T = 4096 the input gradient and the three expert-stack gradients under
    one seeded cotangent within the same limit; the planted fault "one
    expert's gate dropped from the combine" must read over it.  Both paths
    timed (forward; forward + backward at T = 4096)."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe

    cfg = dataclasses.replace(get_config("mixtral-8x7b"), param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    g = torch.Generator(device=DEV).manual_seed(31)
    p = moe.init(g, cfg)
    experts = ("wi_gate", "wi_up", "wo")
    sharded = lambda x: moe.apply_sharded(cfg, p, x, mesh, "data")   # noqa: E731
    plain = lambda x: moe.apply(cfg, p, x)                            # noqa: E731
    rows = []
    for t in MOE_SHARDED_T:
        x = torch.randn((t, 1, cfg.d_model) if t <= 8 else (1, t, cfg.d_model), generator=g,
                        device=DEV).to(torch.bfloat16)
        with torch.no_grad():
            ys, aux_s = sharded(x)
            yp, aux_p = plain(x)
            with planted(moe, "route", drop_expert0_gate):
                yf, _ = sharded(x)
            row = dict(T=t, capacity=moe.capacity(cfg, t), y=rel_l2(torch, ys, yp),
                       aux_abs=abs(float(aux_s) - float(aux_p)), fault=rel_l2(torch, yf, yp),
                       ms=timer(lambda: sharded(x), reps=5), plain_ms=timer(lambda: plain(x),
                                                                              reps=5))
        if t == MOE_SHARDED_T[-1]:
            dy = torch.randn(yp.shape, generator=g, device=DEV).to(torch.bfloat16)

            def fwd_bwd(fn):
                """x's and the expert stacks' gradients under the cotangent dy."""
                xg = x.detach().clone().requires_grad_(True)
                for n in experts:
                    p[n].grad = None
                y, _ = fn(xg)
                y.backward(dy)
                return {"x": xg.grad, **{n: p[n].grad for n in experts}}

            for n in experts:
                p[n].requires_grad_(True)
            grads = {label: fwd_bwd(fn) for label, fn in (("sharded", sharded),
                                                            ("plain", plain))}
            row["grads"] = {k: rel_l2(torch, grads["sharded"][k], grads["plain"][k])
                            for k in grads["plain"]}
            del grads
            row["fwd_bwd_ms"] = timer(lambda: fwd_bwd(sharded), reps=3)
            row["fwd_bwd_plain_ms"] = timer(lambda: fwd_bwd(plain), reps=3)
            for n in experts:
                p[n].requires_grad_(False)
                p[n].grad = None
        rows.append(row)
        print(f"  T {t} (capacity {row['capacity']}): y relative L2 {row['y']:.3e}, aux |diff| "
              f"{row['aux_abs']:.3e}, fault {row['fault']:.3e} (limit {MOE_SHARDED_RTOL:.3e}); "
              f"apply_sharded {row['ms']:.4f} ms, moe.apply {row['plain_ms']:.4f} ms"
              + (f"; gradients {({k: f'{v:.3e}' for k, v in row['grads'].items()})}; fwd+bwd "
                 f"{row['fwd_bwd_ms']:.4f} / {row['fwd_bwd_plain_ms']:.4f} ms"
                 if "grads" in row else ""), flush=True)
        worst = max([row["y"]] + list(row.get("grads", {}).values()))
        if not worst <= MOE_SHARDED_RTOL:
            raise AssertionError(f"apply_sharded vs moe.apply at T {t}: {worst:.3e} > "
                                 f"{MOE_SHARDED_RTOL:.3e}")
        if not row["fault"] > MOE_SHARDED_RTOL:
            raise AssertionError(f"planted fault (expert 0's gate dropped) not caught at T {t}: "
                                 f"{row['fault']:.3e}")
    del p
    torch.cuda.empty_cache()
    return rows


def multi_device(torch):
    """Phase 15: (a) and (b) under an NCCL world of 1, then (c) the group
    destroyed."""
    import torch.distributed as dist
    with nccl_world(torch) as mesh:
        print(f"NCCL world of {dist.get_world_size()} (backend {dist.get_backend()}), mesh "
              f"{mesh.shape}", flush=True)
        step = sharded_train_step(torch, mesh)
        timer = Timer(torch)
        layer = moe_layer_sharded(torch, mesh, timer)
        del timer
    if dist.is_initialized():
        raise AssertionError("the NCCL process group outlived the phase")
    torch.cuda.empty_cache()
    return dict(step=step, moe=layer)


# --- phase 16: the planning tools -----------------------------------------------
# The planner (repro_torch/launch/dryrun.py) on meta tensors beside what the
# earlier phases measured on the card: it builds no model and launches no
# kernel.  (a) is a gate (the planner's params, m and v bytes are the
# build's, exactly); (b)-(d) are reported.

def planning_tools(torch, trains, int8_tick):
    """``trains``: {arch: train_full_width's record}; ``int8_tick``: the
    int8 serve phase's decode tick {"host_ms", "busy_ms"}.  Plans each
    training cell on a 1x1 mesh at the phase's own TrainConfig (its state
    bytes against the build's, its peak against the steps'
    ``max_memory_allocated``, its roofline and MFU against the median step
    after the first), then the int8 serving tick (qwen2.5-3b w8a8 + int8
    KV, 8 slots of the paged cache at max_len 576, one token)."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.core import roofline as rl
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.launch.specs import input_specs

    mesh = AbstractMesh((1, 1), ("data", "model"))
    out = {}
    for arch, rec in trains.items():
        tcfg = TrainConfig(**rec["tcfg"])
        shape = ShapeConfig(f"train_{tcfg.seq_len}x{tcfg.global_batch}", "train",
                            tcfg.seq_len, tcfg.global_batch)
        _, args, kind = input_specs(arch, shape, tcfg=tcfg, dist=(mesh, "data"))
        parts = dryrun.argument_parts(kind, args, mesh)
        del args
        built = rec["state"]
        planned = {k: parts[k] for k in ("params", "m", "v")}
        cell = dryrun.run_cell(arch, shape, mesh=mesh, tcfg=tcfg, verbose=False)
        roof = cell["roofline"]
        total_s = max(roof["compute_s"], roof["memory_s"], roof["collective_s"])
        steady = [r["seconds"] for r in rec["steps"][1:] if not r["beside_write"]]
        step_s = statistics.median(steady)
        mf = rl.model_flops(get_config(arch), shape)
        peak_gib = cell["memory"]["peak_per_device_gb"] * 1e9 / 2**30
        # the steps' own peak (the phase's whole peak also holds the checkpoint
        # phase's second state; the step beside the write its snapshot)
        measured = max(r["peak_gib"] for r in rec["steps"] if not r["beside_write"])
        r = dict(planned=planned, built={k: built[k] for k in planned},
                 allocated=built["allocated"], peak_gib=peak_gib, measured_gib=measured,
                 model_flops=mf, traced_flops=roof["flops_per_dev"], step_s=step_s,
                 mfu=mf / (step_s * rl.PEAK_FLOPS), total_s=total_s,
                 terms={k: roof[k] for k in ("compute_s", "memory_s", "collective_s")},
                 bottleneck=roof["bottleneck"], trace_s=cell["trace_s"])
        print(f"planner [{arch} train, seq {tcfg.seq_len}, batch {tcfg.global_batch} as "
              f"{tcfg.global_batch // tcfg.microbatch} x {tcfg.microbatch}, remat {tcfg.remat}, "
              f"1x1 mesh]: params + m + v planned {planned} = "
              f"{sum(planned.values())} bytes, built {r['built']} = "
              f"{sum(r['built'].values())} bytes; memory_allocated after the build "
              f"{r['allocated']} bytes; peak planned {peak_gib:.2f} GiB, measured "
              f"{r['measured_gib']:.2f} GiB (ratio {peak_gib / r['measured_gib']:.3f}); "
              f"model FLOPs {mf:.4e}, traced {r['traced_flops']:.4e} a step; median step "
              f"{step_s:.4f} s of {len(steady)}: mfu {r['mfu']:.4f}; roofline compute "
              f"{roof['compute_s'] * 1e3:.2f} / memory {roof['memory_s'] * 1e3:.2f} / "
              f"collective {roof['collective_s'] * 1e3:.2f} ms -> {roof['bottleneck']}, "
              f"total {total_s * 1e3:.2f} ms = {total_s / step_s:.3f} of the step; trace "
              f"{cell['trace_s']} s", flush=True)
        if planned != r["built"]:
            raise AssertionError(f"{arch}: the planner's state bytes {planned} are not the "
                                 f"build's {r['built']}")
        out[arch] = r
    cfg = replace(get_config("qwen2.5-3b"), cache_kind="paged")
    shape = ShapeConfig("serve_tick", "decode", SERVE_MAX_LEN, SLOTS)
    cell = dryrun.run_cell("qwen2.5-3b", shape, mesh=mesh, cfg=cfg, quantized=True,
                           kv_quant=True, verbose=False)
    roof = cell["roofline"]
    out["int8_tick"] = dict(terms={k: roof[k] for k in ("compute_s", "memory_s",
                                                        "collective_s")},
                            bottleneck=roof["bottleneck"], **int8_tick)
    print(f"planner [qwen2.5-3b w8a8 + int8 KV decode tick, {SLOTS} slots of a paged cache "
          f"at max_len {SERVE_MAX_LEN}, 1x1 mesh]: compute {roof['compute_s'] * 1e3:.4f} / "
          f"memory {roof['memory_s'] * 1e3:.4f} / collective "
          f"{roof['collective_s'] * 1e3:.4f} ms -> {roof['bottleneck']}; the int8 serve "
          f"phase's tick {int8_tick['busy_ms']:.3f} ms busy, {int8_tick['host_ms']:.3f} ms "
          f"host-clock", flush=True)
    return out


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
    if (m := re.search(r"(paged_decode_tc|paged_decode_f32)I(13__nv_bfloat16|f|a)Lb[01]ELi(\d+)E"
                       r"Lb([01])E", fn)):
        return f"{m.group(1)}<{types[m.group(2)]},{m.group(3)}{',ring' * int(m.group(4))}>"
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
    int8 loop of kernels 1, 6, 5 and 4; kernel 8's three launches, 8b's two
    and 8c), of the split-K stream of kernels 1, 6, 5 and 4 and of the paged
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
    # kernels 1, 6, 5 and 4: the stream as served (bf16 / int8 X, f32 out),
    # one instantiation per rows a block, its shared memory at the largest
    # of the four projection shapes' plans; and every instantiation of the
    # int8 tensor-core loop
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for source, smem_of, x0, np_, shift, xs in (
            ("ent_matmul", "ent_matmul", "bf16", 2, 4, ("bf16", "f32")),
            ("int8_matmul", "int8_matmul", "int8", 1, 0, ("int8",)),
            ("ent_matmul", "ent_matmul_planes", "int8", 4, 2, ("int8",)),
            ("ent_matmul", "ent_matmul_packed", "int8", 2, 4, ("int8",))):
        recs = {f"stream_kernel<{x0},{np_},{shift},{mb},float>": {} for mb in em.STREAM_MB}
        stream_smem = _build.entry(source, f"{smem_of}_stream_smem")
        for mb, rec in zip(em.STREAM_MB, recs.values()):
            rec["smem_bytes"] = max(stream_smem(mb, em.stream_plan(mb, n, k, sms)[1])
                                    for k, n in STREAM_SHAPES[:4])
        tc_smem = _build.entry(source, f"{smem_of}_tc_smem")
        for x in xs:
            for o in ("float", "bf16", "int"):
                recs[f"tc_kernel<{x},{np_},{shift},{o}>"] = {
                    "smem_bytes": tc_smem(int(x == "bf16")) if smem_of == "ent_matmul"
                    else tc_smem()}
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
    # plans of PAGED_CASES' tick (D 128) and G12 (D 64) calls; and their ring
    # form (the ring decode) at the starcoder2-15b tick's plan (D 128; D 64
    # at the same plan)
    from repro_torch.kernels.paged_attention.paged_attention import (ring_split_plan,
                                                                     split_plan)
    paged_smem = _build.entry("paged_attention", "paged_attention_smem")
    ring_smem = _build.entry("paged_attention", "ring_decode_smem")
    ring_rows, ring_splits = ring_split_plan(SLOTS, 4, RING_W, sms)
    recs = {}
    for case in PAGED_CASES.values():
        b, hq, hkv, d, page, pps = case[:6]
        pp, splits = split_plan(b, hkv, pps, sms)
        for kern, is_bf16 in (("paged_decode_tc", 1), ("paged_decode_f32", 0)):
            for kv, int8 in (("int8", 1), ("bf16" if is_bf16 else "float", 0)):
                recs[f"{kern}<{kv},{d}>"] = {"smem_bytes": paged_smem(
                    is_bf16, int8, d, pp, page, hq // hkv, splits)}
                recs[f"{kern}<{kv},{d},ring>"] = {"smem_bytes": ring_smem(
                    is_bf16, int8, d, ring_rows, 12, ring_splits)}
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
    # every check holds launches to the plans of an empty tuning table: no
    # cache of this host's (the tuning phase keeps its own)
    isolated = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    os.environ["REPRO_TORCH_TUNING_CACHE"] = os.path.join(isolated.name, "tuning.json")
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

    def checked(what, fn, *args, **kwargs):
        out = fn(*args, **kwargs)
        check_workspace_zero(torch, what)
        return out
    mm = checked("check_matmuls", check_matmuls, torch, timer)
    ring_mm = checked("check_ring_matmuls", check_ring_matmuls, torch, timer)
    n_stream = checked("check_stream", check_stream, torch)
    n_tc = checked("check_tc", check_tc, torch)
    cut = checked("check_cut", check_cut, torch, timer)
    k2 = checked("check_flash", check_flash, torch, timer)
    k2o = checked("check_flash_offsets", check_flash_offsets, torch, timer)
    k2r = checked("check_ring_decode", check_ring_decode, torch, timer)
    k3 = checked("check_paged", check_paged, torch, timer)
    k3i = checked("check_paged (int8 KV)", check_paged, torch, timer, int8_kv=True)
    k8p = checked("check_ssd_prefill", check_ssd_prefill, torch, timer)
    mamba_mm = checked("check_ring_matmuls (mamba2-370m)", check_ring_matmuls, torch, timer,
                       MAMBA_SHAPES, MAMBA_MATMUL_M, "mamba2-370m", 17)
    done(t, "kernel checks")

    t = phase("tuning")
    tuned = checked("tuning", tuning_phase, torch, timer)
    del timer
    done(t, "tuning")

    serves = {}
    for config in SERVE_CONFIGS:
        t = phase(f"serve qwen2.5-3b full width, {config}")
        serves[config] = serve_full_width(torch, config)
        done(t, f"serve qwen2.5-3b full width, {config}")
        check_workspace_zero(torch, f"serve qwen2.5-3b full width, {config}")
    t = phase("serve qwen2.5-3b full width, EN-T, shared prefix")
    shared = serve_shared_prefix(torch)
    done(t, "serve qwen2.5-3b full width, EN-T, shared prefix")
    check_workspace_zero(torch, "serve qwen2.5-3b full width, EN-T, shared prefix")
    what = f"serve qwen2.5-3b full width, EN-T, speculative (k = {SPEC_K})"
    t = phase(what)
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as launch
    ent_model, ent_params = launch.build(get_config("qwen2.5-3b"), seed=0, quantize=True)
    plain_ent = serves["EN-T w8a8, bf16 KV"]
    spec = serve_spec(torch, plain_ent[5], plain_ent[1], ent_model, ent_params, plain_ent[6])
    engine_rows = {key: r for key, r in plain_ent[6].items() if key[0] < SLOTS}   # generate's
    plain_ent[6].clear()
    done(t, what)
    check_workspace_zero(torch, what)
    what = "serve qwen2.5-3b full width, EN-T, scheduler, faults, elastic, HTTP"
    t = phase(what)
    sched = serve_scheduler(torch, ent_model, ent_params)
    done(t, what)
    check_workspace_zero(torch, what)
    t = phase("generate qwen2.5-3b full width, EN-T")
    gen = generate_ent(torch, ent_model, ent_params, {u: plain_ent[5][u] for u in range(SLOTS)},
                       engine_rows)
    del engine_rows
    del ent_model, ent_params
    torch.cuda.empty_cache()
    done(t, "generate qwen2.5-3b full width, EN-T")
    check_workspace_zero(torch, "generate qwen2.5-3b full width, EN-T")
    t = phase("serve starcoder2-15b full width, EN-T, ring")
    ring = serve_ring(torch)
    done(t, "serve starcoder2-15b full width, EN-T, ring")
    check_workspace_zero(torch, "serve starcoder2-15b full width, EN-T, ring")
    t = phase("serve mamba2-370m full width, EN-T")
    mamba = serve_mamba2(torch)
    done(t, "serve mamba2-370m full width, EN-T")
    check_workspace_zero(torch, "serve mamba2-370m full width, EN-T")
    what = f"serve mixtral-8x7b full width, {MIXTRAL_LAYERS} of 32 layers, EN-T, ring"
    t = phase(what)
    mixtral = serve_mixtral(torch)
    done(t, what)
    check_workspace_zero(torch, what)

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
    per = projections(get_config("qwen2.5-3b")) * 2
    want = {"ent_matmul": 5 * per, "ent_matmul[stream]": 0, "ent_matmul[tc]": 0}
    for m, calls in ((512, per), (2, 4 * per)):
        want[f"ent_matmul[{matmul_route('ent_matmul', m)}]"] += calls
    got = {k: legacy[k] for k in want}
    if got != want:
        raise AssertionError(f"legacy 4-plane records: ent_matmul launches {got}, expected "
                             f"{want}")
    print(f"  legacy 4-plane records: ent_matmul launches {got}", flush=True)
    kernels_vs_plain_prefix(torch, 0.07)   # the prefix cache's path, as served
    spec_2l = {w: kernels_vs_plain_spec(torch, w, 0.07, kv_quant=kvq)   # the spec path
               for w, kvq in (("EN-T", False), ("int8", True))}
    ring_2l = kernels_vs_plain_ring(torch, 0.07)   # the ring's path, as served
    ring_2l_int8 = kernels_vs_plain_ring(torch, 0.07, kv_quant=True)   # its int8-KV form
    gen_2l = kernels_vs_plain_generate(torch, 0.07)   # generate's path, as served
    # SSM and MoE serving, as served (limits: PERF.md's readings)
    serving_2l = {arch: kernels_vs_plain_serving(torch, arch, 0.07)
                  for arch in ("mamba2-370m", "mixtral-8x7b")}
    done(t, "kernels vs plain, 2 layers")
    check_workspace_zero(torch, "kernels vs plain, 2 layers")

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

    t = phase("train mamba2-370m full width, checkpoint and resume")
    tm = train_full_width(torch, "mamba2-370m", checkpoint=True)
    done(t, "train mamba2-370m full width, checkpoint and resume")

    t = phase("encoders and multipliers")
    enc = check_encoders(torch)
    quick = run_quickstart(torch)
    done(t, "encoders and multipliers")

    t = phase("paper tables")
    tables = paper_tables_headline(torch)
    done(t, "paper tables")

    t = phase("multi-device, NCCL world of 1")
    multi = multi_device(torch)
    done(t, "multi-device, NCCL world of 1")

    t = phase("planning tools")
    plan = planning_tools(torch, {"minicpm-2b": tr, "mamba2-370m": tm},
                          serves["w8a8 int8, int8 KV"][7])
    done(t, "planning tools")

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
                   if lab.startswith("paged_decode") and ("<int8," in lab) == int8_kv
                   and not lab.endswith(",ring>")})
    config_of = dict(zip(MATMULS[:2], SERVE_CONFIGS))   # kernel 1: EN-T, kernel 6: int8
    signature = {"ent_matmul_packed_fused": ("<bf16,2,4,", "<f32,2,4,"),
                 "int8_matmul": ("<int8,1,0,",), "ent_matmul": ("<int8,4,2,",),
                 "ent_matmul_packed": ("<int8,2,4,",)}   # each matmul's instantiations

    def routed(name, launches, routes, **extra):
        """Kernels 1, 6, 5 and 4: launches by route on their path, the cut
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
            route_launches={"stream": routes[f"{name}[stream]"], "tc": routes[f"{name}[tc]"]},
            at_prefill=next(r for r in mm[name] if r["M"] == 512 and r["N"] == 11008),
            stream_vs_tc=[r for r in cut if r["kernel"] == name],
            calls_checked={"stream": n_stream, "tc": n_tc},
            build={lab: rec for lab, rec in tc_build.items()
                   if lab.startswith(("stream", "tc_kernel"))
                   and any(sig in lab for sig in signature[name])},
            **extra)

    def served(name):
        """Kernels 1 and 6: ``routed`` from their serve run, with the decode
        tick's route comparison and the prefill profile."""
        launches, _, routes, prefill, tick_routes = serves[config_of[name]][:5]
        return routed(name, launches, routes, decode_tick_ms_by_route=tick_routes,
                      prefill_profile=prefill)

    kernels = [
        entry("ent_matmul_packed_fused", "src/repro_torch/csrc/ent_matmul.cu", f"{ent}:227",
              mm["ent_matmul_packed_fused"], at_decode, ent_t["ent_matmul_packed_fused"],
              starcoder2_checks=ring_mm, mamba2_checks=mamba_mm,
              launches_mamba2=mamba["kernel1"], launches_mixtral=mixtral["kernel1"],
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
                      "float32: the CUDA-core kernel; per-sequence offsets (q_offsets, int32 "
                      "[B]): each block reads its sequence's offset before its band"),
              offset_form=dict(
                  checks=k2o, at_verify=next(r for r in k2o if r["S"] == SPEC_K + 1),
                  launches_spec={arm: {"offsets": r["launches"]["flash_attention_masked[offsets]"],
                                       "spec_ticks": r["stats"]["ticks"]}
                                 for arm, r in spec.items()},
                  launches_2_layer_spec={w: r["flash_attention_masked[offsets]"]
                                         for w, r in spec_2l.items()}),
              launches_mixtral=mixtral["flash_launches"],
              build={lab: rec for lab, rec in tc_build.items() if "masked" in lab}),
        *(entry(name, "src/repro_torch/csrc/paged_attention.cu",
                "src/repro/kernels/flash_attention/flash_attention.py:145",
                [r for r in k2r if (r["kv"] == "int8") == int8_kv], lambda rows: rows[0],
                launches, launches_from=source,
                design=("the paged decode's split-KV flash-decode (kernels 3 / 3b) in its ring "
                        "form over the ring's pools as stored, [B, W, Hkv, D] (int8 with bf16 "
                        "[B, W, Hkv, 1] scales), in place: one block per (run of ring rows "
                        "from ring_split_plan, kv head, slot), the seam r = pos mod W once a "
                        "block, each row's live flag from its position pos - ((pos - j) mod "
                        "W), a split's range from its first and last live row (dead rows "
                        "zero-filled without a read), the G q rows of a kv head on mma.sync "
                        "tensor cores, the ticket combine in split order"),
                note=("replaces kernel 2's ring form (PERF.md row 2r keeps its time); the "
                      "TPU reference's ring decode sends the explicit mask to the jnp core "
                      "(src/repro/kernels/flash_attention/ops.py:57-59, 71) and reaches no "
                      "Pallas kernel; `replaces` names the Pallas kernel whose ring read this "
                      "took over on the card"),
                build={lab: rec for lab, rec in tc_build.items()
                       if lab.endswith(",ring>") and ("<int8," in lab) == int8_kv},
                **extra)
          for name, int8_kv, launches, source, extra in (
              ("ring_decode_attention", False, ring["ring_launches"],
               "the 16-request ring serve run of full-width starcoder2-15b "
               f"({ring['ticks']} decode ticks, 40 a tick)",
               dict(tick_ms=ring["tick_ring_ms"], tick_copies=ring["tick_copies"],
                    kernels_vs_plain_2_layers=ring_2l["relative_l2"],
                    launches_mixtral=mixtral["ring_launches"])),
              ("ring_decode_attention[int8_kv]", True,
               ring_2l_int8["counts"]["ring_decode_attention[int8_kv]"],
               "the 2-layer int8-KV ring case (4 decode ticks x 2 layers); the serve run "
               "keeps bf16 KV",
               dict(kernels_vs_plain_2_layers=ring_2l_int8["relative_l2"])))),
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
              launches_multiplier={k: v for k, v in enc["launches"].items()
                                   if k.startswith("ent_matmul") and "packed" not in k},
              launches_quickstart=quick["ent_matmul"],
              **routed("ent_matmul", legacy, legacy)),
        entry("ent_matmul_packed", "src/repro_torch/csrc/ent_matmul.cu", f"{ent}:205",
              mm["ent_matmul_packed"], at_decode,
              enc["launches"]["ent_matmul_packed"] + quick["ent_matmul_packed"],
              launches_from=("core/multiplier.ent_packed_matmul: the multiplier phase (M, K, N "
                             f"= {ENC_MATMUL_SHAPES}) and examples/torch_quickstart.py; no "
                             "serving path"),
              launches_multiplier={k: v for k, v in enc["launches"].items()
                                   if k.startswith("ent_matmul_packed")},
              launches_quickstart=quick["ent_matmul_packed"],
              **routed("ent_matmul_packed", ent_t, serves[config_of["ent_matmul_packed_fused"]][2])),
    ]
    for k in kernels:   # the tuning phase's autotune of kernels 1 and 3
        fam = {"ent_matmul_packed_fused": "ent_matmul_packed_fused",
               "paged_attention_kernel": "paged_attention"}.get(k["name"])
        if fam:
            k["tuning"] = dict(tuned[fam], autotune_s=tuned["autotune_s"],
                               lookup_us=tuned["lookup_us"],
                               stream_plan_us=tuned["stream_plan_us"])
    sched_launches = sched["a"]["runs"][1]["launches"]
    for k in kernels:   # kernels 1, 2 and 3 on the prefix-shared, speculative, scheduler runs
        if k["name"] in ("ent_matmul_packed_fused", "flash_attention_masked",
                         "paged_attention_kernel"):
            k["launches_shared_prefix"] = shared[0][k["name"]]
            k["launches_speculative"] = {arm: r["launches"].get(k["name"], 0)
                                         for arm, r in spec.items()}
            k["launches_scheduler_depth_1"] = {
                **{r: n for r, n in sched_launches.items() if r.startswith(k["name"])},
                **sched["a"]["runs"][1]["counts"]}
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
        extra["launches_sharded_step"] = {
            label: r["launches"][name] for label, r in multi["step"]["runs"].items()}
        kernels.append(entry(name, "src/repro_torch/csrc/ssd_scan.cu", f"{ssd}:72",
                             k8[name], lambda rows: rows[-1], tm["launches"][name], **extra))
    kernels.append(entry(
        "ssd_prefill", "src/repro_torch/csrc/ssd_scan.cu", f"{ssd}:72", k8p,
        lambda rows: rows[0], mamba["ssd_prefill_launches"],
        launches_from=f"the 16-request serve run of full-width mamba2-370m ({mamba['prefills']} "
                      f"admission prefills, {get_config('mamba2-370m').num_layers} a prefill)",
        launches_by_part=mamba["launches_by_part"],
        design=("kernel 8's three launches over nc + 1 state slots: slot 0 the slot's entering "
                "state h_init (kernel 8: zero), the states launch also runs the last chunk, the "
                "carry runs to nc and writes h0s[nc], the state leaving the prompt, to h_final "
                "[B, H, P, N] as the SSM cache holds it; pads get dt = 0 from the wrapper, a "
                "length the chunk does not divide is left-padded with zero rows"),
        note=("row 8p: the TPU reference's prompt recurrence is a lax.scan of the one-token "
              "update (src/repro/models/ssm.py:202-261) and reaches no Pallas kernel; "
              "`replaces` names the Pallas kernel whose body 8p runs on"),
        kernels_vs_plain_2_layers=serving_2l["mamba2-370m"]))
    for arch, run in (("minicpm-2b", tr), ("mamba2-370m", tm)):
        steps = run["steps"]
        beside = [r["step"] for r in steps if r["beside_write"]]
        note = (f" (step {beside[0]} beside the checkpoint write; step 3 alone, the repeat "
                f"from memory, {run['checkpoint']['repeat']['seconds']:.4f} s)" if beside else "")
        print(f"train {arch}: step seconds {[round(r['seconds'], 4) for r in steps]}, "
              f"tokens/s {[round(r['tokens_per_s'], 2) for r in steps]}{note}, peak "
              f"{run['peak_gib']:.2f} GiB")
    ckr = tm["checkpoint"]
    print(f"checkpoint mamba2-370m: {ckr['save']['bytes']} bytes, snapshot "
          f"{ckr['save']['snapshot_s']:.3f} s, write {ckr['save']['write_s']:.3f} s, restore "
          f"{ckr['restore_s']:.3f} s; training step deterministic on the card: "
          f"{ckr['deterministic']}; resumed step 3 max |diff| {ckr['resumed']['max_abs']:.3e} "
          f"(repeat {ckr['repeat']['max_abs']:.3e})")
    print(f"encoders: kernel 5 / 4 launches through core/multiplier {enc['launches']}; "
          f"quickstart {quick}; Fig 7 model gains "
          + ", ".join(f"{k} +{100 * v['area_eff']:.1f}% / +{100 * v['energy_eff']:.1f}%"
                      for k, v in tables.items()))
    for config in SERVE_CONFIGS:
        print(f"serve tokens/s [{config}] {serves[config][1]:.3f}")
    print(f"serve tokens/s [EN-T w8a8, bf16 KV, shared prefix] {shared[1]:.3f}")
    print(f"serve tokens/s [starcoder2-15b, EN-T w8a8, ring] {ring['tok_s']:.3f}; decode tick "
          f"{ring['tick_host_ms']:.3f} ms host-clock, {ring['tick_busy_ms']:.3f} ms device busy, "
          f"the ring decode {ring['tick_ring_ms']:.3f} ms, copies (aten::copy_) "
          f"{ring['tick_copies']['op_ms']:.3f} ms; peak {ring['peak_gib']:.2f} GiB")
    mt, xt = mamba["tick"], mixtral["tick"]
    print(f"serve tokens/s [mamba2-370m, EN-T w8a8] {mamba['tok_s']:.3f}; decode tick "
          f"{mt['host_ms']:.3f} ms host-clock, {mt['busy_ms']:.3f} ms device busy, "
          f"{mt['kernels_a_tick']:.0f} kernels; SSM states {mamba['ssm_bytes']} bytes; peak "
          f"{mamba['peak_gib']:.2f} GiB; speculative k={SPEC_K} (layer 0 drafter) "
          f"{mamba['spec']['tok_s']:.3f} tok/s, acceptance {mamba['spec']['acceptance']:.4f}, "
          f"{mamba['spec']['tokens_per_tick']:.3f} tokens a tick; 2-layer kernels vs plain "
          f"{serving_2l['mamba2-370m']['relative_l2']:.3e} (logits), "
          f"{serving_2l['mamba2-370m']['state_relative_l2']:.3e} (SSD states)")
    print(f"serve tokens/s [mixtral-8x7b {MIXTRAL_LAYERS} layers, EN-T w8a8 attention, ring] "
          f"{mixtral['tok_s']:.3f}; decode tick {xt['host_ms']:.3f} ms host-clock, "
          f"{xt['busy_ms']:.3f} ms device busy; dropped assignments a tick "
          f"{mixtral['tick_drops']}; peak {mixtral['peak_gib']:.2f} GiB; 2-layer kernels vs "
          f"plain {serving_2l['mixtral-8x7b']['relative_l2']:.3e}")
    print(f"generate tokens/s [qwen2.5-3b, EN-T w8a8] {gen['tok_s']:.3f}; streams equal to the "
          f"engine's {gen['streams_equal_engine']} of 8, flips above twice the paths' ordinary "
          f"difference {gen['near_ties']['faults']} of {len(gen['near_ties']['flips'])}; prefill "
          f"vs plain {gen['prefill_vs_plain']['generate']:.3e} (the engine's "
          f"{gen['prefill_vs_plain']['engine']:.3e}); 2-layer generate kernels vs plain "
          f"{gen_2l['relative_l2']:.3e}")
    for arm, r in spec.items():
        print(f"serve tokens/s [EN-T w8a8, bf16 KV, speculative k={SPEC_K}, {arm}] "
              f"{r['tok_s']:.3f} ({r['of_plain']:.3f} of plain), acceptance "
              f"{r['acceptance']:.4f}, {r['tokens_per_tick']:.3f} tokens a tick")
    a = sched["a"]
    for depth in (0, 1):
        p = a["profile"][depth]
        print(f"scheduler depth {depth}: {a['runs'][depth]['tok_s']:.3f} tok/s (18 requests); "
              f"{p['mean_host_ms']:.3f} ms a tick host-clock, {p['mean_busy_ms']:.3f} ms "
              "device busy" + (f", {100 * p['idle']:.1f}% idle" if p["idle"] is not None
                               else ""))
    print(f"scheduler: TTFT p50 / p99 {a['latency']['ttft']['p50_us']} / "
          f"{a['latency']['ttft']['p99_us']} us, ITL p50 / p99 "
          f"{a['latency']['inter_token']['p50_us']} / {a['latency']['inter_token']['p99_us']} us; "
          f"snapshot {sched['b']['snapshot_bytes']} bytes, {sched['b']['snapshot_device_ms']:.3f} "
          f"ms device, {sched['b']['snapshot_host_ms']:.3f} ms host; http smoke "
          + "; ".join(f"{k}: ttft p50 {v['ttft']['p50_us']} us, itl p50 / p99 "
                      f"{v['inter_token']['p50_us']} / {v['inter_token']['p99_us']} us"
                      for k, v in sched["d"].items()))
    runs = multi["step"]["runs"]
    print("multi-device (NCCL world of 1, 1x1 mesh), mamba2-370m step: "
          + "; ".join(f"{k} {r['seconds']:.4f} s, peak {r['peak_gib']:.2f} GiB (the step's own "
                      f"{r['transient_gib']:.2f})" for k, r in runs.items())
          + "; bit-identical; mixtral-8x7b MoE layer apply_sharded / moe.apply: "
          + "; ".join(f"T {r['T']} {r['ms']:.4f} / {r['plain_ms']:.4f} ms (y {r['y']:.3e}, "
                      f"fault {r['fault']:.3e})" for r in multi["moe"])
          + f"; fwd+bwd at T {multi['moe'][-1]['T']} {multi['moe'][-1]['fwd_bwd_ms']:.4f} / "
          f"{multi['moe'][-1]['fwd_bwd_plain_ms']:.4f} ms")
    print("planning tools: " + "; ".join(
        f"{arch} mfu {r['mfu']:.4f}, roofline total {r['total_s'] * 1e3:.2f} ms = "
        f"{r['total_s'] / r['step_s']:.3f} of the {r['step_s']:.4f} s step, peak planned / "
        f"measured {r['peak_gib']:.2f} / {r['measured_gib']:.2f} GiB"
        for arch, r in plan.items() if arch != "int8_tick")
        + "; int8 tick compute / memory / collective "
        + " / ".join(f"{plan['int8_tick']['terms'][k] * 1e3:.4f}"
                     for k in ("compute_s", "memory_s", "collective_s"))
        + f" ms against {plan['int8_tick']['busy_ms']:.3f} ms busy")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
