#!/usr/bin/env python3
"""Time the ring's decode read and profile a full-batch ring decode tick
of one source tree on the card: full-width starcoder2-15b (EN-T weights
from seed 0, bf16 KV) on 8 slots of a 4096-row ring, the tree's own ring
read (kernel 2's ring form where the tree has it, else the paged
kernel's ring form, ``ring_decode_kernel``).

    python3 tools/profile_ring_tick.py [--src DIR] [--kernel-only]

``--src`` names the ``src`` directory whose ``repro_torch`` runs (the
default: this checkout's), so that two commits can be compared on one
card in one call, each from its own checkout, in turns.  The read is
timed at ``chip_smoke.py``'s ring check shape (``RING_POS`` /
``RING_START``, bf16) under its ``Timer`` (L2 flushed by a read before
each launch).  Without ``--kernel-only`` it then serves 8 prompts of
4,090 tokens (one 4,096-row chunk each), steps 3 ticks, and profiles 3
full-batch ticks: host ms, device busy, the ring read's device ms and
launches, and the copies a tick (``chip_smoke.copy_ms``: ``aten::copy_``'s
device time, and the kernels named for a copy).  Prints the card line,
then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

RING_KERNELS = ("flash_fwd_masked_tc", "paged_decode_tc")   # the two trees' ring reads


def ring_read(torch, cs):
    """(a function of (q, k, v, start, pos) for the tree's ring read on
    pools stored [B, W, Hkv, D], its name)."""
    from repro_torch.kernels.paged_attention import paged_attention as pa
    if hasattr(pa, "ring_decode_kernel"):
        return (lambda q, k, v, st, p: pa.ring_decode_kernel(q, k, v, p, st, window=cs.RING_W),
                "ring_decode_kernel")
    from repro_torch.kernels.flash_attention.flash_attention import flash_attention_masked

    def kernel2(q, k, v, st, p):   # as the tree's decode read: the pools transposed
        return flash_attention_masked(q, k.transpose(1, 2).contiguous(),
                                      v.transpose(1, 2).contiguous(), st, q_offsets=p,
                                      ring_width=cs.RING_W, window=cs.RING_W)
    return kernel2, "flash_attention_masked(ring_width)"


def time_read(torch, cs):
    """The tree's ring read at the check shape: the kernel alone on
    pre-transposed rows where the tree reads transposed copies, and as
    the tree's decode read calls it (copies included)."""
    g = torch.Generator(device="cuda").manual_seed(15)
    b, hq, hkv, d, w = cs.SLOTS, 48, 4, 128, cs.RING_W
    q = torch.randn((b, hq, 1, d), generator=g, device="cuda").to(torch.bfloat16)
    k = torch.randn((b, w, hkv, d), generator=g, device="cuda").to(torch.bfloat16)
    v = torch.randn((b, w, hkv, d), generator=g, device="cuda").to(torch.bfloat16)
    pos = torch.tensor(cs.RING_POS, dtype=torch.int32, device="cuda")
    start = torch.tensor(cs.RING_START, dtype=torch.int32, device="cuda")
    fn, name = ring_read(torch, cs)
    timer = cs.Timer(torch)
    as_read = timer(lambda: fn(q, k, v, start, pos))
    alone = as_read
    if name.startswith("flash"):
        from repro_torch.kernels.flash_attention.flash_attention import flash_attention_masked
        kt, vt = (t.transpose(1, 2).contiguous() for t in (k, v))
        alone = timer(lambda: flash_attention_masked(q, kt, vt, start, q_offsets=pos,
                                                     ring_width=w, window=w))
    return dict(read=name, kernel_ms=alone, as_read_ms=as_read)


def profile_tick(torch, cs):
    from torch.profiler import ProfilerActivity, profile
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as launch
    from repro_torch.runtime.serve_loop import ServeEngine

    cfg = get_config("starcoder2-15b")
    model, params = launch.build(cfg, seed=0, quantize=True)
    engine = ServeEngine(model, params, slots=cs.SLOTS, max_len=cs.RING_MAX_LEN,
                         cache_kind="ring", prefix_cache=False, seed=0)
    rng = np.random.default_rng(0)
    for _ in range(cs.SLOTS):
        engine.submit(rng.integers(0, cfg.vocab_size, 4090).tolist(), max_new_tokens=16)
    for _ in range(4):                  # 8 admissions + 1 tick, then 3 ticks
        engine.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        engine.step()
    torch.cuda.synchronize()
    host = (time.perf_counter() - t0) * 1e3 / 3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            engine.step()
        torch.cuda.synchronize()
    dev = cs.device_ms_by_kernel(prof, 3)
    counts = {ev.key: ev.count / 3 for ev in prof.key_averages()}
    ring = [k for k in dev if any(n in k for n in RING_KERNELS)]
    busy = sum(dev.values())
    engine.run()
    return dict(tick_host_ms=host, tick_busy_ms=busy, idle=1 - busy / host,
                ring_ms=sum(dev[k] for k in ring), ring_launches=sum(counts[k] for k in ring),
                copies=cs.copy_ms(prof, 3),
                top={k[:120]: v for k, v in sorted(dev.items(), key=lambda kv: -kv[1])[:10]})


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(os.path.dirname(HERE), "src"))
    ap.add_argument("--kernel-only", action="store_true")
    args = ap.parse_args(argv)
    import chip_smoke as cs   # puts this checkout's src on sys.path
    sys.path.insert(0, os.path.abspath(args.src))
    import torch
    if not torch.cuda.is_available():
        print("profile_ring_tick: no CUDA card available", file=sys.stderr)
        return 2
    import repro_torch
    print(cs.card_line(), flush=True)
    out = {"src": os.path.dirname(repro_torch.__file__), **time_read(torch, cs)}
    if not args.kernel_only:
        out.update(profile_tick(torch, cs))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
