#!/usr/bin/env python3
"""Probe the split-K combine of kernels 1 and 6 (and 4 and 5) on the card
for wrong accumulators: the fault of a first call that once gave 4,651
wrong int32 accumulators of 16,384 (kernel 1's stream at M 8, K = N =
2048; ROADMAP.md section 3).

    python3 tools/probe_split_k.py first            # one fresh process
    python3 tools/probe_split_k.py loop N [--fresh-builds F] [--out FILE]
    python3 tools/probe_split_k.py stress N         # N calls in one process
    python3 tools/probe_split_k.py time [--src DIR]

``first`` makes chip_smoke.py's first matmul calls in a fresh process,
in its order (its ``check_matmuls``' operands from seed 11 at K = N =
2048, M 8: kernel 1 on the stream, int32 out, as the very first launch),
then kernels 6, 4 and 5 at M 8 and kernels 1 and 6 on the tensor-core
loop at a split shape (M 32, 2048 -> 2048).  Each output is held against
the card's float64 reference and the CPU's int64 product of the same
operands, and the split workspaces are read after each call; it prints
one JSON line (``chip_smoke.diagnose_exact``'s reading on a mismatch).
``loop`` runs ``first`` in N fresh processes, the first F of them each
after deleting the built matmul libraries (a fresh build), and prints
the counts (``--out``: every process's record as JSON).  ``stress`` makes N calls of kernels 1 and 6 on both routes
at shapes that grow the workspace (dropped and regrown every 4,000
calls), alternating two CUDA streams call by call, each output against
its CPU int64 product, the workspaces read every 2,000 calls.  ``time``
times kernel 1's and 6's stream at M 8, 2048 -> 11008 and kernel 1's
tensor-core loop at M 32, 2048 -> 2048 (split) of the tree whose ``src``
``--src`` names, under chip_smoke.py's Timer, and the host microseconds a
call of kernel 1's and kernel 3's public wrappers take where their kernels
are shorter than the host's work; run it for the parent and the change
in one call, in turns.  Every mode prints the card line first.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
HOST_CALLS = 20000   # calls a host-time reading of ``time`` averages
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)


def cpu_product(torch, xq, w8):
    """The int32 accumulator X @ W from the operands copied to the host,
    in int64."""
    return (xq.cpu().long() @ w8.cpu().long()).to(torch.int32)


def held(torch, cs, what, got, x, sx, sw, w8, route, tc_bm=128):
    """One call's reading: equal to the card's float64 reference, to the
    CPU's int64 product, and the split workspaces' state after it."""
    from repro_torch.kernels.ent_matmul.ref import quantize_with_scale
    from repro_torch.kernels.int8_matmul.ref import int8_matmul_int32_ref
    torch.cuda.synchronize()
    xq = x if x.dtype == torch.int8 else quantize_with_scale(x, sx)
    card = int8_matmul_int32_ref(xq, w8)
    xh = x.cpu()
    xq_h = xh if xh.dtype == torch.int8 else quantize_with_scale(xh.float(), sx.cpu())
    cpu = cpu_product(torch, xq_h, w8).to(got.device)
    row = dict(what=what, route=route, vs_card_ref=int((got != card).sum()),
               vs_cpu=int((got != cpu).sum()), card_ref_vs_cpu=int((card != cpu).sum()),
               workspaces={cs._ws_key(k): v for k, v in cs.workspace_state(torch).items()})
    if row["vs_card_ref"] or row["vs_cpu"] or row["card_ref_vs_cpu"]:
        row["diagnosis"] = cs.diagnose_exact(torch, what, got, card if row["vs_card_ref"] else cpu,
                                             x, sx, sw, w8, route, tc_bm)
    return row


def first(torch, cs):
    """chip_smoke.py's first matmul calls, in a fresh process."""
    from repro_torch.core.multiplier import ent_packed_planes
    from repro_torch.kernels.ent_matmul import ent_matmul as em
    from repro_torch.kernels.ent_matmul.ops import encode_weights, row_scale
    from repro_torch.kernels.ent_matmul.ref import quantize_with_scale
    from repro_torch.kernels.int8_matmul import int8_matmul as im
    t0 = time.perf_counter()
    timer = cs.Timer(torch)   # as chip_smoke.py's kernel checks begin
    g = torch.Generator(device=cs.DEV).manual_seed(11)
    k, n, m = 2048, 2048, 8
    w8 = torch.randint(-127, 128, (k, n), generator=g, device=cs.DEV, dtype=torch.int8)
    packed = ent_packed_planes(w8).contiguous()
    planes = encode_weights(w8).contiguous()
    sw = torch.rand((1, n), generator=g, device=cs.DEV) * 1e-2 + 1e-4
    x = torch.randn((m, k), generator=g, device=cs.DEV).to(torch.bfloat16)
    sx = row_scale(x)
    xq = quantize_with_scale(x, sx)
    from repro_torch.kernels.int8_matmul.ref import int8_matmul_int32_ref
    int8_matmul_int32_ref(xq, w8)   # chip_smoke.py computes X @ W before the first call
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    got = em.ent_matmul_packed_fused(x, packed, sx, sw, torch.int32)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t1) * 1e3
    rows = [held(torch, cs, "kernel 1 M 8 2048->2048 (first call)", got, x, sx, sw, w8, "stream")]
    for what, call, xx in (
            ("kernel 6 M 8", lambda: im.int8_matmul(xq, w8, sx, sw, torch.int32), xq),
            ("kernel 4 M 8", lambda: em.ent_matmul_packed(xq, packed, sx, sw, torch.int32), xq),
            ("kernel 5 M 8", lambda: em.ent_matmul(xq, planes, sx, sw, torch.int32), xq),
            ("kernel 1 M 8 again", lambda: em.ent_matmul_packed_fused(x, packed, sx, sw,
                                                                      torch.int32), x)):
        rows.append(held(torch, cs, f"{what} 2048->2048", call(), xx, sx, sw, w8, "stream"))
    x32 = torch.randn((32, k), generator=g, device=cs.DEV).to(torch.bfloat16)
    sx32 = row_scale(x32)
    xq32 = quantize_with_scale(x32, sx32)
    rows.append(held(torch, cs, "kernel 1 M 32 2048->2048 tensor-core (split)",
                     em._launch_fused(x32, packed, sx32, sw, torch.int32, "tc"), x32, sx32, sw,
                     w8, "tc"))
    rows.append(held(torch, cs, "kernel 6 M 32 2048->2048 tensor-core (split)",
                     im._launch(xq32, w8, sx32, sw, torch.int32, "tc"), xq32, sx32, sw, w8, "tc"))
    del timer
    wrong = sum(1 for r in rows if r["vs_card_ref"] or r["vs_cpu"] or r["card_ref_vs_cpu"])
    print(json.dumps(dict(pid=os.getpid(), first_call_ms=first_ms,
                          process_s=time.perf_counter() - t0, wrong_calls=wrong, calls=rows)),
          flush=True)
    return 1 if wrong else 0


def loop(n, fresh_builds, out=None):
    """``first`` in ``n`` fresh processes, the first ``fresh_builds`` after
    deleting the matmul libraries; every process's record into ``out``."""
    from repro_torch.kernels import _build
    runs, t0 = [], time.perf_counter()
    for i in range(n):
        fresh = i < fresh_builds
        if fresh:
            for name in ("ent_matmul", "int8_matmul"):
                for so in glob.glob(str(_build.BUILD_DIR / f"lib{name}-*.so")):
                    os.unlink(so)
        t1 = time.perf_counter()
        p = subprocess.run([sys.executable, os.path.abspath(__file__), "first"],
                           capture_output=True, text=True, timeout=900)
        lines = [ln for ln in p.stdout.splitlines() if ln.startswith("{")]
        rec = json.loads(lines[-1]) if lines else dict(wrong_calls=None)
        rec.update(rc=p.returncode, fresh_build=fresh, seconds=time.perf_counter() - t1)
        if p.returncode or not lines:
            rec["stderr_tail"] = p.stderr[-2000:]
            print(p.stdout[-4000:], flush=True)
        runs.append(rec)
        print(f"probe process {i}: rc {p.returncode}, fresh build {fresh}, wrong calls "
              f"{rec.get('wrong_calls')}, first call {rec.get('first_call_ms', 0):.1f} ms, "
              f"{rec['seconds']:.1f} s", flush=True)
    summary = dict(processes=n, fresh_builds=fresh_builds,
                   processes_with_wrong=sum(1 for r in runs if r.get("wrong_calls")),
                   failed=sum(1 for r in runs if r["rc"] and not r.get("wrong_calls")),
                   calls=sum(len(r.get("calls", ())) for r in runs),
                   first_call_ms=[round(r.get("first_call_ms", -1), 2) for r in runs],
                   seconds=time.perf_counter() - t0)
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as f:
            json.dump(dict(summary=summary, runs=runs), f, indent=1)
    print(json.dumps(summary), flush=True)
    return 1 if summary["processes_with_wrong"] or summary["failed"] else 0


def stress(torch, cs, n_calls, seed=5):
    """``n_calls`` calls of kernels 1 and 6 on both routes, two CUDA streams."""
    import numpy as np
    from repro_torch.core.multiplier import ent_packed_planes
    from repro_torch.kernels import _build
    from repro_torch.kernels.ent_matmul import ent_matmul as em
    from repro_torch.kernels.ent_matmul.ops import row_scale
    from repro_torch.kernels.ent_matmul.ref import quantize_with_scale
    from repro_torch.kernels.int8_matmul import int8_matmul as im
    g = torch.Generator(device=cs.DEV).manual_seed(seed)
    cases = []
    for k, n in ((2048, 256), (2048, 2048), (2048, 11008), (11008, 2048)):
        w8 = torch.randint(-127, 128, (k, n), generator=g, device=cs.DEV, dtype=torch.int8)
        packed = ent_packed_planes(w8).contiguous()
        sw = torch.rand((1, n), generator=g, device=cs.DEV) * 1e-2 + 1e-4
        for m, route in ((1, "stream"), (5, "stream"), (8, "stream"), (16, "stream"),
                         (32, "tc"), (64, "tc")):
            x = torch.randn((m, k), generator=g, device=cs.DEV).to(torch.bfloat16)
            sx = row_scale(x)
            xq = quantize_with_scale(x, sx)
            want = cpu_product(torch, quantize_with_scale(x.cpu().float(), sx.cpu()),
                               w8).to(cs.DEV)
            cases.append((f"kernel 1 {route} M {m} {k}->{n}",
                          lambda x=x, p=packed, sx=sx, sw=sw, r=route:
                          em._launch_fused(x, p, sx, sw, torch.int32, r), want))
            cases.append((f"kernel 6 {route} M {m} {k}->{n}",
                          lambda xq=xq, w=w8, sx=sx, sw=sw, r=route:
                          im._launch(xq, w, sx, sw, torch.int32, r), want))
    streams = (torch.cuda.current_stream(), torch.cuda.Stream())
    streams[1].wait_stream(streams[0])
    rng = np.random.default_rng(seed)
    order = rng.integers(len(cases), size=n_calls)
    hits, pending, resets, checks = [], [], 0, 0
    t0 = time.perf_counter()
    for i, c in enumerate(order):
        s = streams[i % 2]
        with torch.cuda.stream(s):
            got = cases[c][1]()
            pending.append((i, int(c), (got != cases[c][2]).sum()))
        if (i + 1) % 2000 == 0 or i + 1 == n_calls:
            torch.cuda.synchronize()
            counts = torch.stack([p[2] for p in pending]).cpu().tolist()
            hits += [dict(call=p[0], case=cases[p[1]][0], wrong=w)
                     for p, w in zip(pending, counts) if w]
            pending.clear()
            state = cs.workspace_state(torch)
            checks += 1
            if any(w or t for w, t in state.values()):
                hits.append(dict(call=i, workspaces={cs._ws_key(k): v for k, v in state.items()}))
            if checks % 2 == 0:   # drop the workspaces: the next calls regrow them
                for key in [key for key in _build._workspaces if len(key) == 2]:
                    del _build._workspaces[key]
                resets += 1
    seconds = time.perf_counter() - t0
    out = dict(calls=n_calls, cases=len(cases), streams=2, workspace_resets=resets,
               workspace_checks=checks, hits=hits[:50], n_hits=len(hits), seconds=seconds)
    print(json.dumps(out), flush=True)
    return 1 if hits else 0


def time_tree(torch, cs):
    """Kernel 1's and 6's times at the probe's shapes, this tree."""
    import repro_torch
    from repro_torch.core.multiplier import ent_packed_planes
    from repro_torch.kernels.ent_matmul import ent_matmul as em
    from repro_torch.kernels.ent_matmul.ops import row_scale
    from repro_torch.kernels.ent_matmul.ref import quantize_with_scale
    from repro_torch.kernels.int8_matmul import int8_matmul as im
    timer = cs.Timer(torch)
    g = torch.Generator(device=cs.DEV).manual_seed(3)
    rows = {}
    for m, k, n, route in ((8, 2048, 11008, "stream"), (32, 2048, 2048, "tc")):
        w8 = torch.randint(-127, 128, (k, n), generator=g, device=cs.DEV, dtype=torch.int8)
        packed = ent_packed_planes(w8).contiguous()
        sw = torch.rand((1, n), generator=g, device=cs.DEV) * 1e-2 + 1e-4
        x = torch.randn((m, k), generator=g, device=cs.DEV).to(torch.bfloat16)
        sx = row_scale(x)
        xq = quantize_with_scale(x, sx)
        rows[f"kernel 1 {route} M {m} {k}->{n}"] = timer(
            lambda: em._launch_fused(x, packed, sx, sw, torch.float32, route), reps=50)
        rows[f"kernel 6 {route} M {m} {k}->{n}"] = timer(
            lambda: im._launch(xq, w8, sx, sw, torch.float32, route), reps=50)
    # host microseconds a call through the public wrappers, at shapes whose
    # kernels take less than the host: kernel 1 at a decode tick's k / v
    # projection (M 8, 2048 -> 256) and kernel 3 at the serving tick
    w8 = torch.randint(-127, 128, (2048, 256), generator=g, device=cs.DEV, dtype=torch.int8)
    packed = ent_packed_planes(w8).contiguous()
    sw = torch.rand((1, 256), generator=g, device=cs.DEV) * 1e-2 + 1e-4
    x = torch.randn((8, 2048), generator=g, device=cs.DEV).to(torch.bfloat16)
    sx = row_scale(x)
    q, kp, vp, table, pos, start, _ = cs.paged_case(torch, cs.PAGED_CASES["tick"], False)
    from repro_torch.kernels.paged_attention.paged_attention import paged_attention_kernel
    host = {}
    for what, fn in (("kernel 1 wrapper M 8 2048->256",
                      lambda: em.ent_matmul_packed_fused(x, packed, sx, sw, torch.bfloat16)),
                     ("kernel 3 wrapper, the serving tick",
                      lambda: paged_attention_kernel(q, kp, vp, table, pos, start, page_size=16))):
        for _ in range(200):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(HOST_CALLS):
            fn()
        torch.cuda.synchronize()
        host[what] = (time.perf_counter() - t0) / HOST_CALLS * 1e6
    print(json.dumps({"src": os.path.dirname(repro_torch.__file__), "ms": rows, "host_us": host}),
          flush=True)
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=("first", "loop", "stress", "time"))
    ap.add_argument("n", nargs="?", type=int, default=50)
    ap.add_argument("--fresh-builds", type=int, default=0)
    ap.add_argument("--out", help="loop: a JSON file for every process's record")
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    args = ap.parse_args(argv)
    import chip_smoke as cs   # puts this checkout's src on sys.path
    sys.path.insert(0, os.path.abspath(args.src))
    import torch
    if not torch.cuda.is_available():
        print("probe_split_k: no CUDA card available", file=sys.stderr)
        return 2
    if args.mode != "first":
        print(cs.card_line(), flush=True)
    if args.mode == "first":
        return first(torch, cs)
    if args.mode == "loop":
        return loop(args.n, args.fresh_builds, args.out)
    if args.mode == "stress":
        return stress(torch, cs, args.n)
    return time_tree(torch, cs)


if __name__ == "__main__":
    sys.exit(main())
