#!/usr/bin/env python3
"""Time the paged decode kernel (kernels 3 and 3b) of one source tree on
the card, at chip_smoke.py's serving-tick call and its long-context call
(8 slots x 4096 tokens), with bf16 pools and with int8 pools + bf16
scales, under chip_smoke.py's Timer (L2 flushed by a read before each
launch).

    python3 tools/time_paged.py [--src DIR]

``--src`` names the ``src`` directory whose ``repro_torch`` is timed (the
default: this checkout's), so that two commits can be compared on one
card in one call, in turns (parent, change, change, parent), each from
its own checkout.  The operands come from chip_smoke.py's ``paged_case``.
Prints the card line, then one JSON line of ms and bounds.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(os.path.dirname(HERE), "src"))
    args = ap.parse_args(argv)
    import chip_smoke as cs   # puts this checkout's src on sys.path
    sys.path.insert(0, os.path.abspath(args.src))
    import torch
    if not torch.cuda.is_available():
        print("time_paged: no CUDA card available", file=sys.stderr)
        return 2
    from repro_torch.kernels.paged_attention import ops as paged_ops
    from repro_torch.kernels.paged_attention.paged_attention import paged_attention_kernel
    import repro_torch
    print(cs.card_line(), flush=True)
    timer = cs.Timer(torch)
    rows = {}
    for name, spec in (("tick", cs.PAGED_CASES["tick"]), ("long", cs.PAGED_LONG)):
        for int8_kv in (False, True):
            q, kp, vp, table, pos, start, scales = cs.paged_case(torch, spec, int8_kv)
            page = kp.shape[1]
            ms = timer(lambda: paged_attention_kernel(q, kp, vp, table, pos, start, *scales,
                                                      page_size=page))
            bnd, by = cs.cost_bounds(paged_ops, "paged_attention_kernel", q, kp, vp, table, pos,
                                     start, *scales, page_size=page)["paged_attention_kernel"][:2]
            live = cs.live_pages(torch, table, pos, start, page)
            rows[f"{name}{'[int8_kv]' if int8_kv else ''}"] = dict(ms=ms, bound_ms=bnd,
                                                                    bound_by=by, live_pages=live)
    print(json.dumps({"src": os.path.dirname(repro_torch.__file__), "paged": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
