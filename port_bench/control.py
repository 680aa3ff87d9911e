"""The readings behind each limit in ``checks/<cell>.json``, for many seeds in
one process (the benchmark's own runs never run this):

    python3 port_bench/control.py --workload <cell> --seeds 11,12,13 --seconds 15

For every seed it runs the program as a run of the cell does (set-up, the
window of ``--seconds``) and prints one JSON line with the program's
numbers against the plain reference (the lower readings), then:

* a served cell: the control, the reference with its weights at int4 (the
  step below the configuration's int8) put in the program's place: the
  widest gap of the token it puts first at each served position;
* a training cell: the control, the reference computed in float8 e4m3 (the
  step below the configuration's bf16 compute), and the planted fault
  "half of the batch left out, the mean taken over the rest", each read
  by the same numbers against the float32 reference.  (The fault "a step
  that returns its state unchanged" reads 1 on ``change_gap`` by
  construction.)
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from port_bench.run import _environment  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=15)
    ap.add_argument("--dump", default=None,
                    help="a directory for every leaf's readings (training cells)")
    args = ap.parse_args(argv)
    _environment()
    import torch

    from port_bench import cell as cells

    cell = cells.load(args.workload)
    drv = cells.driver(cell)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        sys.exit(2)
    dev = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        run = drv.Run(cell, seed, dev)
        run.setup()
        run.warm()
        out = drv.control(run, args.seconds, args.dump)
        print(json.dumps({"seed": seed, "seconds": time.perf_counter() - t0, **out}), flush=True)
        del run
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
