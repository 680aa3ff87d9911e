"""Run one cell of ``BENCHMARK.json`` once on the CUDA card:

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (the kernels built or found in ``src/repro_torch/_build``, the
weights and inputs made from the seed on the card, the cell's shapes
warmed) runs first and is timed from the process's start; then the
window of ``--seconds``; then, with the program's state freed, the
comparison with the plain reference that decides ``correct``.  The last
line on standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace
1`` its per-layer ones, each from ``metrics/<name>.py``), ``device``, with
``--trace 1`` ``breakdown``, then ``setup`` (what this run built) and last
``checks``: each number compared with its limit, which also end standard
error.

The run exits with a code other than 0, and prints no result, where no
CUDA card is there (or fewer than the cell asks for), and where ``jax``,
``jaxlib``, ``flax`` or the JAX package ``repro`` is loaded once the window
has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".bench_cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _environment():
    """Caches inside the checkout at fixed paths; no JAX behind a library."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name (the part before the first dot)
    is, whole, one of ``FORBIDDEN``."""
    names = sys.modules if modules is None else modules
    return sorted({n for n in names if n.split(".")[0] in FORBIDDEN})


def _fail(msg: str, code: int):
    print(msg, file=sys.stderr, flush=True)
    sys.exit(code)


def run_cell(cell, seed: int, seconds: float, trace: bool, device, t_start: float) -> dict:
    """One run of ``cell``; returns the result object."""
    import torch

    from port_bench import cell as cells
    from port_bench.trace import Tracer

    drv = cells.driver(cell)
    run = drv.Run(cell, seed, device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    t_build = time.perf_counter()
    run.setup()
    build_s = time.perf_counter() - t_build
    run.warm()
    tracer = Tracer(trace, device, run.span)
    setup_s = time.perf_counter() - t_start
    run.window(seconds, tracer)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    errors = run.free()
    numbers, attempted, failed = drv.check(run, errors)
    # what a metric reader reads
    ctx = SimpleNamespace(cell=cell, obs=run.obs, trace=tracer.trace, setup_s=setup_s,
                          peak_bytes=peak, window_s=run.obs.t_close - run.obs.t_open)
    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = cells.reader(m["name"])(ctx)
        if value is None:
            if not trace:
                raise RuntimeError(f"end-to-end metric {m['name']} read nothing")
            continue
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell.chips, "memory_peak_bytes": peak}
    out = {"correct": bool(drv.passes(numbers) and failed == 0), "attempted": attempted,
           "failed": failed, "metrics": metrics, "device": dev}
    if tracer.trace is not None:
        dev["busy_s"] = tracer.trace.busy_s
        dev["window_s"] = tracer.trace.window_s
        out["breakdown"] = tracer.trace.breakdown()
    out["setup"] = {"build_s": build_s, "built": run.built}
    out["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in numbers.items()}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    import torch

    from port_bench import cell as cells

    cell = cells.load(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        _fail(f"no result: {args.workload} needs {cell.chips} CUDA card(s), "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}", 2)
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda", 0), T_START)
    bad = forbidden_modules()
    if bad:
        _fail(f"no result: the run loaded {', '.join(bad)}", 3)
    for k, c in out["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
