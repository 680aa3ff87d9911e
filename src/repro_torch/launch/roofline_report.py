"""The planner's tables from ``launch/dryrun.py``'s records (port of
``benchmarks/roofline_report.py``).

    PYTHONPATH=src python -m repro_torch.launch.roofline_report \\
        [--dir experiments/dryrun_torch]

Prints the dry-run table, the roofline table (single pod, per rank, on
H100 constants) and the three hillclimb cells (worst roofline fraction,
most collective-bound, most representative of the paper's technique),
by the reference's rules.
"""

from __future__ import annotations

import argparse
import glob
import json
import os


def load(dirname):
    recs = []
    for f in sorted(glob.glob(os.path.join(dirname, "*.json"))):
        with open(f) as fh:
            recs.append(json.load(fh))
    return recs


def fmt_ms(s):
    return f"{s*1e3:.2f}"


def dryrun_table(recs):
    rows = ["| arch | shape | mesh | status | trace_s | args/rank GB | peak/rank GB (H100) "
            "| fits 80 GB | flops/rank | coll B/rank |",
            "|---|---|---|---|---|---|---|---|---|---|"]
    for r in sorted(recs, key=lambda r: (r["arch"], r["shape"], r["mesh"])):
        if r["status"] != "ok":
            why = r.get("reason", r.get("error", ""))
            rows.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                        f"{r['status']} ({why[:40]}...) | | | | | | |")
            continue
        m = r["memory"]
        rows.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | ok | "
            f"{r['trace_s']} | {m['argument_gb']:.2f} | {m['peak_per_device_gb']:.2f} | "
            f"{'yes' if m['fits_80gb'] else 'no'} | "
            f"{r['roofline']['flops_per_dev']:.2e} | "
            f"{r['roofline']['coll_bytes_per_dev']:.2e} |")
    return "\n".join(rows)


def roofline_table(recs):
    rows = ["| arch | shape | compute ms | memory ms | collective ms | bottleneck "
            "| MODEL_FLOPS/traced | roofline frac |",
            "|---|---|---|---|---|---|---|---|"]
    singles = [r for r in recs if r["status"] == "ok" and r["mesh"] == "single_pod"]
    for r in sorted(singles, key=lambda r: (r["arch"], r["shape"])):
        ro = r["roofline"]
        rows.append(
            f"| {r['arch']} | {r['shape']} | {fmt_ms(ro['compute_s'])} | "
            f"{fmt_ms(ro['memory_s'])} | {fmt_ms(ro['collective_s'])} | "
            f"**{ro['bottleneck']}** | {r['useful_flops_ratio']:.2f} | "
            f"{ro['roofline_fraction']:.3f} |")
    return "\n".join(rows)


def pick_hillclimb(recs):
    """Three DISTINCT cells: worst roofline fraction among full-sequence
    cells, most collective-bound train cell, and the EN-T-representative
    serving cell (the decode with the most FLOPs a rank: int8 serving is
    where the paper's technique lives)."""
    singles = [r for r in recs if r["status"] == "ok" and r["mesh"] == "single_pod"]
    fullseq = [r for r in singles if r["kind"] in ("train", "prefill")]
    worst = min(fullseq, key=lambda r: r["roofline"]["roofline_fraction"])
    trains = [r for r in singles if r["kind"] == "train" and r is not worst]
    coll = max(trains, key=lambda r: (r["roofline"]["collective_s"]
                                      / max(r["roofline"]["compute_s"], 1e-12)))
    decodes = [r for r in singles if r["kind"] == "decode"]
    rep = max(decodes, key=lambda r: r["roofline"]["flops_per_dev"])
    return worst, coll, rep


def report(recs) -> str:
    ok = [r for r in recs if r["status"] == "ok"]
    skipped = len([r for r in recs if r["status"] == "skipped"])
    worst, coll, rep = pick_hillclimb(recs)
    ratio = coll["roofline"]["collective_s"] / max(coll["roofline"]["compute_s"], 1e-12)
    return "\n".join([
        f"## Dry-run: {len(ok)} planned cells ({skipped} skipped by design)\n",
        dryrun_table(recs),
        "\n## Roofline (single pod, per rank, one H100 SXM each)\n",
        roofline_table(recs),
        "\n## Hillclimb selection",
        f"- worst roofline fraction: {worst['arch']} x {worst['shape']} "
        f"({worst['roofline']['roofline_fraction']:.3f})",
        f"- most collective-bound:   {coll['arch']} x {coll['shape']} "
        f"(coll/compute = {ratio:.1f}x)",
        f"- EN-T representative:     {rep['arch']} x {rep['shape']} "
        f"(busiest w8a8 decode cell)"])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)
    print(report(load(args.dir)))


if __name__ == "__main__":
    main()
