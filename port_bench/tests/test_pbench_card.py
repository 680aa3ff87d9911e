"""The benchmark on the card: each cell once, briefly, through the command
``BENCHMARK.json`` gives, and the line it prints.  Skips without a CUDA
card.  On the card:

    python3 -m pytest -q -p no:cacheprovider port_bench/tests/test_pbench_card.py
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.card
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_correct_on_the_card(card, cell, trace):
    cmd = BENCH["command"] + ["--workload", cell, "--seed", str(2**31 + 3), "--seconds", "5",
                              "--trace", str(trace)]
    r = subprocess.run([sys.executable if c == "python3" else c for c in cmd], cwd=ROOT,
                       capture_output=True, text=True, timeout=1200)
    assert r.returncode == 0, r.stderr[-4000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "checks"
    assert out["device"]["platform"] == "gpu" and out["device"]["count"] == 1
    if trace:
        assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
        assert len(out["breakdown"]["device_ops"]) <= 10
        for name, m in out["metrics"].items():
            if "roofline" in name or "mfu" in name:
                assert 0 < m["value"] <= 100, (name, m)
