"""Serving metrics in the port (``runtime/metrics.py``) against the
reference's: the same events under the same fake clock give the same
``LatencyHistogram`` and ``ServingMetrics`` snapshots, percentiles and
counters (the wall-clock ``started_wall`` stamp aside)."""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.runtime import metrics as ref_metrics  # noqa: E402
from repro_torch.runtime import metrics  # noqa: E402
from repro_torch.runtime.metrics import LatencyHistogram, ServingMetrics  # noqa: E402


def _events(seed, n=200):
    """A seeded request lifecycle: submits, admissions, tokens, finishes,
    cancels, sheds, faults, parks and gauges, with rising timestamps."""
    rng = np.random.default_rng(seed)
    t, live, out = 0.0, [], []
    uid = 0
    for _ in range(n):
        t += float(rng.exponential(0.01))
        kind = rng.choice(["submit", "admit", "token", "finish", "cancel", "shed", "fault",
                           "retry", "quarantine", "park", "gauge", "degrade", "watchdog"],
                          p=[.15, .1, .35, .08, .04, .04, .04, .03, .02, .04, .06, .03, .02])
        if kind == "submit" or not live:
            out.append(("submitted", uid, t))
            live.append(uid)
            uid += 1
            continue
        u = live[int(rng.integers(len(live)))]
        if kind == "admit":
            out.append(("admitted", u, t))
        elif kind == "token":
            out.append(("token", u, t))
        elif kind == "finish":
            out.append(("finished", u, t))
            live.remove(u)
        elif kind == "cancel":
            out.append(("cancelled", u))
            live.remove(u)
        elif kind == "shed":
            out.append(("shed", str(rng.choice(["queue_full", "deadline", "draining"]))))
        elif kind == "fault":
            out.append(("fault", str(rng.choice(["sampler", "decode.dispatch", "watchdog"]))))
        elif kind == "retry":
            out.append(("retried", u))
        elif kind == "quarantine":
            out.append(("quarantined", u))
            live.remove(u)
        elif kind == "park":
            out.append(("parked", u))
            out.append(("resumed", u))
        elif kind == "gauge":
            out.append(("set_queue_depth", int(rng.integers(0, 9)), int(rng.integers(0, 4))))
        elif kind == "degrade":
            out.append(("set_degrade_level", int(rng.integers(0, 4))))
        else:
            out.append(("watchdog_trip",))
    return out


def _replay(mod, events, window):
    clock = [0.0]
    m = mod.ServingMetrics(window=window, clock=lambda: clock[0])
    for name, *args in events:
        if name in ("submitted", "admitted", "token", "finished"):
            uid, t = args
            clock[0] = t
            getattr(m, name)(uid)          # default now: the fake clock
        else:
            getattr(m, name)(*args)
    return m


@pytest.mark.parametrize("seed,window", [(0, 8192), (1, 8192), (2, 16), (3, 5)])
def test_serving_metrics_snapshot_equals_reference(seed, window):
    events = _events(seed)
    got, want = (_replay(mod, events, window) for mod in (metrics, ref_metrics))
    spec = {"ticks": 7, "drafted": 40, "accepted": 31, "emitted": 38}
    for kw in ({}, dict(spec_stats=spec, extra={"state": "ready", "capacity": 4}),
               dict(spec_stats={"drafted": 0, "accepted": 0})):
        a, b = got.snapshot(**kw), want.snapshot(**kw)
        a.pop("started_wall"), b.pop("started_wall")
        assert a == b
    assert got.tokens_per_s() == want.tokens_per_s()
    assert got.shed_total == want.shed_total
    assert a["tokens"]["emitted"] > 0 and a["ttft"]["count"] > 0


def test_latency_histogram_equals_reference():
    rng = np.random.default_rng(5)
    samples = rng.exponential(0.02, 300).tolist()
    for window in (1, 7, 64, 8192):
        port, ref = LatencyHistogram(window), ref_metrics.LatencyHistogram(window)
        assert port.snapshot() == ref.snapshot()
        for s in samples:
            port.record(s)
            ref.record(s)
        assert port.snapshot() == ref.snapshot()
        for p in (0, 50, 90, 99, 100):
            assert port.percentile(p) == ref.percentile(p)
        assert port.mean_us == ref.mean_us and port.count == ref.count == 300
    with pytest.raises(ValueError):
        LatencyHistogram(0)


def test_ttft_itl_split_and_thread_safe_record():
    t = [0.0]
    m = ServingMetrics(clock=lambda: t[0])
    m.submitted(1)
    for now in (0.5, 0.75, 1.25):
        t[0] = now
        m.token(1)
    m.finished(1)
    snap = m.snapshot()
    assert snap["ttft"]["count"] == 1 and snap["ttft"]["p50_us"] == 500000.0
    assert snap["inter_token"]["count"] == 2
    h = LatencyHistogram(window=64)

    def worker():
        for _ in range(500):
            h.record(0.001)
    threads = [threading.Thread(target=worker) for _ in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=30)
    assert not any(th.is_alive() for th in threads)
    assert h.count == 4000
