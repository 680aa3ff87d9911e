"""Serving latency metrics: the observability half of the async front end.

The port's own copy of ``repro/runtime/metrics.py`` (pure Python): the
same events give the same ``snapshot`` document.

Production serving lives or dies by TAIL latency, not tokens/sec — a
p99 inter-token stall from a long prefill hurts every streaming client
even when aggregate throughput looks healthy.  This module records the
numbers the synchronous bench loops never saw:

* :class:`LatencyHistogram` — bounded-memory latency recorder with
  percentile queries (p50/p99) over a sliding sample window.  Exact
  percentiles over the window (a ring buffer of the last ``window``
  samples), not bucket midpoints: serving tests assert against real
  distributions at small n, where log-bucket interpolation error
  dominates the thing being measured.
* :class:`ServingMetrics` — the request-lifecycle recorder the
  scheduler and HTTP server feed: TTFT (submit -> first token) and
  inter-token latency histograms, queue-depth gauge/high-water mark,
  shed and cancellation counters, and completed-request accounting.
  ``snapshot()`` is what ``GET /metrics`` serializes.

Both are thread-safe (one lock per object): the engine thread records
while the asyncio thread snapshots.  All record/percentile work is
plain numpy on the host — nothing here ever touches the device, so
metering cannot perturb the dispatch stream it measures.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

import numpy as np


class LatencyHistogram:
    """Latency recorder with exact percentiles over a sliding window.

    ``record`` takes seconds; queries report microseconds (the unit the
    bench JSON already speaks).  Memory is O(window): samples live in a
    fixed ring buffer, while ``count``/``total_s`` keep lifetime sums so
    throughput stays exact even after the window slides.
    """

    def __init__(self, window: int = 8192):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self._buf = np.zeros((window,), np.float64)
        self._n = 0          # valid samples in the ring
        self._head = 0
        self.count = 0       # lifetime samples
        self.total_s = 0.0   # lifetime sum (seconds)
        self._lock = threading.Lock()

    def record(self, seconds: float) -> None:
        with self._lock:
            self._buf[self._head] = seconds
            self._head = (self._head + 1) % self._buf.shape[0]
            self._n = min(self._n + 1, self._buf.shape[0])
            self.count += 1
            self.total_s += seconds

    def percentile(self, p: float) -> float | None:
        """p-th percentile in MICROSECONDS over the window (None: empty)."""
        with self._lock:
            if self._n == 0:
                return None
            return float(np.percentile(self._buf[:self._n], p)) * 1e6

    @property
    def mean_us(self) -> float | None:
        with self._lock:
            if self.count == 0:
                return None
            return self.total_s / self.count * 1e6

    def snapshot(self) -> dict:
        """{count, mean_us, p50_us, p99_us} with Nones before any sample."""
        with self._lock:
            if self._n == 0:
                return {"count": self.count, "mean_us": None,
                        "p50_us": None, "p99_us": None}
            win = self._buf[:self._n]
            return {
                "count": self.count,
                "mean_us": round(self.total_s / self.count * 1e6, 2),
                "p50_us": round(float(np.percentile(win, 50)) * 1e6, 2),
                "p99_us": round(float(np.percentile(win, 99)) * 1e6, 2),
            }


@dataclass
class _ReqTimes:
    submit_t: float
    first_token_t: float | None = None
    last_token_t: float | None = None
    tokens: int = 0


class ServingMetrics:
    """Request-lifecycle metrics for the serving front end.

    Lifecycle hooks (all take an optional ``now`` so tests and the
    scheduler can pin timestamps; default ``time.monotonic()``):

        submitted(uid)  ->  token(uid) x N  ->  finished(uid)
                        \\->  shed(reason)    (never admitted)
                        \\->  cancelled(uid)  (client went away)

    The first ``token`` records TTFT (against ``submitted``); each
    subsequent one records the inter-token gap.  ``queue_depth`` is a
    gauge the scheduler sets each tick; ``spec`` carries the engine's
    acceptance-weighted speculative stats through to ``snapshot()``.
    """

    def __init__(self, *, window: int = 8192, clock=time.monotonic):
        self.ttft = LatencyHistogram(window)
        self.itl = LatencyHistogram(window)
        self.queue_wait = LatencyHistogram(window)
        self._clock = clock
        self._lock = threading.Lock()
        self._live: dict[int, _ReqTimes] = {}
        self.queue_depth = 0
        self.queue_depth_peak = 0
        self.active_slots = 0
        self.shed_counts: dict[str, int] = {}
        self.submitted_total = 0
        self.finished_total = 0
        self.cancelled_total = 0
        self.tokens_total = 0
        # fault-tolerance counters (scheduler recovery paths feed these)
        self.fault_counts: dict[str, int] = {}   # site -> injected/observed
        self.retries_total = 0
        self.quarantined_total = 0
        self.parked_total = 0
        self.resumed_total = 0
        self.degrade_level = 0
        self.watchdog_trips = 0
        self._t0 = None       # first submit (throughput denominator)
        self._t_last = None   # most recent token/finish
        # wall-clock is USER-FACING ONLY (snapshot timestamps); every
        # latency/deadline measurement above runs on the monotonic clock
        self.started_wall = time.time()

    # .. lifecycle ..
    def submitted(self, uid: int, now: float | None = None) -> None:
        now = self._clock() if now is None else now
        with self._lock:
            self._live[uid] = _ReqTimes(submit_t=now)
            self.submitted_total += 1
            if self._t0 is None:
                self._t0 = now

    def admitted(self, uid: int, now: float | None = None) -> None:
        """Request left the queue for a slot (records queue wait)."""
        now = self._clock() if now is None else now
        with self._lock:
            rt = self._live.get(uid)
        if rt is not None:
            self.queue_wait.record(now - rt.submit_t)

    def token(self, uid: int, now: float | None = None) -> None:
        now = self._clock() if now is None else now
        with self._lock:
            rt = self._live.get(uid)
            if rt is None:         # cancelled mid-flight: token raced out
                return
            prev = rt.last_token_t
            first = rt.first_token_t is None
            if first:
                rt.first_token_t = now
            rt.last_token_t = now
            rt.tokens += 1
            self.tokens_total += 1
            self._t_last = now
            submit_t = rt.submit_t
        if first:
            self.ttft.record(now - submit_t)
        elif prev is not None:
            self.itl.record(now - prev)

    def finished(self, uid: int, now: float | None = None) -> None:
        now = self._clock() if now is None else now
        with self._lock:
            self._live.pop(uid, None)
            self.finished_total += 1
            self._t_last = now

    def shed(self, reason: str = "queue_full") -> None:
        with self._lock:
            self.shed_counts[reason] = self.shed_counts.get(reason, 0) + 1

    def cancelled(self, uid: int) -> None:
        with self._lock:
            self._live.pop(uid, None)
            self.cancelled_total += 1

    # .. fault tolerance ..
    def fault(self, site: str) -> None:
        """One fault surfaced at ``site`` (injected or organic)."""
        with self._lock:
            self.fault_counts[site] = self.fault_counts.get(site, 0) + 1

    def retried(self, uid: int | None = None) -> None:
        """One tick/request retry after a rollback."""
        del uid
        with self._lock:
            self.retries_total += 1

    def quarantined(self, uid: int) -> None:
        """Request failed past its retry budget; reported, not served."""
        with self._lock:
            self._live.pop(uid, None)
            self.quarantined_total += 1

    def watchdog_trip(self) -> None:
        with self._lock:
            self.watchdog_trips += 1

    def parked(self, uid: int) -> None:
        """Stream suspended mid-generation (elastic capacity shrink)."""
        del uid
        with self._lock:
            self.parked_total += 1

    def resumed(self, uid: int) -> None:
        del uid
        with self._lock:
            self.resumed_total += 1

    def set_degrade_level(self, level: int) -> None:
        with self._lock:
            self.degrade_level = level

    def set_queue_depth(self, depth: int, active: int | None = None) -> None:
        with self._lock:
            self.queue_depth = depth
            self.queue_depth_peak = max(self.queue_depth_peak, depth)
            if active is not None:
                self.active_slots = active

    # .. reporting ..
    @property
    def shed_total(self) -> int:
        with self._lock:
            return sum(self.shed_counts.values())

    def tokens_per_s(self) -> float | None:
        """Wall-clock emitted-token throughput, first submit -> last
        token.  For speculative engines this is acceptance-weighted by
        construction: only COMMITTED tokens are ever reported."""
        with self._lock:
            if self._t0 is None or self._t_last is None:
                return None
            dt = self._t_last - self._t0
            return self.tokens_total / dt if dt > 0 else None

    def snapshot(self, spec_stats: dict | None = None,
                 extra: dict | None = None) -> dict:
        """JSON-ready metrics document (the ``/metrics`` body)."""
        tps = self.tokens_per_s()
        with self._lock:
            out = {
                "requests": {
                    "submitted": self.submitted_total,
                    "finished": self.finished_total,
                    "cancelled": self.cancelled_total,
                    "shed": sum(self.shed_counts.values()),
                    "shed_by_reason": dict(self.shed_counts),
                    "in_flight": len(self._live),
                },
                "queue": {"depth": self.queue_depth,
                          "depth_peak": self.queue_depth_peak,
                          "active_slots": self.active_slots},
                "tokens": {"emitted": self.tokens_total,
                           "per_s": None if tps is None else round(tps, 1)},
                "faults": {
                    "by_site": dict(self.fault_counts),
                    "total": sum(self.fault_counts.values()),
                    "retries": self.retries_total,
                    "quarantined": self.quarantined_total,
                    "watchdog_trips": self.watchdog_trips,
                    "degrade_level": self.degrade_level,
                    "parked": self.parked_total,
                    "resumed": self.resumed_total,
                },
                "started_wall": self.started_wall,
            }
        out["ttft"] = self.ttft.snapshot()
        out["inter_token"] = self.itl.snapshot()
        out["queue_wait"] = self.queue_wait.snapshot()
        if spec_stats:
            drafted = spec_stats.get("drafted", 0)
            out["spec_decode"] = dict(
                spec_stats,
                acceptance=(None if not drafted
                            else round(spec_stats["accepted"] / drafted, 4)))
        if extra:
            out.update(extra)
        return out
