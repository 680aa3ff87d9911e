"""The traced window: ``torch.profiler`` over the measured window with the
CUDA activity alone (kernels, copies and sets, with no host op recorded,
which would slow a tick of some 6,000 launches by tens of ms), read
straight from the profiler's raw events.

What the reading gives (``Trace``):

* ``busy_s``: the union of the intervals in which a kernel, copy or set
  ran on the device (chip_smoke.py summed each kernel's time; a union is
  the same on one stream and never counts an overlap twice);
* ``window_s``: the host clock over the traced window, which opens and
  closes on a synchronised device;
* ``kernels``: {device op name: [launches, seconds]};
* ``gaps``: idle seconds between device ops, by the innermost benchmark
  span running on the host when the gap began ("window": between spans).

The harness marks its own host spans with a ``Spans`` object.
"""

from __future__ import annotations

import bisect
import contextlib
import sys
import time
from dataclasses import dataclass, field

import torch

class Spans:
    """The harness's host spans: ``with spans(name): ...`` records the host
    clock (``time.time_ns``, the clock the profiler puts the device's
    timestamps on) at its start and end while a ``Tracer`` is on, and
    nothing otherwise."""

    def __init__(self):
        self.items: list | None = None     # [(start ns, end ns, name)] while tracing

    @contextlib.contextmanager
    def _timed(self, name: str):
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.items.append((t0, time.time_ns(), name))

    def __call__(self, name: str):
        if self.items is None:
            return contextlib.nullcontext()
        return self._timed(name)


@dataclass
class Trace:
    busy_s: float
    window_s: float
    kernels: dict = field(default_factory=dict)
    gaps: dict = field(default_factory=dict)

    def matching(self, *parts: str) -> tuple[int, float]:
        """(launches, seconds) of the device ops whose name holds every one
        of ``parts``."""
        n, s = 0, 0.0
        for name, (k, t) in self.kernels.items():
            if all(p in name for p in parts):
                n, s = n + k, s + t
        return n, s

    def launches(self) -> int:
        return sum(k for k, _ in self.kernels.values())

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1][1])[:top]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[name[:160], secs] for name, (_, secs) in ops],
                "idle_gaps": [[name, secs] for name, secs in gaps]}


class Tracer:
    """``with Tracer(on, device, spans) as tr: ...``; then ``tr.trace`` (None
    when off).  The device is synchronised on entry and on exit."""

    def __init__(self, enabled: bool, device, spans: Spans):
        self.enabled = enabled and device.type == "cuda"
        self.device, self.spans = device, spans
        self.trace = None

    def __enter__(self):
        if self.enabled:
            torch.cuda.synchronize(self.device)
            self.prof = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA])
            self.prof.__enter__()
            self.spans.items = []
            self.ns0 = time.time_ns()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.t1 = time.perf_counter()
        if not self.enabled:
            return False
        ns1, spans, self.spans.items = time.time_ns(), self.spans.items, None
        t = time.perf_counter()
        self.prof.__exit__(None, None, None)
        stop_s = time.perf_counter() - t
        if exc[0] is None:
            t = time.perf_counter()
            events = self.prof.profiler.kineto_results.events()
            list_s = time.perf_counter() - t
            self.trace = read(events, spans, self.ns0, ns1, self.t1 - self.t0)
            print(f"trace: {len(events)} events; profiler stop {stop_s:.1f} s, events "
                  f"{list_s:.1f} s, reading {time.perf_counter() - t - list_s:.1f} s",
                  file=sys.stderr)
        return False


def read(events, spans, ns0: int, ns1: int, window_s: float) -> Trace:
    """A ``Trace`` from the profiler's raw events and the host spans, over
    the window [``ns0``, ``ns1``] of the host clock."""
    dev = []
    kernels: dict[str, list] = {}
    for e in events:
        if e.device_type() != torch.autograd.DeviceType.CUDA or e.is_user_annotation():
            continue        # an annotation's mirror on the device timeline is no operation
        a, d = e.start_ns(), e.duration_ns()
        dev.append((a, a + d))
        k = kernels.setdefault(e.name(), [0, 0.0])
        k[0] += 1
        k[1] += d * 1e-9
    dev.sort()
    merged = []
    for a, b in dev:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged) * 1e-9
    spans = sorted(spans)
    starts = [s[0] for s in spans]
    gaps: dict[str, float] = {}
    edges = [[ns0, ns0]] + merged + [[ns1, ns1]]
    for (_, a), (b, _) in zip(edges, edges[1:]):
        if b <= a:
            continue
        label = _label(spans, starts, a)
        gaps[label] = gaps.get(label, 0.0) + (b - a) * 1e-9
    if merged:
        print(f"trace: device ops from {1e-6 * (merged[0][0] - ns0):.3f} ms after the window "
              f"opened to {1e-6 * (ns1 - merged[-1][1]):.3f} ms before it closed",
              file=sys.stderr)
    return Trace(busy_s=busy, window_s=window_s, kernels=kernels, gaps=gaps)


def _label(spans, starts, t) -> str:
    """The innermost span covering host time ``t`` (the latest-starting one
    that has not ended), else "window": the host between spans."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - 64, -1), -1):
        if spans[j][1] > t:
            return spans[j][2]
    return "window"
