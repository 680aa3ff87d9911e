"""The program's own spans (``repro_torch.tracing``) laid over the device
trace.  Both sit on the host clock ``time.time_ns``, onto which the
profiler puts the device's timestamps, as the harness's ``Spans`` do.

``trace`` below is any object with ``ns0`` and ``ns1`` (the traced
window on that clock), ``intervals`` (the merged device intervals,
[start ns, end ns], in order, as ``trace.read`` builds them) and
``program`` (the spans ``repro_torch.tracing.disable()`` returned over
the window).

An idle gap belongs to the host activity under way when it began, the
rule ``trace._label`` applies to the harness's spans: here, to a span
named ``root`` when the gap begins while one is open.  A span's
descendants open on its thread and close before it does, so a gap that
begins inside a descendant begins inside ``root`` too; spans open on
other threads meanwhile do not take it away.
"""

from __future__ import annotations

import bisect


def _gaps(trace):
    """(start ns, end ns) of each idle gap of the window."""
    edges = [(trace.ns0, trace.ns0), *trace.intervals, (trace.ns1, trace.ns1)]
    for (_, a), (b, _) in zip(edges, edges[1:]):
        if b > a:
            yield a, b


def _merged(spans) -> list:
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def idle_s(trace, root: str) -> float:
    """Idle seconds of the window in gaps that begin while a span named
    ``root`` (or one of its descendants) is open."""
    spans = _merged((s.start_ns, s.end_ns) for s in trace.program if s.name == root)
    starts = [a for a, _ in spans]
    idle = 0
    for a, b in _gaps(trace):
        i = bisect.bisect_right(starts, a) - 1
        if i >= 0 and a < spans[i][1]:
            idle += b - a
    return idle * 1e-9


def total_ms(trace, name: str) -> float:
    """Milliseconds of host time in the spans named ``name``."""
    return 1e-6 * sum(s.end_ns - s.start_ns for s in trace.program if s.name == name)
