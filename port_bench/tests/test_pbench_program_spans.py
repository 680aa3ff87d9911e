"""The program's spans over a device trace (``program_spans.py``): idle gaps
go to the span open when they began, descendants included; attributed
idle never passes the window's idle; the program's ``sched.decode``
takes at least the harness's "decode" gaps when that span lies inside
it.  Device events, harness spans and program spans are planted."""

from types import SimpleNamespace

import numpy as np
import pytest

from port_bench import program_spans as P
from port_bench import trace as T
from repro_torch.tracing import Span
from test_pbench_trace import Ev

MS = 1_000_000


def _trace(events, program, ns0, ns1):
    intervals = P._merged((e.start_ns(), e.start_ns() + e.duration_ns()) for e in events)
    return SimpleNamespace(ns0=ns0, ns1=ns1, intervals=intervals, program=program)


def test_gaps_go_to_the_span_open_when_they_began():
    events = [Ev("k", 1 * MS, 3 * MS), Ev("k", 6 * MS, 1 * MS), Ev("k", 12 * MS, 1 * MS)]
    program = [Span(0, 15 * MS, "sched.tick", 1, None, 1, {}),
               Span(3 * MS, 8 * MS, "sched.decode", 2, 1, 1, {"rows": 4}),
               Span(5 * MS, 7 * MS, "inner", 3, 2, 1, {}),
               Span(16 * MS, 18 * MS, "sched.tick", 4, None, 1, {}),
               Span(0, 19 * MS, "req.queued", 5, None, 1, {"uid": 0})]
    tr = _trace(events, program, 0, 20 * MS)
    # gaps 0..1 (tick), 4..6 and 7..12 (decode), 13..20 (tick)
    assert P.idle_s(tr, "sched.decode") == pytest.approx(0.007)
    assert P.idle_s(tr, "sched.tick") == pytest.approx(0.015)
    assert P.idle_s(tr, "inner") == 0.0
    assert P.idle_s(tr, "req.queued") == pytest.approx(0.015)   # open throughout
    assert P.idle_s(tr, "nothing") == 0.0
    assert P.total_ms(tr, "sched.tick") == pytest.approx(17.0)
    assert P.total_ms(tr, "sched.decode") == pytest.approx(5.0)
    # a gap beginning inside a descendant belongs to its root
    program[2] = Span(7 * MS, 7 * MS + 500, "inner", 3, 2, 1, {})
    assert P.idle_s(_trace(events, program, 0, 20 * MS), "inner") == pytest.approx(0.005)
    # no device op at all: the window is one gap, from its opening
    assert P.idle_s(_trace([], program, 0, 20 * MS), "sched.tick") == pytest.approx(0.020)
    assert P.idle_s(_trace([], program, 0, 20 * MS), "sched.decode") == 0.0


def _planted(seed):
    """Random device ops inside 100 ms; ticks back to back, each with a decode
    span inside it and the harness's "decode" span inside that; a
    request-long span across."""
    rng = np.random.default_rng(seed)
    starts = np.sort(rng.integers(0, 97 * MS, 40))      # each op ends inside the window
    events = [Ev("k", int(a), int(rng.integers(MS // 10, 3 * MS))) for a in starts]
    program, harness, t, sid = [], [], 0, 1
    while t < 95 * MS:
        end = t + int(rng.integers(2 * MS, 10 * MS))
        d0 = t + int(rng.integers(0, MS))
        d1 = d0 + int(rng.integers(MS // 2, end - d0))
        program += [Span(t, end, "sched.tick", sid, None, 1, {}),
                    Span(d0, d1, "sched.decode", sid + 1, sid, 1, {"rows": 8})]
        h0 = d0 + int(rng.integers(0, (d1 - d0) // 2))
        harness += [(t, end, "tick"), (h0, h0 + int(rng.integers(1, d1 - h0)), "decode")]
        t, sid = end + int(rng.integers(0, MS)), sid + 2
    program.append(Span(2 * MS, 90 * MS, "req.queued", sid, None, 2, {"uid": 3}))
    return events, program, harness


@pytest.mark.parametrize("seed", range(12))
def test_attributed_idle_is_bounded_and_covers_the_harness_decode(seed):
    events, program, harness = _planted(seed)
    ns0, ns1 = 0, 100 * MS
    tr = _trace(events, program, ns0, ns1)
    read = T.read(events, harness, ns0, ns1, (ns1 - ns0) * 1e-9)
    idle = read.window_s - read.busy_s
    decode, tick = P.idle_s(tr, "sched.decode"), P.idle_s(tr, "sched.tick")
    assert 0.0 <= decode <= tick <= idle + 1e-12
    assert P.idle_s(tr, "req.queued") <= idle + 1e-12
    assert decode >= read.gaps.get("decode", 0.0) - 1e-12
    assert tick >= read.gaps.get("decode", 0.0) + read.gaps.get("tick", 0.0) - 1e-12
