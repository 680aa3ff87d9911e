"""The trace reading: busy time as a union of device intervals, idle gaps
by the innermost host span, annotations left out, and the tracer's
enter / exit on a machine without a card (the profiler then sees no
device op)."""

from types import SimpleNamespace

import pytest
import torch

from port_bench import trace as T

CUDA = torch.autograd.DeviceType.CUDA
CPU = torch.autograd.DeviceType.CPU


class Ev:
    def __init__(self, name, start, dur, dev=CUDA, annotation=False):
        self._n, self._s, self._d, self._t, self._a = name, start, dur, dev, annotation

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return self._t

    def is_user_annotation(self):
        return self._a


def test_busy_is_a_union_and_gaps_go_to_the_innermost_span():
    ms = 1_000_000
    events = [Ev("k1", 1 * ms, 2 * ms), Ev("k2", 2 * ms, 2 * ms),      # overlap: 1..4
              Ev("k1", 6 * ms, 1 * ms),                                 # 6..7
              Ev("bench.tick", 0, 10 * ms, annotation=True),            # a mirror: no op
              Ev("aten::mm", 0, 10 * ms, dev=CPU)]
    spans = [(0, 10 * ms, "tick"), (4 * ms, 5 * ms, "decode")]
    tr = T.read(events, spans, 0, 10 * ms, 0.010)
    assert tr.busy_s == pytest.approx(0.004)
    assert tr.kernels == {"k1": [2, pytest.approx(0.003)], "k2": [1, pytest.approx(0.002)]}
    assert tr.launches() == 3
    # gaps: 0..1 (tick), 4..6 (began in decode), 7..10 (tick)
    assert tr.gaps == {"tick": pytest.approx(0.004), "decode": pytest.approx(0.002)}
    assert tr.matching("k") == (3, pytest.approx(0.005))
    b = tr.breakdown()
    assert b["device_ops"][0][0] == "k1" and b["idle_gaps"][0][0] == "tick"


def test_spans_record_only_while_tracing():
    spans = T.Spans()
    with spans("x"):
        pass
    assert spans.items is None
    spans.items = []
    with spans("y"):
        pass
    assert [s[2] for s in spans.items] == ["y"] and spans.items[0][0] <= spans.items[0][1]


def test_tracer_round_trip_without_a_card(monkeypatch):
    """The CPU stands in for the device's activity: its ops are host
    events, so the trace reads no device op."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    cpu = torch.profiler.ProfilerActivity.CPU
    monkeypatch.setattr(torch.profiler, "ProfilerActivity", SimpleNamespace(CUDA=cpu))
    spans = T.Spans()
    with T.Tracer(True, SimpleNamespace(type="cuda"), spans) as tr:
        with spans("tick"):
            torch.ones(8) @ torch.ones(8)
    assert spans.items is None
    assert tr.trace is not None and tr.trace.busy_s == 0.0
    assert tr.trace.window_s == pytest.approx(tr.t1 - tr.t0)
    with T.Tracer(False, torch.device("cpu"), spans) as off:
        pass
    assert off.trace is None
