"""Elastic control logic in the port (``runtime/elastic.py``) against the
reference's: ``plan_remesh`` plans, ``StragglerPolicy`` verdicts and
backfill maps, ``HealthMonitor`` partitions and the ``ElasticSupervisor``
event records and scheduler calls, over the same simulated host
populations (pure Python, no engine)."""

import dataclasses
import itertools

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.runtime import elastic as ref_elastic  # noqa: E402
from repro.runtime import faults as ref_faults  # noqa: E402
from repro_torch.runtime import elastic, faults  # noqa: E402

REMESH = [(all_hosts, alive, mp, gb, dph)
          for all_hosts, alive in ((4, [0, 1, 2, 3]), (4, [0, 2, 3]), (4, [1, 3]), (8, [5]),
                                   (8, [7, 0, 3, 1, 6]))
          for mp, gb, dph in ((4, 64, 4), (2, 32, 4), (2, 12, 4), (8, 64, 4), (1, 6, 2))]


def _remesh(mod, args):
    all_hosts, alive, mp, gb, dph = args
    try:
        plan = mod.plan_remesh(all_hosts, list(alive), model_parallel=mp, global_batch=gb,
                               devices_per_host=dph)
    except RuntimeError as e:
        return ("raise", str(e))
    return dataclasses.asdict(plan), plan.world_size


def test_plan_remesh_equals_reference():
    outs = [_remesh(elastic, a) for a in REMESH]
    assert outs == [_remesh(ref_elastic, a) for a in REMESH]
    assert any(o[0] == "raise" for o in outs) and any(o[0] != "raise" for o in outs)


def test_straggler_policy_equals_reference():
    host_times = [{h: 1.0 for h in range(n)} for n in (3, 8, 12)]
    for times in host_times:
        times[max(times)] = 5.0
        times[0] = 2.9
    for (factor, min_obs, mode), times in itertools.product(
            ((3.0, 8, "backfill"), (2.0, 3, "skip"), (1.5, 1, "backfill")), host_times):
        port = elastic.StragglerPolicy(factor, min_obs, mode)
        ref = ref_elastic.StragglerPolicy(factor, min_obs, mode)
        verdict = [port.is_straggler(times, h) for h in list(times) + [99]]
        assert verdict == [ref.is_straggler(times, h) for h in list(times) + [99]]
        slow = [h for h, v in zip(times, verdict) if v]
        for healthy in ([h for h in times if h not in slow], []):
            assert port.reassign(slow, healthy) == ref.reassign(slow, healthy)


def test_health_monitor_equals_reference():
    beats = [(0, 0.0), (1, 0.0), (2, 3.0), (0, 9.0), (3, 12.0), (1, 20.0)]
    for timeout in (5.0, 10.0, 60.0):
        port, ref = elastic.HealthMonitor(timeout), ref_elastic.HealthMonitor(timeout)
        for h, t in beats:
            port.beat(h, now=t)
            ref.beat(h, now=t)
            for now in (t, t + 4.0, t + 11.0):
                hosts = [0, 1, 2, 3, 4]
                assert port.alive(hosts, now) == ref.alive(hosts, now)
                assert port.dead(hosts, now) == ref.dead(hosts, now)


class _StubEngine:
    def __init__(self, slots):
        self.slots = slots


class _StubScheduler:
    """Records the capacity / drain calls a supervisor makes."""

    def __init__(self, slots=8):
        self.engine = _StubEngine(slots)
        self.calls = []

    def set_capacity(self, n):
        self.calls.append(("capacity", n))

    def drain(self):
        self.calls.append(("drain",))

    def undrain(self):
        self.calls.append(("undrain",))


def _supervise(mod, fmod, slots, hosts, mp):
    """A scripted heartbeat history (partial loss, a lost beat under a
    plan, full loss, recovery) -> (poll results, events, scheduler calls)."""
    sched = _StubScheduler(slots)
    sup = mod.ElasticSupervisor(sched, hosts=hosts, clock=lambda: 0.0,
                                monitor=mod.HealthMonitor(timeout_s=10.0), model_parallel=mp)
    polls = [sup.poll(now=0.0)]
    for h in range(hosts // 2):
        sup.beat(h, now=20.0)
    polls.append(sup.poll(now=20.0))
    with fmod.FaultPlan([fmod.Fault("heartbeat", times=99)]):
        polls.append(sup.beat(0, now=25.0))
    polls.append(sup.poll(now=100.0))
    for h in range(hosts):
        sup.beat(h, now=101.0)
    polls.append(sup.poll(now=101.0))
    return polls, sup.events, sched.calls


@pytest.mark.parametrize("slots,hosts,mp", [(8, 4, None), (4, 2, None), (8, 4, 8), (5, 3, 4)])
def test_supervisor_equals_reference(slots, hosts, mp):
    got = _supervise(elastic, faults, slots, hosts, mp)
    assert got == _supervise(ref_elastic, ref_faults, slots, hosts, mp)
    polls, events, calls = got
    assert polls[2] is False                     # the injected beat was lost
    assert events[-1]["capacity"] == slots and ("drain",) in calls
