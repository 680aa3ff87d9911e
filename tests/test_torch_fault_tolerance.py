"""Fault-tolerant serving in the port on the CPU: the scheduler's snapshot
/ rollback envelope, retry, quarantine, watchdog and degrade; parking
and elastic capacity.

* Retried ≡ fault-free bit for bit: faults at the allocator, prefill,
  decode and sampler sites (fixed plans the reference passes), every
  result and every streamed token exactly once, at temperatures 0 and
  0.9; a rollback that keeps the generators' advanced states instead
  breaks it at 0.9.
* One stream quarantined past its retry budget, the others unchanged; a
  hung dispatch trips the watchdog (fake clock) and replays; the degrade
  ladder escalates and recovers (speculative bursts off and back on).
* Park / resume ≡ never parked, on the engine directly and through
  ``set_capacity``; ``ElasticSupervisor`` over 2 and 4 simulated hosts
  parks and resumes real streams; drain sheds new submits.
* Chaos seeds, fixed and five drawn by hypothesis: every request
  finishes bit-identical or fails with a structured error.  The leak
  check is clean after every run.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from _hypothesis_compat import given, settings, st  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.launch import serve as port_serve  # noqa: E402
from repro_torch.runtime.elastic import ElasticSupervisor, HealthMonitor  # noqa: E402
from repro_torch.runtime.faults import SITES, Fault, FaultPlan  # noqa: E402
from repro_torch.runtime.scheduler import (DONE, FAILED, PARKED, SHED,  # noqa: E402
                                           DegradePolicy, PipelinedScheduler)
from repro_torch.runtime.serve_loop import ServeEngine  # noqa: E402

CFG = reduced_config(get_config("qwen2.5-3b"))


@functools.lru_cache(maxsize=None)
def _port():
    return port_serve.build(CFG, seed=0, device="cpu")


def _requests(n, *, prefix_len=6, seed=11, temps=(0.0, 0.9), max_new=6):
    rng = np.random.default_rng(seed)
    prefix = rng.integers(1, CFG.vocab_size, prefix_len).tolist()
    return [(prefix + rng.integers(1, CFG.vocab_size, int(rng.integers(2, 8))).tolist(),
             max_new, temps[i % len(temps)]) for i in range(n)]


def _sync(reqs, **kw):
    model, params = _port()
    eng = ServeEngine(model, params, **kw)
    for toks, mx, temp in reqs:
        eng.submit(toks, max_new_tokens=mx, temperature=temp)
    return eng.run()


def _submit_all(sched, reqs):
    """Submit with per-request stream recorders; returns (uids, streams)."""
    uids, streams = [], []
    for toks, mx, temp in reqs:
        seen = []
        streams.append(seen)
        uids.append(sched.submit(toks, max_new_tokens=mx, temperature=temp,
                                 on_token=lambda t, d, s=seen: s.append((t, d))))
    return uids, streams


def _scheduler(**sched_kw):
    model, params = _port()
    engine_kw = sched_kw.pop("engine_kw")
    eng = ServeEngine(model, params, **engine_kw)
    return eng, PipelinedScheduler(eng, **sched_kw)


MULTI_SITE = [Fault("allocator.alloc", at=2), Fault("prefill.dispatch", at=1),
              Fault("decode.dispatch", at=2), Fault("decode.dispatch", at=7),
              Fault("sampler", at=3)]


@pytest.mark.parametrize("temps", [(0.0, 0.9), (0.9,)], ids=["mixed", "hot"])
def test_multi_site_faults_recover_bit_identically(temps):
    """Faults across the allocator, prefill, decode and sampler sites: the
    scheduler rolls back and replays; every result and every streamed
    token (exactly once through the rollbacks) equals the fault-free
    synchronous engine's."""
    kw = dict(slots=2, max_len=64, seed=5, top_k=8)
    reqs = _requests(5, temps=temps)
    ref = _sync(reqs, **kw)
    eng, sched = _scheduler(engine_kw=kw, prefill_chunk=4, max_retries=3)
    assert sched.depth == 0                    # fault tolerance forces depth 0
    uids, streams = _submit_all(sched, reqs)
    with FaultPlan(MULTI_SITE) as plan:
        got = sched.run()
    assert sorted((f.site, f.hit) for f in plan.fired) == sorted(
        (f.site, f.at) for f in MULTI_SITE)        # the planned schedule fired
    assert got == ref
    for uid, seen in zip(uids, streams):
        assert [t for t, _ in seen] == ref[uid]
        assert [d for _, d in seen].count(True) == 1
    eng.check_leaks()
    snap = sched.stats()
    assert snap["faults"]["total"] == len(plan.fired) == len(MULTI_SITE)
    assert snap["faults"]["retries"] == len(MULTI_SITE) and snap["faults"]["quarantined"] == 0


def test_rollback_without_generator_states_breaks_retry_identity():
    """The planted fault "restore skips the generator states": a prefill
    fault after the tick's decode sampled at temperature 0.9 replays with
    advanced generators, and the streams differ from the fault-free run."""
    kw = dict(slots=2, max_len=64, seed=5)
    reqs = _requests(5, temps=(0.9,))
    ref = _sync(reqs, **kw)
    eng, sched = _scheduler(engine_kw=kw, prefill_chunk=4, max_retries=3)
    restore = eng.restore

    def restore_keeping_generators(snap):
        keys = eng._keys
        restore(snap)
        eng._keys = keys
    eng.restore = restore_keeping_generators
    _submit_all(sched, reqs)
    with FaultPlan([Fault("prefill.dispatch", at=h) for h in (7, 10, 14)]) as plan:
        got = sched.run()
    assert len(plan.fired) == 3
    assert got != ref
    eng.check_leaks()


def test_persistent_fault_quarantines_one_stream():
    kw = dict(slots=2, max_len=64, seed=5)
    reqs = _requests(5)
    ref = _sync(reqs, **kw)
    eng, sched = _scheduler(engine_kw=kw, prefill_chunk=4, max_retries=2)
    uids, streams = _submit_all(sched, reqs)
    bad = uids[1]
    with FaultPlan([Fault("prefill.dispatch", uid=bad, times=99)]):
        got = sched.run()
    assert sched.status(bad) == FAILED
    err = sched.errors[bad]
    assert (err["site"], err["error"], err["retries"]) == ("prefill.dispatch",
                                                          "InjectedFault", 3)
    assert bad not in got and streams[1][-1] == (None, True)
    for uid, seen in zip(uids, streams):
        if uid != bad:
            assert sched.status(uid) == DONE and [t for t, _ in seen] == ref[uid]
    eng.check_leaks()
    assert sched.stats()["faults"]["quarantined"] == 1


def test_hang_trips_watchdog_and_replays():
    kw = dict(slots=2, max_len=64, seed=5)
    reqs = _requests(3, temps=(0.0, 0.9))
    ref = _sync(reqs, **kw)
    t = [0.0]

    def advance(s):
        t[0] += s
    eng, sched = _scheduler(engine_kw=kw, prefill_chunk=4, max_retries=2,
                            watchdog_timeout=1.0, clock=lambda: t[0])
    uids, streams = _submit_all(sched, reqs)
    with FaultPlan([Fault("decode.dispatch", at=1, kind="hang", seconds=5.0)],
                   sleep=advance) as plan:
        got = sched.run()
    assert got == ref and plan.fired[0].kind == "hang"
    assert sched.metrics.watchdog_trips == 1
    assert sched.stats()["faults"]["by_site"] == {"watchdog": 1}
    for uid, seen in zip(uids, streams):
        assert [tok for tok, _ in seen] == ref[uid]
    eng.check_leaks()


def test_degrade_escalation_sheds_then_recovers():
    eng, sched = _scheduler(engine_kw=dict(slots=1, max_len=64, seed=5), prefill_chunk=8,
                            max_retries=10, degrade=DegradePolicy(min_chunk=2, recover_after=2))
    a = sched.submit([1, 2, 3, 4], max_new_tokens=8)
    b = sched.submit([5, 6, 7, 8], max_new_tokens=4, priority=1)
    c = sched.submit([9, 10, 11, 12], max_new_tokens=4, priority=5)
    levels = []
    tick = sched._tick_inner

    def watched():
        levels.append((sched._degrade_level, sched.chunk, sched.state))
        return tick()
    sched._tick_inner = watched
    with FaultPlan([Fault("decode.dispatch", at=0, times=3)]) as plan:
        res = sched.run()
    assert len(plan.fired) == 3
    assert sched.status(c) == SHED and sched.metrics.shed_counts.get("degraded") == 1
    assert sched.status(a) == DONE and sched.status(b) == DONE
    assert len(res[a]) == 8 and len(res[b]) == 4
    assert (3, 4, "degraded") in levels                  # half the chunk at level 2+
    assert sched._degrade_level == 0 and sched.chunk == sched._base_chunk
    assert sched.state == "ready"
    eng.check_leaks()


def test_degrade_disables_spec_and_reenables():
    model, params = _port()
    kw = dict(slots=2, max_len=64, seed=5, draft_model=model, draft_params=params, spec_k=2,
              spec_mode="match")
    reqs = _requests(3, temps=(0.0, 0.9))
    ref = _sync(reqs, **kw)
    eng, sched = _scheduler(engine_kw=kw, max_retries=4, degrade=DegradePolicy(recover_after=2))
    for toks, mx, temp in reqs:
        sched.submit(toks, max_new_tokens=mx, temperature=temp)
    enabled = []
    step = eng.step

    def watched():
        enabled.append(eng.spec_enabled)
        return step()
    eng.step = watched
    with FaultPlan([Fault("spec.verify", at=1)]) as plan:
        got = sched.run()
    assert plan.fired and got == ref
    assert False in enabled and enabled[-1] and eng.spec_enabled
    eng.check_leaks()


# .. parking and elastic capacity ..

def test_engine_park_resume_equals_unparked():
    model, params = _port()
    kw = dict(slots=3, max_len=64, seed=5, top_k=8)
    reqs = _requests(3, temps=(0.8,), max_new=10)
    ref = _sync(reqs, **kw)
    eng = ServeEngine(model, params, **kw)
    for toks, mx, temp in reqs:
        eng.submit(toks, max_new_tokens=mx, temperature=temp)
    eng.step()
    eng.step()
    uid = eng.park_slot(max(eng._active))
    assert eng.parked_uids == [uid]
    eng.check_leaks()                          # the record holds its pages
    for _ in range(3):
        eng.step()                             # the others decode meanwhile
        eng.check_leaks()
    eng.resume_parked(uid)
    assert eng.run() == ref
    dense = ServeEngine(model, params, slots=1, max_len=32, cache_kind="dense")
    spec = ServeEngine(model, params, slots=1, max_len=32, draft_model=model,
                       draft_params=params)
    for e, msg in ((dense, "paged backend"), (spec, "speculative")):
        e.submit([1, 2, 3], max_new_tokens=4)
        e.step()
        with pytest.raises(ValueError, match=msg):
            e.park_slot(0)


def test_drop_parked_releases_pages():
    model, params = _port()
    eng = ServeEngine(model, params, slots=2, max_len=64, seed=5)
    sched = PipelinedScheduler(eng, max_retries=1)
    uids = [sched.submit(t, max_new_tokens=m, temperature=tp) for t, m, tp in _requests(2)]
    for _ in range(8):
        sched.tick()
        if len(eng._active) == 2:
            break
    sched.set_capacity(1)
    parked = [u for u in uids if sched.status(u) == PARKED]
    assert len(parked) == 1 and eng.parked_uids == parked
    assert sched.cancel(parked[0]) and not eng.parked_uids
    eng.check_leaks()
    sched.set_capacity(2)
    res = sched.run()
    assert parked[0] not in res and len(res) == 1


@pytest.mark.parametrize("hosts,depth", [(4, 0), (2, 1)])
def test_supervisor_park_resume_streams_bit_identical(hosts, depth):
    """Losing half the simulated fleet parks the youngest live streams
    mid-generation; the hosts returning resumes them, and every stream
    equals a run that never lost a host."""
    model, params = _port()
    rng = np.random.default_rng(11)
    reqs = [rng.integers(1, CFG.vocab_size, int(rng.integers(4, 9))).tolist()
            for _ in range(4)]
    kw = dict(slots=4, max_len=64, seed=5, top_k=8)
    ref = _sync([(r, 10, 0.8) for r in reqs], **kw)
    eng = ServeEngine(model, params, **kw)
    sched = (PipelinedScheduler(eng, max_retries=1) if depth == 0
             else PipelinedScheduler(eng, pipeline_depth=depth, prefill_chunk=4))
    uids = [sched.submit(toks, max_new_tokens=10, temperature=0.8) for toks in reqs]
    sup = ElasticSupervisor(sched, hosts=hosts, clock=lambda: 0.0,
                            monitor=HealthMonitor(timeout_s=10.0))
    for _ in range(24):
        sched.tick()
        if len(eng._active) == 4:
            break
    assert len(eng._active) == 4
    for h in range(hosts // 2):
        sup.beat(h, now=20.0)
    ev = sup.poll(now=20.0)
    assert ev["capacity"] == 2
    parked = [u for u in uids if sched.status(u) == PARKED]
    assert len(parked) == 2 and sorted(eng.parked_uids) == sorted(parked)
    eng.check_leaks()
    for _ in range(3):
        sched.tick()
    assert all(sched.status(u) == PARKED for u in parked)
    for h in range(hosts):
        sup.beat(h, now=21.0)
    ev = sup.poll(now=21.0)
    assert ev["capacity"] == 4 and not ev["drained"]
    assert sched.run() == ref
    assert all(sched.status(u) == DONE for u in uids) and not eng.parked_uids
    eng.check_leaks()
    assert sched.metrics.parked_total == sched.metrics.resumed_total == 2


def test_full_loss_drains_and_sheds_new_submits():
    model, params = _port()
    eng = ServeEngine(model, params, slots=2, max_len=64, seed=5)
    sched = PipelinedScheduler(eng, prefill_chunk=4)
    sup = ElasticSupervisor(sched, hosts=2, clock=lambda: 0.0,
                            monitor=HealthMonitor(timeout_s=10.0))
    a = sched.submit([1, 2, 3, 4, 5], max_new_tokens=4)
    sched.tick()
    ev = sup.poll(now=100.0)                   # every heartbeat expired
    assert ev["drained"] and sched.state == "draining" and sched.capacity == 0
    assert sched.submit([6, 7], max_new_tokens=2) is None
    assert sched.metrics.shed_counts == {"draining": 1}
    for h in range(2):
        sup.beat(h, now=101.0)
    ev = sup.poll(now=101.0)
    assert not ev["drained"] and sched.state == "ready" and sched.capacity == 2
    assert len(sched.run()[a]) == 4
    eng.check_leaks()


def _chaos_invariant(seed):
    """Under a seeded schedule every request finishes bit-identical to the
    fault-free run or fails with a structured error; zero leaks (the
    reference's ``_chaos_invariant``)."""
    kw = dict(slots=2, max_len=64, seed=5, top_k=8)
    reqs = _requests(5)
    ref = _sync(reqs, **kw)
    eng, sched = _scheduler(engine_kw=kw, prefill_chunk=4, max_retries=2)
    uids, streams = _submit_all(sched, reqs)
    plan = FaultPlan.seeded(seed, sites=("allocator.alloc", "prefill.dispatch",
                                         "decode.dispatch", "sampler"),
                            faults_per_site=2, max_at=10)
    with plan:
        got = sched.run()
    for uid, seen in zip(uids, streams):
        if sched.status(uid) == DONE:
            assert got[uid] == ref[uid] and [t for t, _ in seen] == ref[uid]
        else:
            assert sched.status(uid) == FAILED and uid not in got
            assert sched.errors[uid]["site"] in SITES and seen[-1] == (None, True)
    assert any(sched.status(u) == DONE for u in uids)
    eng.check_leaks()
    assert sched.stats()["faults"]["total"] == len(plan.fired)


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_chaos_fixed_seeds(seed):
    _chaos_invariant(seed)


@given(seed=st.integers(min_value=0, max_value=2**16))
@settings(max_examples=5, deadline=None)
def test_chaos_random_seeds(seed):
    """The reference's ``TestChaosProperty::test_random_seeds``: five seeds
    hypothesis draws."""
    _chaos_invariant(seed)
