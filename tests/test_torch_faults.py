"""Fault injection and the engine's rollback boundary in the port, on the
CPU.

* The port's ``runtime/faults.py`` against the reference's: trigger
  windows, uid filters, hang faults, nesting, validation, the named
  "ci-chaos" plan and ``FaultPlan.seeded(s)`` schedules for several
  seeds, fault for fault.
* The allocator's ``"allocator.alloc"`` point fires at the reference's
  hits, and its snapshot unwinds a failed tick's partial work.
* ``ServeEngine.snapshot`` -> ``restore`` replays bit for bit on the
  plain path (streams and every pool tensor) on the paged, prefix-shared,
  int8-KV and dense backends at temperatures 0 and 0.9; one snapshot
  restores twice; a restore that keeps the generators' advanced states
  instead breaks the replay (the check can fail).
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.runtime import faults as ref_faults  # noqa: E402
from repro.runtime.page_allocator import PageAllocator as RefAllocator  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.launch import serve as port_serve  # noqa: E402
from repro_torch.runtime import faults  # noqa: E402
from repro_torch.runtime.faults import (SITES, Fault, FaultPlan, InjectedFault,  # noqa: E402
                                        active_plan, fault_point)
from repro_torch.runtime.page_allocator import PageAllocator  # noqa: E402
from repro_torch.runtime.serve_loop import ServeEngine  # noqa: E402


def _as_tuples(plan):
    return [dataclasses.astuple(f) for f in plan.faults]


# .. the harness against the reference's ..

def _drive_plan(mod, faults_, calls):
    """Observe ``calls`` [(site, ctx)] under a plan of ``faults_`` built
    from module ``mod``; returns what each call did, the hits and the
    fired record."""
    slept = []
    plan = mod.FaultPlan([mod.Fault(*f) for f in faults_], sleep=slept.append)
    out = []
    with plan:
        for site, ctx in calls:
            try:
                mod.fault_point(site, **ctx)
                out.append("ok")
            except mod.InjectedFault as e:
                out.append(("raise", e.site, e.hit, e.uid, str(e)))
    return out, plan.hits, [dataclasses.astuple(f) for f in plan.fired], slept


PLANS = {
    "window": ([("sampler", 2, 2)], [("sampler", {})] * 5),
    "uid": ([("sampler", 0, 99, 7)],
            [("sampler", {"uid": 3}), ("sampler", {}), ("sampler", {"uid": 7}),
             ("decode.dispatch", {"uid": 7})]),
    "hang": ([("decode.dispatch", 1, 1, None, "hang", 2.5), ("sampler", 0)],
             [("decode.dispatch", {}), ("decode.dispatch", {}), ("sampler", {"uid": 1})]),
    "mixed": ([("allocator.alloc", 1), ("prefill.dispatch", 0, 2, 4), ("heartbeat", 3)],
              [("allocator.alloc", {"n": 1}), ("allocator.alloc", {"n": 2}),
               ("prefill.dispatch", {"uid": 4}), ("prefill.dispatch", {"uid": 5}),
               ("heartbeat", {"host": 0})] + [("heartbeat", {"host": 1})] * 3),
}


@pytest.mark.parametrize("name", sorted(PLANS))
def test_plan_equals_reference(name):
    plan, calls = PLANS[name]
    assert _drive_plan(faults, plan, calls) == _drive_plan(ref_faults, plan, calls)


def test_trigger_window_uid_filter_and_hang():
    plan = FaultPlan([Fault("sampler", at=2, times=2)])
    with plan:
        for expect_raise in (False, False, True, True, False):
            if expect_raise:
                with pytest.raises(InjectedFault) as ei:
                    fault_point("sampler")
                assert ei.value.site == "sampler"
            else:
                fault_point("sampler")
    assert plan.hits == {"sampler": 5}
    assert [(f.site, f.hit) for f in plan.fired] == [("sampler", 2), ("sampler", 3)]
    with FaultPlan([Fault("sampler", times=99, uid=7)]) as p2:
        fault_point("sampler", uid=3)
        fault_point("sampler")
        with pytest.raises(InjectedFault) as ei:
            fault_point("sampler", uid=7)
        assert ei.value.uid == 7
    assert p2.hits["sampler"] == 3
    slept = []
    with FaultPlan([Fault("decode.dispatch", kind="hang", seconds=2.5)],
                   sleep=slept.append) as p3:
        fault_point("decode.dispatch")             # a late return, no raise
    assert slept == [2.5] and p3.fired[0].kind == "hang"


def test_inactive_is_noop_and_plans_nest():
    fault_point("sampler")
    assert active_plan() is None
    outer = FaultPlan([Fault("sampler", times=99)])
    inner = FaultPlan([])
    with outer:
        with inner:
            assert active_plan() is inner
            fault_point("sampler")
        with pytest.raises(InjectedFault):
            fault_point("sampler")
    assert outer.hits == {"sampler": 1} and inner.hits == {"sampler": 1}
    # the two packages keep separate stacks: a reference plan sees no port hit
    with ref_faults.FaultPlan([ref_faults.Fault("sampler", times=99)]) as ref_plan:
        fault_point("sampler")
    assert ref_plan.hits == {}


@pytest.mark.parametrize("seed", [0, 1, 7, 11, 1234])
def test_seeded_schedules_equal_reference(seed):
    for kw in ({}, dict(sites=("allocator.alloc", "prefill.dispatch", "decode.dispatch",
                               "sampler"), faults_per_site=2, max_at=10)):
        port, ref = FaultPlan.seeded(seed, **kw), ref_faults.FaultPlan.seeded(seed, **kw)
        assert _as_tuples(port) == _as_tuples(ref)
        assert port.name == ref.name == f"seeded-{seed}"
    assert {f.site for f in FaultPlan.seeded(seed).faults} == set(SITES)


def test_named_registry_and_validation():
    plan = FaultPlan.named("ci-chaos")
    assert _as_tuples(plan) == _as_tuples(ref_faults.FaultPlan.named("ci-chaos"))
    assert plan.name == "ci-chaos" and plan is not FaultPlan.named("ci-chaos")
    with pytest.raises(ValueError, match="unknown fault plan"):
        FaultPlan.named("no-such-plan")
    assert SITES == ref_faults.SITES
    with pytest.raises(ValueError, match="unknown fault site"):
        Fault("not.a.site")
    with pytest.raises(ValueError, match="unknown fault kind"):
        Fault("sampler", kind="explode")
    with pytest.raises(ValueError, match="at >= 0"):
        Fault("sampler", at=-1)


# .. the allocator ..

def test_allocator_fault_point_fires_at_reference_hits():
    seen = []
    for alloc_cls, mod in ((PageAllocator, faults), (RefAllocator, ref_faults)):
        al = alloc_cls(8)
        got = []
        with mod.FaultPlan([mod.Fault("allocator.alloc", at=1, times=2)]) as plan:
            for n in (2, 1, 3, 0, 1):
                try:
                    got.append(al.alloc(n))
                except mod.InjectedFault as e:
                    got.append((e.site, e.hit, e.ctx))
        seen.append((got, plan.hits, al.stats()))
    assert seen[0] == seen[1]
    assert seen[0][0][1] == ("allocator.alloc", 1, {"n": 1, "free": 6})


def test_allocator_snapshot_unwinds_partial_tick():
    al = PageAllocator(8)
    keep = al.alloc(3)
    al.share(keep[0])
    snap = al.snapshot()
    al.alloc(2)                                # the failed tick's work
    al.release(keep[1])
    al.restore(snap)
    assert al.stats() == {"total": 8, "free": 5, "shared": 1, "resident": 3}
    al.restore(snap)                           # copies: restore twice
    assert al.refcount(keep[0]) == 2


# .. the engine's snapshot / restore ..

@functools.lru_cache(maxsize=None)
def _port(kind="float"):
    cfg = reduced_config(get_config("qwen2.5-3b"))
    return port_serve.build(cfg, seed=0, device="cpu", kv_quant=kind == "int8kv")


def _requests(n=4, seed=11):
    cfg = reduced_config(get_config("qwen2.5-3b"))
    rng = np.random.default_rng(seed)
    prefix = rng.integers(1, cfg.vocab_size, 6).tolist()
    return [(prefix + rng.integers(1, cfg.vocab_size, int(rng.integers(2, 8))).tolist(), 6,
             (0.0, 0.9)[i % 2]) for i in range(n)]


def _pools(eng):
    return [t.clone() for c in eng.cache["layers"] for t in (c.k, c.v, c.k_s, c.v_s)
            if t is not None]


CASES = {"paged": dict(prefix_cache=False), "prefix": dict(), "dense": dict(cache_kind="dense"),
         "int8kv": dict(prefix_cache=False)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_engine_snapshot_restore_replays_bit_identically(case):
    model, params = _port("int8kv" if case == "int8kv" else "float")
    eng = ServeEngine(model, params, slots=2, max_len=64, seed=5, top_k=8, **CASES[case])
    for toks, mx, temp in _requests():
        eng.submit(toks, max_new_tokens=mx, temperature=temp)
    for _ in range(3):                         # a boundary mid-flight
        eng.step()
    snap = eng.snapshot()
    assert snap.nbytes >= eng.pool_bytes > 0
    pools = _pools(eng)
    ref = eng.run()
    ref_pools = _pools(eng)
    for _ in range(2):                         # one snapshot, two restores
        eng.restore(snap)
        eng.check_leaks()
        assert all(torch.equal(a, b) for a, b in zip(_pools(eng), pools))
        assert eng.run() == ref
        assert all(torch.equal(a, b) for a, b in zip(_pools(eng), ref_pools))
        eng.check_leaks()


def test_restore_without_generator_states_breaks_the_replay():
    """The planted fault "restore skips the generator states": the streams
    sampled at temperature 0.9 after the boundary then differ."""
    model, params = _port()
    eng = ServeEngine(model, params, slots=2, max_len=64, seed=5)
    for toks, mx, _ in _requests():
        eng.submit(toks, max_new_tokens=mx, temperature=0.9)
    eng.step()
    snap = eng.snapshot()
    ref = eng.run()
    eng.restore(snap)
    eng.step()                                 # advance the restored generators
    keys = eng._keys
    eng.restore(snap)
    eng._keys = keys                           # the fault: keep them advanced
    assert eng.run() != ref
