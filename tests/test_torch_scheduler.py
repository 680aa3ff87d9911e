"""The port's ``PipelinedScheduler`` (``runtime/scheduler.py``) on the CPU.

* Bit identity with the port's synchronous ``ServeEngine.run`` on the
  plain path: paged + prefix chunked admission and dense atomic
  admission at depths 0, 1 and 2, a tight pool (reservation slack), int8
  KV, and the speculative fallback, at temperatures 0 and 0.9.
* Greedy streams equal the reference scheduler's on reduced qwen2.5-3b
  (configurations the reference's own ``tests/test_scheduler.py``
  passes), with the same weights.  The reference runs in a fresh
  process: its chunked admission's streams have been seen to change with
  what ran before it in a test worker (its own ``test_scheduler.py``
  flips the same way), while a fresh process repeats them.
* Cancellation at every tick (queued, mid-prefill, decoding, with ticks
  in flight) leaks nothing and leaves the survivors' streams unchanged;
  shedding, priorities, deadlines (a fake clock), constructor checks,
  metrics wiring and status transitions.
"""

import functools
import json
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

import _torch_ref_proc as ref_proc  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import reduced_config as ref_reduced  # noqa: E402
from repro.models.transformer import build_model as ref_build  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.launch import serve as port_serve  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402
from repro_torch.runtime.metrics import ServingMetrics  # noqa: E402
from repro_torch.runtime.scheduler import (ACTIVE, CANCELLED, DONE, PREFILL,  # noqa: E402
                                           QUEUED, SHED, PipelinedScheduler)
from repro_torch.runtime.serve_loop import ServeEngine  # noqa: E402

CFG = reduced_config(get_config("qwen2.5-3b"))


@functools.lru_cache(maxsize=None)
def _port(kind="float"):
    return port_serve.build(CFG, seed=0, device="cpu", kv_quant=kind == "int8kv")


def _requests(n, *, prefix_len=6, seed=11, temps=(0.0, 0.9), max_new=6):
    """A seeded ragged request set behind one common prefix."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(1, CFG.vocab_size, prefix_len).tolist()
    return [(prefix + rng.integers(1, CFG.vocab_size, int(rng.integers(2, 8))).tolist(),
             max_new, temps[i % len(temps)]) for i in range(n)]


def _sync(model, params, reqs, **kw):
    eng = ServeEngine(model, params, **kw)
    for toks, mx, temp in reqs:
        eng.submit(toks, max_new_tokens=mx, temperature=temp)
    return eng.run()


def _scheduled(model, params, reqs, sched_kw, **kw):
    eng = ServeEngine(model, params, **kw)
    sched = PipelinedScheduler(eng, **sched_kw)
    for toks, mx, temp in reqs:
        assert sched.submit(toks, max_new_tokens=mx, temperature=temp) is not None
    got = sched.run()
    assert all(sched.status(u) == DONE for u in got)
    return got, sched


CASES = {   # engine kwargs, request kwargs
    "paged-prefix": (dict(slots=2, max_len=64, seed=5, top_k=8), dict(n=6)),
    "paged-no-prefix": (dict(slots=2, max_len=64, seed=5, prefix_cache=False), dict(n=5)),
    "dense": (dict(slots=2, max_len=48, seed=5, cache_kind="dense"), dict(n=4)),
    "tight-pool": (dict(slots=2, max_len=48, seed=5, page_size=4, pages=9),
                   dict(n=5, prefix_len=4)),
    "int8kv-prefix": (dict(slots=3, max_len=64, seed=5), dict(n=5)),
}


@pytest.mark.parametrize("depth", [0, 1, 2])
@pytest.mark.parametrize("case", sorted(CASES))
def test_scheduler_equals_sync_engine(case, depth):
    kw, rkw = CASES[case]
    model, params = _port("int8kv" if case.startswith("int8kv") else "float")
    reqs = _requests(**rkw)
    ref = _sync(model, params, reqs, **kw)
    got, sched = _scheduled(model, params, reqs,
                            dict(pipeline_depth=depth, prefill_chunk=4), **kw)
    assert got == ref
    assert sched.depth == depth and sched.engine._reserve_slack == depth
    assert sched._chunked == (kw.get("cache_kind") != "dense"
                              and kw.get("prefix_cache", True))


@pytest.mark.parametrize("temp", [0.0, 0.9])
def test_spec_fallback_equals_sync(temp):
    """A speculative engine ticks through ``engine.step()`` (depth forced to
    0) and its streams equal the synchronous spec engine's."""
    model, params = _port()
    kw = dict(slots=2, max_len=64, seed=5, draft_model=model, draft_params=params, spec_k=2)
    reqs = _requests(4, temps=(temp,))
    ref = _sync(model, params, reqs, **kw)
    got, sched = _scheduled(model, params, reqs, dict(pipeline_depth=3), **kw)
    assert sched.depth == 0
    assert got == ref
    assert sched.engine.spec_stats["ticks"] > 0
    if temp == 0.0:   # greedy drafts of a weight-shared drafter: accepted
        assert sched.engine.spec_stats["accepted"] > 0


# .. against the reference scheduler ..

REF_CASES = {
    "paged-prefix-depth2": (dict(slots=2, max_len=64, seed=5),
                            dict(pipeline_depth=2, prefill_chunk=4)),
    "paged-prefix-depth0": (dict(slots=2, max_len=64, seed=5),
                            dict(pipeline_depth=0, prefill_chunk=4)),
    "dense-depth1": (dict(slots=2, max_len=48, seed=5, cache_kind="dense"),
                     dict(pipeline_depth=1)),
}

_REF_SCRIPT = textwrap.dedent("""
    import json, sys
    import jax
    from repro.configs import get_config, reduced_config
    from repro.models.transformer import build_model
    from repro.runtime.scheduler import PipelinedScheduler
    from repro.runtime.serve_loop import ServeEngine
    cases, reqs = json.loads(sys.stdin.read())
    cfg = reduced_config(get_config("qwen2.5-3b"))
    params = build_model(cfg).init(jax.random.PRNGKey(0))
    out = {}
    for name, (engine_kw, sched_kw) in cases.items():
        sched = PipelinedScheduler(ServeEngine(build_model(cfg), params, **engine_kw),
                                   **sched_kw)
        for toks, mx, temp in reqs:
            sched.submit(toks, max_new_tokens=mx, temperature=temp)
        out[name] = {str(u): v for u, v in sched.run().items()}
    print("RESULT " + json.dumps(out))
""")


@functools.lru_cache(maxsize=None)
def _ref_scheduler_streams():
    """The reference scheduler's greedy streams for every REF_CASES entry,
    computed in a fresh process."""
    return ref_proc.run(_REF_SCRIPT, stdin=json.dumps([REF_CASES, _requests(4, temps=(0.0,))]))


@pytest.mark.parametrize("case", sorted(REF_CASES))
def test_greedy_streams_equal_reference_scheduler(case):
    engine_kw, sched_kw = REF_CASES[case]
    want = {int(u): v for u, v in _ref_scheduler_streams()[case].items()}
    cfg = ref_reduced(ref_get_config("qwen2.5-3b"))
    params = ref_build(cfg).init(jax.random.PRNGKey(0))
    model = Model(CFG, device="cpu")
    port_params = bridge.params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    got, _ = _scheduled(model, port_params, _requests(4, temps=(0.0,)), sched_kw, **engine_kw)
    diff = ref_proc.first_difference(got, want, f"{case}: ")
    assert diff is None, diff
    assert len(got) == 4 and all(len(v) == 6 for v in got.values())


# .. cancellation ..

def test_cancel_at_every_tick_leaks_clean():
    """For each tick t, a fresh run cancels one request at t (wherever it
    then is: queued, mid-prefill, decoding with ticks in flight); the leak
    check holds at every tick and every other stream equals the
    synchronous engine's."""
    model, params = _port()
    kw = dict(slots=2, max_len=64, seed=5)
    reqs = _requests(5)
    ref = _sync(model, params, reqs, **kw)
    stages = set()
    for at in range(0, 24, 2):
        eng = ServeEngine(model, params, **kw)
        sched = PipelinedScheduler(eng, pipeline_depth=2, prefill_chunk=4)
        uids = [sched.submit(t, max_new_tokens=m, temperature=tp) for t, m, tp in reqs]
        victim = uids[at % len(uids)]
        tick = 0
        while sched.tick():
            if tick == at:
                stages.add(sched.status(victim))
                sched.cancel(victim)
            eng.check_leaks()
            tick += 1
        sched.flush()
        eng.check_leaks()
        got = sched.results
        for uid in uids:
            if sched.status(uid) == DONE:
                assert got[uid] == ref[uid]
            else:
                assert (uid, sched.status(uid)) == (victim, CANCELLED) and uid not in got
        assert sched.metrics.cancelled_total == sum(sched.status(u) == CANCELLED
                                                    for u in uids)
    assert {QUEUED, PREFILL, ACTIVE} <= stages


def test_cancel_mid_prefill_releases_slot():
    model, params = _port()
    rng = np.random.default_rng(3)
    eng = ServeEngine(model, params, slots=1, max_len=64, seed=5)
    sched = PipelinedScheduler(eng, prefill_chunk=4)
    long_prompt = rng.integers(1, CFG.vocab_size, 20).tolist()
    uid = sched.submit(long_prompt, max_new_tokens=4)
    sched.tick()
    assert sched.status(uid) == PREFILL
    assert sched.cancel(uid) and not sched.cancel(uid)
    sched.flush()
    eng.check_leaks()
    assert len(eng._free) == 1
    uid2 = sched.submit(long_prompt[:6], max_new_tokens=3)
    assert len(sched.run()[uid2]) == 3


def test_cancel_queued_and_unknown():
    model, params = _port()
    eng = ServeEngine(model, params, slots=1, max_len=32, seed=5)
    sched = PipelinedScheduler(eng, prefill_chunk=4)
    a = sched.submit([1, 2, 3], max_new_tokens=2)
    b = sched.submit([1, 2, 3], max_new_tokens=2)
    assert sched.cancel(b) and not sched.cancel(9999)
    res = sched.run()
    assert a in res and b not in res and sched.status(b) == CANCELLED


# .. admission control ..

def test_queue_full_sheds_with_none():
    model, params = _port()
    eng = ServeEngine(model, params, slots=1, max_len=32, seed=5)
    sched = PipelinedScheduler(eng, max_queue=1, prefill_chunk=4)
    assert sched.submit([1, 2], max_new_tokens=2) is not None
    assert sched.submit([3, 4], max_new_tokens=2) is None
    assert sched.metrics.shed_counts == {"queue_full": 1}
    sched.run()


def test_priority_orders_admission():
    model, params = _port()
    eng = ServeEngine(model, params, slots=1, max_len=48, seed=5)
    sched = PipelinedScheduler(eng, prefill_chunk=4)
    order = []

    def watcher(name):
        def cb(tok, done):
            if name not in order:
                order.append(name)
        return cb
    uids = [sched.submit([5, 6, 7, 8], max_new_tokens=3, priority=p, on_token=watcher(n))
            for n, p in (("a", 1), ("b", 5), ("c", 0))]
    sched.run()
    assert order == ["c", "a", "b"]
    assert {sched.status(u) for u in uids} == {DONE}


def test_deadline_sheds_stale_queued_request():
    model, params = _port()
    t = [0.0]
    eng = ServeEngine(model, params, slots=1, max_len=48, seed=5)
    sched = PipelinedScheduler(eng, prefill_chunk=4, clock=lambda: t[0])
    a = sched.submit([1, 2, 3, 4], max_new_tokens=8)
    b = sched.submit([5, 6, 7, 8], max_new_tokens=2, deadline=0.5)
    c = sched.submit([9, 10, 11], max_new_tokens=2, deadline=100.0)
    sched.tick()
    t[0] = 1.0                                 # b's deadline passes while a runs
    res = sched.run()
    assert sched.status(a) == DONE and len(res[a]) == 8
    assert sched.status(b) == SHED and b not in res
    assert sched.status(c) == DONE
    assert sched.metrics.shed_counts == {"deadline": 1}


def test_constructor_validation():
    model, params = _port()
    eng = ServeEngine(model, params, slots=1, max_len=32, seed=5)
    for kw, msg in ((dict(pipeline_depth=-1), "pipeline_depth"), (dict(max_queue=0), "max_queue"),
                    (dict(max_retries=-1), "max_retries"),
                    (dict(watchdog_timeout=0.0), "watchdog_timeout")):
        with pytest.raises(ValueError, match=msg):
            PipelinedScheduler(eng, **kw)
    eng.submit([1, 2], max_new_tokens=1)
    with pytest.raises(ValueError, match="idle"):
        PipelinedScheduler(eng)


# .. metrics and status ..

def test_lifecycle_metrics():
    model, params = _port()
    eng = ServeEngine(model, params, slots=2, max_len=64, seed=5)
    metrics = ServingMetrics()
    sched = PipelinedScheduler(eng, pipeline_depth=1, prefill_chunk=4, metrics=metrics)
    for toks, mx, temp in _requests(4, temps=(0.0,)):
        sched.submit(toks, max_new_tokens=mx, temperature=temp)
    res = sched.run()
    total = sum(len(v) for v in res.values())
    snap = sched.stats()
    assert snap["requests"]["submitted"] == snap["requests"]["finished"] == 4
    assert snap["requests"]["in_flight"] == 0
    assert snap["tokens"]["emitted"] == total
    assert snap["ttft"]["count"] == 4 and snap["inter_token"]["count"] == total - 4
    assert snap["ttft"]["p99_us"] >= snap["ttft"]["p50_us"]
    assert "pages" in snap and "prefix_cache" in snap
    assert snap["state"] == "ready" and snap["capacity"] == 2 and snap["parked"] == 0


def test_status_transitions():
    model, params = _port()
    eng = ServeEngine(model, params, slots=1, max_len=48, seed=5)
    sched = PipelinedScheduler(eng, prefill_chunk=4)
    uid = sched.submit(list(range(1, 11)), max_new_tokens=2)
    assert sched.status(uid) == QUEUED and sched.busy
    sched.tick()
    assert sched.status(uid) in (PREFILL, ACTIVE)
    sched.run()
    assert sched.status(uid) == DONE and not sched.busy
    assert sched.status(12345) is None
