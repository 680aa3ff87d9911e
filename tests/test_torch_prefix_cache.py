"""Prefix sharing in the port (``runtime/prefix_cache.py`` and the
prefix-cache route of ``ServeEngine``), on the CPU.

* ``PrefixCache`` against the reference's on the same seeded operation
  sequences: every ``match`` / ``insert`` / ``evict`` result, the
  counters, the allocator's refcounts, and a ``snapshot`` / ``restore``
  round trip.
* On the port's plain path (CPU tensors), bit for bit (``torch.equal``):
  shared ≡ unshared greedy streams and logits (admission and every
  decode tick), with float KV, int8 KV and EN-T records; the full-match
  peek ≡ unshared; the peek writes no pool tensor; copy-on-write leaves
  the other holders' pages unchanged.
* Accounting: a warm admission allocates only its suffix's pages, a full
  match none; ``check_leaks`` holds at every tick; eviction frees idle
  cached pages under pool pressure.
* The port's prefix-on greedy streams equal the reference's
  ``ServeEngine(prefix_cache=True)`` on the reduced configs of
  ``tests/test_torch_serve.py`` (held against the reference's own
  one-shot paths; its interleaving property is not a target).
* SSM models refuse ``prefix_cache=True``.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.configs import QuantConfig, get_config, reduced_config  # noqa: E402
from repro.models.transformer import build_model as ref_build  # noqa: E402
from repro.quant.quantize import quantize_params as ref_quantize  # noqa: E402
from repro.runtime.page_allocator import PageAllocator as RefAllocator  # noqa: E402
from repro.runtime.prefix_cache import PrefixCache as RefPrefixCache  # noqa: E402
from repro.runtime.serve_loop import ServeEngine as RefEngine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config as port_get_config  # noqa: E402
from repro_torch.configs import reduced_config as port_reduced  # noqa: E402
from repro_torch.configs.base import QuantConfig as PortQuant  # noqa: E402
from repro_torch.launch import serve as port_serve  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402
from repro_torch.runtime import serve_loop  # noqa: E402
from repro_torch.runtime.page_allocator import PageAllocator  # noqa: E402
from repro_torch.runtime.prefix_cache import PrefixCache  # noqa: E402
from repro_torch.runtime.serve_loop import ServeEngine  # noqa: E402

SYS = list(range(1, 9))          # 8 tokens = 2 full pages at page_size 4
PAGE = 4


# .. the radix cache against the reference's ..

def _ops(seed, n=60):
    """A seeded sequence of cache operations over prompts that share
    prefixes of 0..3 pages: ("insert", tokens), ("match", tokens),
    ("release", i) of the i-th live slot hold, ("evict", n)."""
    rng = np.random.default_rng(seed)
    stems = [rng.integers(1, 50, 3 * PAGE).tolist() for _ in range(3)]
    ops = []
    for _ in range(n):
        kind = rng.choice(["insert", "match", "release", "evict"], p=[0.4, 0.3, 0.15, 0.15])
        stem = stems[rng.integers(len(stems))]
        toks = stem[:PAGE * int(rng.integers(0, 4))] + rng.integers(1, 50, int(
            rng.integers(0, 2 * PAGE))).tolist()
        ops.append((str(kind), toks if kind in ("insert", "match") else int(rng.integers(0, 8))))
    return ops


def _drive(alloc_cls, cache_cls, ops):
    """Run ``ops`` as an engine would (an insert's pages are fresh
    allocations the inserting slot holds; a match shares its pages for a
    slot); returns every result and the final state."""
    alloc = alloc_cls(40)
    cache = cache_cls(PAGE, alloc)
    holds, out = [], []
    for kind, arg in ops:
        if kind == "insert":
            matched, spids = cache.match(arg)
            for pid in spids:
                alloc.share(pid)
            need = len(arg) // PAGE - len(spids)
            if need > alloc.free:
                cache.evict(need - alloc.free)
            fresh = alloc.alloc(min(need, alloc.free))
            if len(fresh) < need:   # the pool is pinned full: give it all back
                for pid in spids + fresh:
                    alloc.release(pid)
                out.append(("stall", matched))
                continue
            holds.append(spids + fresh)
            out.append(("insert", matched, spids, cache.insert(arg, spids + fresh)))
        elif kind == "match":
            out.append(("match",) + tuple(cache.match(arg)))
        elif kind == "release":
            if holds:
                for pid in holds.pop(arg % len(holds)):
                    alloc.release(pid)
            out.append(("release", len(holds)))
        else:
            out.append(("evict", cache.evict(arg)))
        out.append(("state", cache.resident, cache.evictable, sorted(cache.pages())))
    return out, cache, alloc


@pytest.mark.parametrize("seed", range(4))
def test_prefix_cache_equals_reference(seed):
    ops = _ops(seed)
    want, ref_cache, ref_alloc = _drive(RefAllocator, RefPrefixCache, ops)
    got, cache, alloc = _drive(PageAllocator, PrefixCache, ops)
    assert got == want
    assert cache.stats() == ref_cache.stats()
    assert alloc.snapshot() == ref_alloc.snapshot()
    assert any(o[0] == "evict" and o[1] for o in got)   # the sequence did evict


def test_snapshot_restore_round_trip():
    """A snapshot restores the trie, the counters and (with the allocator's
    own snapshot) the pins exactly, any number of times, in the port as
    in the reference."""
    ops = _ops(7)
    states = []
    for alloc_cls, cache_cls in ((RefAllocator, RefPrefixCache), (PageAllocator, PrefixCache)):
        _, cache, alloc = _drive(alloc_cls, cache_cls, ops[:30])
        snap, asnap = cache.snapshot(), alloc.snapshot()
        before = (cache.stats(), sorted(cache.pages()), alloc.snapshot())
        cache.evict(40)
        for toks in (t for k, t in ops[30:] if k == "insert"):
            fresh = alloc.alloc(min(len(toks) // PAGE, alloc.free))
            cache.insert(toks[:len(fresh) * PAGE], fresh)
        assert (cache.stats(), sorted(cache.pages())) != before[:2]
        for _ in range(2):
            cache.restore(snap)
            alloc.restore(asnap)
            assert (cache.stats(), sorted(cache.pages()), alloc.snapshot()) == before
            states.append(([cache.match(t) for k, t in ops if k == "match"], cache.stats()))
    assert states[0] == states[1] == states[2] == states[3]


# .. the engine on the plain path ..

@functools.lru_cache(maxsize=None)
def _port(kind):
    """Reduced qwen2.5-3b on the CPU: float weights ("float"), float
    weights and int8 KV ("int8kv"), EN-T records ("ent")."""
    cfg = port_reduced(port_get_config("qwen2.5-3b"))
    quant = PortQuant(enabled=True) if kind == "ent" else None
    return port_serve.build(cfg, seed=0, device="cpu", quant=quant, kv_quant=kind == "int8kv")


def _serve(model, params, prompts, *, prefix, slots=2, max_len=32, pages=None, max_new=4,
           interleave=None, record=None):
    """Serve ``prompts`` greedily with ``check_leaks`` at every tick;
    ``record`` (a dict) collects, per uid, the logits the engine sampled
    from at admission and at every decode tick."""
    eng = ServeEngine(model, params, slots=slots, max_len=max_len, page_size=PAGE,
                      pages=pages, prefix_cache=prefix)
    ticks = []
    greedy = serve_loop.sampling.greedy
    if record is not None:
        sampler = eng._sampler

        def admission(logits, keys, temps):
            record.setdefault(eng._queue[0].uid, []).append(logits[0].clone())
            return sampler(logits, keys, temps)
        eng._sampler = admission

    def tick(logits):
        ticks.append(logits.clone())
        return greedy(logits)
    serve_loop.sampling.greedy = tick
    try:
        for i, p in enumerate(prompts):
            eng.submit(p, max_new_tokens=max_new)
            for _ in range(interleave[i] if interleave else 0):
                eng.step()
                eng.check_leaks()
        while True:
            eng._admit()
            active = {slot: st.req.uid for slot, st in eng._active.items()}
            n = len(ticks)
            more = eng.step()
            eng.check_leaks()
            if record is not None and len(ticks) > n:
                for slot, uid in active.items():
                    record.setdefault(uid, []).append(ticks[-1][slot])
            if not more:
                break
    finally:
        serve_loop.sampling.greedy = greedy
    return [eng._results[u] for u in sorted(eng._results)], eng


def _same_logits(a, b):
    assert a.keys() == b.keys()
    for uid in a:
        assert len(a[uid]) == len(b[uid])
        for x, y in zip(a[uid], b[uid]):
            assert torch.equal(x, y), uid


@pytest.mark.parametrize("kind", ["float", "int8kv", "ent"])
def test_shared_equals_unshared(kind):
    """Shared-prefix serving ≡ unshared serving: the same greedy streams
    and bit-identical logits at every admission and tick."""
    model, params = _port(kind)
    prompts = [SYS + [20 + i, 30 + i] for i in range(3)] + [SYS + [40, 41, 42, 43, 44]]
    rec_on, rec_off = {}, {}
    on, eng = _serve(model, params, prompts, prefix=True, record=rec_on)
    off, _ = _serve(model, params, prompts, prefix=False, record=rec_off)
    assert on == off and all(len(s) == 4 for s in on)
    _same_logits(rec_on, rec_off)
    stats = eng.prefix_stats
    assert stats["hits"] >= 3 and stats["hit_tokens"] >= 3 * len(SYS)


@pytest.mark.parametrize("kind", ["float", "int8kv"])
def test_full_match_peek_equals_unshared(kind):
    """Fully cached prompts admit with a read-only peek of the last
    token: the streams and logits equal unshared serving, and nothing is
    ever copied."""
    model, params = _port(kind)
    prompts = [SYS, SYS, SYS + SYS[:4], SYS]
    rec_on, rec_off = {}, {}
    on, eng = _serve(model, params, prompts, prefix=True, record=rec_on)
    off, _ = _serve(model, params, prompts, prefix=False, record=rec_off)
    assert on == off
    _same_logits(rec_on, rec_off)
    assert eng.prefix_stats["cow_copies"] == 0 and eng.prefix_stats["hits"] == 3


def _pools(eng):
    return [t.clone() for c in eng.cache["layers"]
            for t in (c.k, c.v, c.k_s, c.v_s) if t is not None]


@pytest.mark.parametrize("kind", ["float", "int8kv"])
def test_peek_writes_no_pool(kind):
    """The full-match admission is the peek alone: every pool tensor of
    every layer is unchanged by it (and by a direct ``Model.apply(peek=True)``
    on the same view), and it takes no page."""
    model, params = _port(kind)
    eng = ServeEngine(model, params, slots=2, max_len=32, page_size=PAGE, prefix_cache=True)
    eng.submit(SYS, max_new_tokens=2)
    eng.run()
    eng.submit(SYS, max_new_tokens=2)
    before, free = _pools(eng), eng.page_stats["free"]
    eng._admit()
    (slot,) = eng._active
    assert eng._slot_pages[slot] == [] and eng.page_stats["free"] == free
    layers = [c.prefill_view(slot) for c in eng.cache["layers"]]
    out = model.apply(params, torch.tensor([[SYS[-1]]]), cache={"layers": layers, "pos": 7},
                      write_cache=True, peek=True, last_only=True, pos0=7)
    assert out["cache"]["pos"] == 7
    for a, b in zip(before, _pools(eng)):
        assert torch.equal(a, b)
    eng.run()
    eng.check_leaks()


def test_copy_on_write_keeps_other_holders_pages():
    """A slot that writes into pages it shares gets copies first: the
    cached pages (and every other holder's view of them) keep their
    bytes, the copies start equal to them, and later admissions that
    match the prefix still serve as unshared ones do."""
    model, params = _port("int8kv")
    eng = ServeEngine(model, params, slots=2, max_len=32, page_size=PAGE, prefix_cache=True)
    eng.submit(SYS + [50], max_new_tokens=2)
    eng.run()
    eng.submit(SYS + [60], max_new_tokens=6)
    eng._admit()
    (slot,) = eng._active
    shared = list(eng._slot_shared[slot])
    assert len(shared) == 2 and all(eng._alloc.refcount(p) == 2 for p in shared)
    pools = eng.cache["layers"]
    before = {pid: [t[pid].clone() for c in pools for t in (c.k, c.v, c.k_s, c.v_s)]
              for pid in shared}
    assert eng._cow(slot, 0, 2 * PAGE - 1)
    eng._push_table()
    copies = [int(p) for p in eng._table[slot, :2]]
    assert set(copies).isdisjoint(shared) and eng._slot_shared[slot] == []
    assert eng.prefix_stats["cow_copies"] == 2
    for pid, new in zip(shared, copies):
        assert eng._alloc.refcount(pid) == 1 and eng._alloc.refcount(new) == 1
        now = [t[new] for c in pools for t in (c.k, c.v, c.k_s, c.v_s)]
        assert all(torch.equal(a, b) for a, b in zip(before[pid], now))
    eng.check_leaks()
    # the slot now writes over its first two pages: only its copies change
    g = torch.Generator().manual_seed(0)
    for c in pools:
        k = torch.randn((1, 2 * PAGE) + tuple(c.k.shape[2:]), generator=g)
        c.prefill_view(slot).write_prompt(k, -k, 0)
    for pid, new in zip(shared, copies):
        assert all(torch.equal(a, t[pid]) for a, t in zip(
            before[pid], [t for c in pools for t in (c.k, c.v, c.k_s, c.v_s)]))
        assert not torch.equal(pools[0].k[new], before[pid][0])
    eng.run()
    eng.check_leaks()
    # the cache's pages still hold the prefix: a newcomer matches and
    # serves what unshared serving gives
    eng.submit(SYS + [70], max_new_tokens=3)
    got = eng.run()
    off, _ = _serve(model, params, [SYS + [50], SYS + [60], SYS + [70]], prefix=False,
                    max_new=3)
    assert got[max(got)] == off[2]


class TestAccounting:
    def test_warm_admission_allocates_only_suffix_pages(self):
        model, params = _port("float")
        eng = ServeEngine(model, params, slots=2, max_len=32, page_size=PAGE,
                          prefix_cache=True)
        eng.submit(SYS + [40], max_new_tokens=2)
        eng.run()                                          # SYS's 2 pages cached
        eng.submit(SYS + [50, 51, 52], max_new_tokens=2)   # a 3-token suffix
        eng._admit()
        (slot,) = eng._active
        assert len(eng._slot_shared[slot]) == 2            # SYS reused
        assert len(eng._slot_pages[slot]) == 1             # ceil(3 / 4)
        eng.check_leaks()
        eng.run()

    def test_full_match_admits_with_zero_fresh_pages(self):
        model, params = _port("float")
        eng = ServeEngine(model, params, slots=2, max_len=32, page_size=PAGE,
                          prefix_cache=True)
        eng.submit(SYS, max_new_tokens=2)
        eng.run()
        free = eng.page_stats["free"]
        eng.submit(SYS, max_new_tokens=2)
        eng._admit()
        (slot,) = eng._active
        assert eng._slot_pages[slot] == [] and len(eng._slot_shared[slot]) == 2
        assert eng.page_stats["free"] == free and eng.page_stats["cached"] == 2
        eng.check_leaks()
        eng.run()

    def test_leak_check_at_every_tick(self):
        model, params = _port("float")
        prompts = [SYS + [20 + i] for i in range(4)] + [SYS[:4] + [9, 9]]
        on, _ = _serve(model, params, prompts, prefix=True, interleave=[1, 2, 0, 1, 0])
        off, _ = _serve(model, params, prompts, prefix=False, interleave=[1, 2, 0, 1, 0])
        assert on == off

    def test_admission_stalls_when_matched_pages_become_pinned(self):
        model, params = _port("float")
        eng = ServeEngine(model, params, slots=2, max_len=16, page_size=PAGE, pages=5,
                          prefix_cache=True)
        warm = list(range(1, 13))                 # 3 full pages
        eng.submit(warm, max_new_tokens=2)
        eng.run()                                 # 3 cached pages, 2 free
        eng.submit(list(range(90, 99)), max_new_tokens=2)
        eng.submit(warm, max_new_tokens=2)        # waits its turn, never crashes
        assert len(eng.run()) == 3
        eng.check_leaks()

    def test_eviction_under_pool_pressure(self):
        model, params = _port("float")
        eng = ServeEngine(model, params, slots=1, max_len=16, page_size=PAGE, pages=6,
                          prefix_cache=True)
        for i in range(4):                        # 4 distinct 8-token prompts
            eng.submit([50 * i + j for j in range(1, 9)], max_new_tokens=2)
        assert len(eng.run()) == 4
        assert eng.prefix_stats["evicted"] > 0
        stats = eng.page_stats
        assert stats["free"] + stats["resident"] == stats["total"]
        eng.check_leaks()


def test_ssm_models_refuse_prefix_sharing():
    cfg = port_reduced(port_get_config("mamba2-370m"))
    model = Model(cfg, device="cpu")
    with pytest.raises(ValueError, match="SSM"):
        ServeEngine(model, {}, slots=2, max_len=32, prefix_cache=True)
    # "auto" resolves to off, and the engine serves
    eng = ServeEngine(model, model.init(torch.Generator().manual_seed(0)), slots=2,
                      max_len=32)
    assert eng.prefix_stats is None and eng.cache_kind == "paged"
    eng.submit([3, 1, 4, 1, 5], max_new_tokens=3)
    assert len(eng.run()[0]) == 3
    dense = Model(port_reduced(port_get_config("qwen2.5-3b")), device="cpu")
    with pytest.raises(ValueError, match="paged backend"):
        ServeEngine(dense, {}, slots=2, max_len=32, cache_kind="dense", prefix_cache=True)


# .. against the reference engine with prefix sharing on ..

STREAM_ARCHS = [("qwen2.5-3b", False), ("qwen2.5-3b", True), ("qwen2-72b", False),
                ("minicpm-2b", False), ("llava-next-34b", False)]


@functools.lru_cache(maxsize=None)
def _ref_setup(arch):
    cfg = reduced_config(get_config(arch))
    params = ref_build(cfg).init(jax.random.PRNGKey(1))
    rng = np.random.default_rng(7)
    stem = rng.integers(1, cfg.vocab_size, 8).tolist()
    prompts = [stem + rng.integers(1, cfg.vocab_size, int(n)).tolist() for n in (3, 1, 6)]
    prompts += [stem, prompts[0], stem[:4] + [5, 6]]
    return cfg, params, prompts


@pytest.mark.parametrize("arch,quantized", STREAM_ARCHS,
                         ids=[f"{a}-{q}" for a, q in STREAM_ARCHS])
def test_prefix_streams_equal_reference(arch, quantized):
    """The port's prefix-on greedy streams equal the reference engine's
    with ``prefix_cache=True`` token for token (cold and warm suffix
    prefills, the peek of a full match, a repeated prompt, a one-page
    match), and the pool ends in the same state."""
    cfg, params, prompts = _ref_setup(arch)
    if quantized:
        params = ref_quantize(params, QuantConfig(enabled=True))
    ref = RefEngine(ref_build(cfg), params, slots=2, max_len=32, page_size=PAGE,
                    prefix_cache=True)
    for p in prompts:
        ref.submit(p, max_new_tokens=4)
    want = ref.run()
    model = Model(port_reduced(port_get_config(arch)), device="cpu")
    eng = ServeEngine(model, bridge.params_from_numpy(jax.tree.map(np.asarray, params), "cpu"),
                      slots=2, max_len=32, page_size=PAGE, prefix_cache=True)
    for p in prompts:
        eng.submit(p, max_new_tokens=4)
    got = eng.run()
    assert got == want
    assert eng.prefix_stats["hits"] == ref.prefix_stats["hits"] >= 3
    assert eng.page_stats == ref.page_stats
