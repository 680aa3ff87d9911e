"""Sliding-window serving on the ring cache, the port against the
reference, at reduced starcoder2-15b (window 8, float32).

* ``RingCache`` placement: ``prompt_update`` against a sequential oracle
  (the reference's hypothesis property over W, S and pos0, multi-wrap
  included) and bit for bit against the reference's; ``token_view``'s
  mask equal to the reference's; ``verify_view`` (and a verify step)
  raises.
* Decode and chunked prefill logits against the reference's ring within
  the reference's own post-wrap bound (atol 1e-5,
  ``tests/test_chunked_prefill.py``), on the plain path and on the
  kernel path's code (the pre-write context gather, the ring decode
  through its CPU route); greedy streams equal.  The planted fault
  "context read after the chunk's write" breaks the kernel path.
* On the plain path, batched prefill ≡ sequential decode bit for bit,
  across the wrap (one shot, chunked, ragged, int8 KV).
* The ring decode (the paged kernel's ring form) on the CPU: its wrapper
  ≡ the plain version with the ring cache's mask; the wrapper hands W and
  the window to the C entry (meta tensors and a recorder) and refuses
  what the form does not take (``tests/test_torch_ring_decode.py`` has
  the rest).
* The engine on the ring against the reference engine
  (``tests/test_cache_backends.py``'s prompts), float and int8 KV;
  ``PipelinedScheduler`` at depths 0 and 1 ≡ the synchronous engine;
  retried ≡ fault-free; parking and speculative decoding raise.
"""

import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _hypothesis_compat import given, settings, st  # noqa: E402
from repro.configs import get_config, reduced_config  # noqa: E402
from repro.models import kv_cache as ref_kv  # noqa: E402
from repro.models.transformer import build_model as ref_build  # noqa: E402
from repro.runtime.serve_loop import ServeEngine as RefEngine  # noqa: E402
from repro.runtime.serve_loop import generate as ref_generate  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config as port_get_config  # noqa: E402
from repro_torch.configs import reduced_config as port_reduced  # noqa: E402
from repro_torch.kernels.flash_attention.ref import masked_attention_ref  # noqa: E402
from repro_torch.kernels.paged_attention import paged_attention as pa  # noqa: E402
from repro_torch.kernels.paged_attention.ref import ring_decode_split_ref  # noqa: E402
from repro_torch.models import attention, kv_cache  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402
from repro_torch.runtime.faults import Fault, FaultPlan  # noqa: E402
from repro_torch.runtime.scheduler import PipelinedScheduler  # noqa: E402
from repro_torch.runtime.serve_loop import ServeEngine, generate  # noqa: E402

ARCH = "starcoder2-15b"
POST_WRAP_ATOL = 1e-5   # tests/test_chunked_prefill.py: ring chunked vs sequential
ENGINE_PROMPTS = [[1, 2, 3], list(range(1, 14)), [9, 9], [4, 5, 6, 7]]   # test_cache_backends


@functools.lru_cache(maxsize=None)
def _setup(kv_quant=False):
    cfg = reduced_config(get_config(ARCH))
    ref = ref_build(cfg, kv_quant=kv_quant)
    params = ref.init(jax.random.PRNGKey(0))
    port_params = bridge.params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    model = Model(port_reduced(port_get_config(ARCH)), device="cpu", kv_quant=kv_quant)
    return cfg, ref, params, model, port_params


def _tokens(seed, b, s, lens=None):
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, 256, (b, s)).astype(np.int64)
    if lens is not None:
        toks = np.where(np.arange(s)[None, :] >= s - np.asarray(lens)[:, None], toks, 0)
    return toks


def _pad_mask(b, s, lens):
    return torch.from_numpy(np.arange(s)[None, :] >= s - np.asarray(lens)[:, None])


# .. placement and the mask ..

def _oracle(c, new, pos0, w):
    out = np.array(c)
    for t in range(new.shape[1]):
        out[:, (pos0 + t) % w] = new[:, t]
    return out


@settings(max_examples=40, deadline=None)
@given(w=st.integers(2, 9), s=st.integers(1, 20), pos0=st.integers(0, 25))
def test_ring_write_matches_sequential_oracle(w, s, pos0):
    new = np.random.default_rng(s * 31 + pos0).standard_normal((2, s, 1, 3)).astype(np.float32)
    c = torch.zeros((2, w, 1, 3))
    kv_cache.prompt_update(c, torch.from_numpy(new), pos0, ring=True)
    np.testing.assert_array_equal(c.numpy(), _oracle(np.zeros((2, w, 1, 3)), new, pos0, w))
    want = ref_kv.prompt_update(jnp.zeros((2, w, 1, 3)), jnp.asarray(new), pos0, ring=True)
    np.testing.assert_array_equal(c.numpy(), np.asarray(want))


@pytest.mark.parametrize("s,pos0", [(6, 5), (11, 3), (4, 2), (5, 2), (8, 2), (11, 2)])
def test_multi_wrap_keeps_last_window(s, pos0):
    """The reference's wrap cases (``TestPromptUpdateWrap``): a chunk that
    laps the ring keeps only its last W rows."""
    w = 4 if s != 6 else 8
    new = np.random.default_rng(s).standard_normal((2, s, 2, 4)).astype(np.float32)
    c = torch.zeros((2, w, 2, 4))
    kv_cache.prompt_update(c, torch.from_numpy(new), pos0, ring=True)
    np.testing.assert_array_equal(c.numpy(), _oracle(np.zeros((2, w, 2, 4)), new, pos0, w))


def test_write_tokens_equals_sequential_write_token():
    """A burst write of S <= W rows lands where S decode writes do."""
    rng = np.random.default_rng(6)
    k, v = (torch.from_numpy(rng.standard_normal((3, 5, 2, 4)).astype(np.float32))
            for _ in range(2))
    pos = torch.tensor([2, 6, 13], dtype=torch.int32)
    burst = kv_cache.ring_init(3, 8, 2, 4, torch.float32, window=8).write_tokens(k, v, pos)
    seq = kv_cache.ring_init(3, 8, 2, 4, torch.float32, window=8)
    for t in range(5):
        seq.write_token(k[:, t:t + 1], v[:, t:t + 1], pos + t, per_seq=True)
    assert torch.equal(burst.k, seq.k) and torch.equal(burst.v, seq.v)


def test_token_view_mask_equals_reference():
    rng = np.random.default_rng(4)
    for w, window in ((8, 8), (6, 8), (5, 3)):
        for _ in range(12):
            pos = rng.integers(0, 3 * w, 4).astype(np.int32)
            start = np.minimum(rng.integers(0, 2 * w, 4), pos).astype(np.int32)
            ref = ref_kv.RingCache(k=jnp.zeros((4, w, 1, 2)), v=jnp.zeros((4, w, 1, 2)),
                                   window=window)
            want = np.asarray(ref.token_view(jnp.asarray(pos), jnp.asarray(start))[-1])
            ring = kv_cache.ring_init(4, w, 1, 2, torch.float32, window=window)
            got = ring.token_view(torch.from_numpy(pos), torch.from_numpy(start))[-1]
            np.testing.assert_array_equal(got.numpy(), want)


def test_verify_view_and_verify_step_raise():
    cfg, _, _, model, params = _setup()
    ring = kv_cache.ring_init(2, 8, 2, 16, torch.float32, window=8)
    pos = torch.tensor([3, 9], dtype=torch.int32)
    with pytest.raises(ValueError, match="speculative verify"):
        ring.verify_view(pos, torch.zeros(2, dtype=torch.int32), 3)
    cache = model.init_cache(2, 32, kind="ring")
    cache["pos"] = pos
    with pytest.raises(ValueError, match="speculative verify"):
        model.verify_step(params, cache, torch.ones((2, 3), dtype=torch.long))


def test_cache_kinds_resolve_and_refuse_as_the_reference():
    cfg = port_reduced(port_get_config(ARCH))
    plain = port_reduced(port_get_config("qwen2.5-3b"))
    assert attention.resolve_cache_kind(cfg, "auto") == "ring"
    assert attention.resolve_cache_kind(plain, None) == "dense"
    assert attention.cache_len(cfg, 64) == 8 and attention.cache_len(cfg, 5) == 5
    ring = attention.init_cache(cfg, 2, 64, torch.float32)
    assert isinstance(ring, kv_cache.RingCache) and ring.width == 8 and ring.window == 8
    for c, kind in ((cfg, "paged"), (cfg, "dense"), (plain, "ring"), (plain, "bogus")):
        with pytest.raises(ValueError):
            attention.init_cache(c, 2, 64, torch.float32, kind=kind)


# .. the model on the ring against the reference ..

@functools.lru_cache(maxsize=None)
def _ref_steps(chunk):
    """The reference's ring: 21 prompt tokens over a ring of 8 (two wraps
    in the prefill), then 6 greedy decode steps; each step's logits."""
    cfg, ref, params, _, _ = _setup()
    cache = ref.init_cache(2, 40, kind="ring")
    logits, cache = ref.prefill(params, cache, tokens=jnp.asarray(_tokens(0, 2, 21)),
                                chunk=chunk)
    out = [np.asarray(logits)]
    for _ in range(6):
        logits, cache = ref.decode_step(params, cache, jnp.argmax(logits, -1))
        out.append(np.asarray(logits))
    return out


@pytest.mark.parametrize("kernel_path", [False, True], ids=["plain", "kernel-path"])
@pytest.mark.parametrize("chunk", [None, 3])
def test_prefill_and_decode_logits_equal_reference(monkeypatch, kernel_path, chunk):
    """Every step's logits of ``_ref_steps`` within the reference's
    post-wrap bound, and the same greedy tokens.  ``kernel-path`` runs the
    card's code path on CPU tensors (the wrappers' plain versions): the
    context gathered before the chunk's write, kernel 2 over it with the
    window, and the decode read through the ring decode's route."""
    _, _, _, model, port_params = _setup()
    if kernel_path:
        monkeypatch.setattr(attention, "plain_path", lambda x, use_kernel: not use_kernel)
    cache = model.init_cache(2, 40, kind="auto")
    pl, cache = model.prefill(port_params, cache, torch.from_numpy(_tokens(0, 2, 21)),
                              chunk=chunk)
    for want in _ref_steps(chunk):
        np.testing.assert_allclose(pl.numpy(), want, rtol=0, atol=POST_WRAP_ATOL)
        tok = pl.argmax(-1)
        assert np.array_equal(tok.numpy(), want.argmax(-1))
        pl, cache = model.decode_step(port_params, cache, tok)


def test_context_read_after_write_breaks_the_kernel_path(monkeypatch):
    """The planted fault "context read after the chunk's write" (chip_smoke.py's
    own): a wrapping chunk then attends rows it has just evicted."""
    cfg, ref, params, model, port_params = _setup()
    monkeypatch.setattr(attention, "plain_path", lambda x, use_kernel: not use_kernel)
    toks = torch.from_numpy(_tokens(1, 2, 13))
    good = model.prefill(port_params, model.init_cache(2, 32, kind="ring"), toks, chunk=5)[0]
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_faults", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    monkeypatch.setattr(attention, "prefill_step", cs.context_after_write(attention.prefill_step))
    bad = model.prefill(port_params, model.init_cache(2, 32, kind="ring"), toks, chunk=5)[0]
    assert float((good - bad).abs().max()) > 100 * POST_WRAP_ATOL


@pytest.mark.parametrize("kv_quant", [False, True], ids=["f32-kv", "int8-kv"])
@pytest.mark.parametrize("chunk,lens", [(None, None), (4, None), (None, [21, 13]),
                                        (6, [17, 21])])
def test_batched_prefill_equals_sequential_decode_bitwise(kv_quant, chunk, lens):
    """The port's plain path: prefill interleaves each row's write and read
    on the ring, so a wrapping prompt gives exactly sequential decode's
    logits and ring rows."""
    _, _, _, model, params = _setup(kv_quant)
    toks = torch.from_numpy(_tokens(2, 2, 21, lens))
    mask = None if lens is None else _pad_mask(2, 21, lens)
    got, cache = model.prefill(params, model.init_cache(2, 40, kind="ring"), toks,
                               pad_mask=mask, chunk=chunk)
    seq = model.init_cache(2, 40, kind="ring")
    if mask is not None:
        seq["start"] = (21 - mask.sum(1)).to(torch.int32)
    for t in range(21):
        want, seq = model.decode_step(params, seq, toks[:, t],
                                      token_mask=None if mask is None else mask[:, t])
    assert torch.equal(got, want)
    for a, b in zip(cache["layers"], seq["layers"]):
        for name in ("k", "v", "k_s", "v_s"):
            x, y = getattr(a, name), getattr(b, name)
            assert (x is None and y is None) or torch.equal(x, y)


@pytest.mark.parametrize("prefill", ["batched", "sequential"])
def test_greedy_streams_equal_reference_generate(prefill):
    cfg, ref, params, model, port_params = _setup()
    lens = [19, 11, 4]
    toks = _tokens(3, 3, 19, lens)
    want = np.asarray(ref_generate(ref, params, jnp.asarray(toks), 10, prompt_lens=lens,
                                   prefill=prefill))
    got = generate(model, port_params, toks, 10, prompt_lens=lens, prefill=prefill)
    np.testing.assert_array_equal(got.numpy(), want)


# .. the ring decode (the paged kernel's ring form) ..

def _ring_operands(seed, b, w, hq=4, hkv=2, d=16):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((b, hq, 1, d), generator=g)
    k = torch.randn((b, hkv, w, d), generator=g)
    v = torch.randn((b, hkv, w, d), generator=g)
    return q, k, v


def test_ring_form_plain_version_is_the_ring_mask():
    """The ring decode wrapper's CPU route ≡ ``masked_attention_ref`` with
    ``RingCache.token_view``'s mask over the ring's own views (the ring's
    CPU decode read), before and after the wrap and with starts on both
    sides of it; reading the ring unrotated (row j as position j, the
    kernel's planted fault 2, emulated) differs."""
    w = 8
    pos = torch.tensor([3, 7, 8, 13, 20, 29], dtype=torch.int32)
    start = torch.tensor([0, 2, 0, 9, 15, 0], dtype=torch.int32)
    q, k, v = _ring_operands(5, 6, w)
    ring = kv_cache.RingCache(k.transpose(1, 2), v.transpose(1, 2), window=w)
    valid = ring.token_view(pos, start)[-1]
    want = masked_attention_ref(q, ring.k.transpose(1, 2), ring.v.transpose(1, 2),
                                valid=valid[:, None, :])
    got = pa.ring_decode_kernel(q, ring.k, ring.v, pos, start, window=w)
    assert torch.equal(got, want)
    flat = ring_decode_split_ref(q, ring.k, ring.v, pos, start, window=w, rows_per_split=32,
                                 fault=2)
    assert not torch.allclose(flat[3:], want[3:])


class _Recorder:
    def __init__(self):
        self.calls = []

    def entry(self, name, fname=None):
        def fn(*args):
            self.calls.append((name, fname, args))
            return 0
        return fn


def test_wrapper_hands_the_ring_width_to_the_kernel(monkeypatch):
    """The ring decode at the starcoder2-15b tick (meta tensors, a
    recorder for the library): one launch of ``ring_decode_attention``
    with W, the window and the plan, and what the form does not take
    refused."""
    rec = _Recorder()
    meta = torch.device("meta")
    monkeypatch.setattr(pa._build, "entry", rec.entry)
    monkeypatch.setattr(pa._build, "stream_of", lambda t: 0)
    monkeypatch.setitem(pa._build._sms, meta, 132)
    monkeypatch.setattr(pa._build, "_workspaces", {})
    for name in ("launches", "int8_kv_launches"):
        monkeypatch.setattr(pa.ring_decode_kernel, name, 0)
    q = torch.empty((8, 48, 1, 128), dtype=torch.bfloat16, device=meta)
    kv = torch.empty((8, 4096, 4, 128), dtype=torch.bfloat16, device=meta)
    pos = torch.empty((8,), dtype=torch.int32, device=meta)
    pa.ring_decode_kernel(q, kv, kv, pos, pos, window=4096)
    (src, fname, args), = rec.calls
    assert (src, fname) == ("paged_attention", "ring_decode_attention")
    # the C entry's declared signature takes exactly these arguments
    assert len(args) == len(pa._build.ENTRY_POINTS[src][fname])
    # is_bf16, kv_int8, B, Hq, Hkv, W, D, rows a split, splits, window
    assert args[12:22] == (1, 0, 8, 48, 4, 4096, 128, 448, 10, 4096)
    assert pa.ring_decode_kernel.launches == 1 and pa.ring_decode_kernel.int8_kv_launches == 0
    q5 = torch.empty((8, 48, 5, 128), dtype=torch.bfloat16, device=meta)
    for bad_q, bad_kv in ((q5, kv),                                  # Sq != 1
                          (q, kv.transpose(1, 2)),                   # [B, Hkv, W, D]
                          (q, kv[:4])):                              # B != the pools'
        with pytest.raises(ValueError, match="ring decode"):
            pa.ring_decode_kernel(bad_q, bad_kv, bad_kv, pos, pos, window=4096)
    assert len(rec.calls) == 1


# .. the engine on the ring ..

def _engine_streams(engine, prompts, new=3, temperature=0.0):
    uids = [engine.submit(p, max_new_tokens=new, temperature=temperature) for p in prompts]
    out = engine.run()
    return [out[u] for u in uids]


@pytest.mark.parametrize("kv_quant", [False, True], ids=["f32-kv", "int8-kv"])
def test_engine_equals_reference_engine(kv_quant):
    """Prompts shorter and longer than the window on 2 slots (refills over
    rows the last request left), greedy streams equal to the reference's
    ring engine, which keeps the ring (``cache_kind`` "auto")."""
    cfg, ref, params, model, port_params = _setup(kv_quant)
    prompts = ENGINE_PROMPTS + [list(range(20, 41))]
    want = _engine_streams(RefEngine(ref, params, slots=2, max_len=64), prompts, new=6)
    eng = ServeEngine(model, port_params, slots=2, max_len=64)
    assert eng.cache_kind == "ring" and eng.prefix_stats is None
    assert _engine_streams(eng, prompts, new=6) == want
    eng.check_leaks()


def _sync_streams(reqs, **kw):
    _, _, _, model, params = _setup()
    eng = ServeEngine(model, params, slots=2, max_len=64, seed=5, **kw)
    for toks, temp in reqs:
        eng.submit(toks, max_new_tokens=6, temperature=temp)
    return eng.run()


def _requests(n, temps=(0.0, 0.9)):
    rng = np.random.default_rng(11)
    return [(rng.integers(1, 256, int(rng.integers(3, 20))).tolist(), temps[i % len(temps)])
            for i in range(n)]


@pytest.mark.parametrize("depth", [0, 1])
def test_pipelined_scheduler_equals_sync_engine(depth):
    reqs = _requests(5)
    want = _sync_streams(reqs)
    _, _, _, model, params = _setup()
    eng = ServeEngine(model, params, slots=2, max_len=64, seed=5)
    sched = PipelinedScheduler(eng, pipeline_depth=depth)
    uids = [sched.submit(t, max_new_tokens=6, temperature=temp) for t, temp in reqs]
    got = sched.run()
    assert [got[u] for u in uids] == [want[u] for u in range(len(reqs))]


def test_retried_equals_fault_free():
    reqs = _requests(5)
    want = _sync_streams(reqs)
    _, _, _, model, params = _setup()
    eng = ServeEngine(model, params, slots=2, max_len=64, seed=5)
    sched = PipelinedScheduler(eng, max_retries=3)
    uids = [sched.submit(t, max_new_tokens=6, temperature=temp) for t, temp in reqs]
    faults = [Fault("prefill.dispatch", at=1), Fault("decode.dispatch", at=2),
              Fault("decode.dispatch", at=6), Fault("sampler", at=3)]
    with FaultPlan(faults) as plan:
        got = sched.run()
    assert len(plan.fired) == len(faults)
    assert [got[u] for u in uids] == [want[u] for u in range(len(reqs))]


def test_parking_and_speculative_decoding_refuse_the_ring():
    _, _, _, model, params = _setup()
    eng = ServeEngine(model, params, slots=2, max_len=64)
    eng.submit([1, 2, 3], max_new_tokens=4)
    eng.step()
    with pytest.raises(ValueError, match="parking requires the paged backend"):
        eng.park_slot(next(iter(eng._active)))
    drafter = Model(port_reduced(port_get_config("qwen2.5-3b")), device="cpu")
    with pytest.raises(ValueError, match="ring"):
        ServeEngine(model, params, slots=2, max_len=64, draft_model=drafter,
                    draft_params=None)
