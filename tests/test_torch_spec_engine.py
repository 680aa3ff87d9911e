"""Speculative decoding in the port, on its own plain path (CPU tensors),
bit for bit (``torch.equal``), mirroring ``tests/test_spec_decode.py``
but for its SSM cases (SSM serving is not ported):

* ``Model.verify_step`` over a K+1 burst ≡ K+1 ``decode_step`` calls,
  logits and every cache tensor, on dense rows, paged pools and paged
  int8 KV;
* the spec engine's streams ≡ the plain engine's: a divergent drafter, a
  weight-shared drafter (acceptance 1.0, more than 2 tokens a tick),
  temperature 0.9 in "match" mode, the dense backend, int8 KV at page
  size 2 with K = 3, max_new_tokens reached mid-burst, "rejection" mode
  at temperature 0;
* "rejection" mode at temperature 0.9 replays for a seed and stays in
  the vocabulary; "match" mode leaves each generator where ``n_acc + 1``
  plain draws leave it;
* the page pool drains clean; the guards raise;
* kernel 2's per-sequence offsets: the plain version ≡
  ``masked_attention_ref`` with the burst's mask, and the wrapper hands
  ``q_offsets`` to the CUDA entry point (meta tensors and a recorder in
  place of the built library, as ``tests/test_torch_packed_route.py``);
* the CLI serves with a drafter and prints the spec stats line.

Weights: the reference's reduced qwen2.5-3b through ``bridge``.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.configs import get_config, reduced_config  # noqa: E402
from repro.models.transformer import build_model as ref_build  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config as port_get_config  # noqa: E402
from repro_torch.configs import reduced_config as port_reduced  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention as fa  # noqa: E402
from repro_torch.kernels.flash_attention.ref import masked_attention_ref  # noqa: E402
from repro_torch.launch import serve as port_serve  # noqa: E402
from repro_torch.models import kv_cache  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402
from repro_torch.runtime import sampling  # noqa: E402
from repro_torch.runtime.serve_loop import ServeEngine  # noqa: E402

PROMPTS = [[3, 1, 4, 1, 5, 9, 2, 6], [2, 7, 1, 8]]


@functools.lru_cache(maxsize=None)
def _params(seed):
    cfg = reduced_config(get_config("qwen2.5-3b"))
    params = ref_build(cfg).init(jax.random.PRNGKey(seed))
    return bridge.params_from_numpy(jax.tree.map(np.asarray, params), "cpu")


def _model(**kw):
    return Model(port_reduced(port_get_config("qwen2.5-3b")), device="cpu", **kw)


def _serve(params, *, model=None, spec=None, temp=0.0, max_new=10, **kw):
    eng = ServeEngine(model or _model(), params, slots=2, max_len=64, **(spec or {}), **kw)
    uids = [eng.submit(p, max_new_tokens=max_new, temperature=temp) for p in PROMPTS]
    res = eng.run()
    return [res[u] for u in uids], eng


def _spec(params, k=4, mode="match", model=None):
    return {"draft_model": model or _model(), "draft_params": params, "spec_k": k,
            "spec_mode": mode}


def _tensors(cache):
    out = [cache["pos"]]
    for c in cache["layers"]:
        out += [t for t in (c.k, c.v, c.k_s, c.v_s, getattr(c, "block_table", None))
                if t is not None]
    return out


# .. verify_step: one burst == K+1 decode steps ..

@pytest.mark.parametrize("kind,kv_quant", [("dense", False), ("paged", False),
                                           ("paged", True)])
def test_verify_step_equals_sequential_decode(kind, kv_quant):
    model = _model(kv_quant=kv_quant)
    params = _params(0)
    rng = np.random.default_rng(7)
    vocab = model.cfg.vocab_size
    toks = torch.from_numpy(rng.integers(1, vocab, (2, 6)))
    burst = torch.from_numpy(rng.integers(1, vocab, (2, 5)))
    kw = {"page_size": 4} if kind == "paged" else {}

    def prefilled():
        mask = torch.ones((2, 6), dtype=torch.bool)
        mask[1, :2] = False                         # a ragged batch: start 2
        _, c = model.prefill(params, model.init_cache(2, 32, kind=kind, **kw), toks,
                             pad_mask=mask)
        c["pos"] = torch.tensor([6, 6], dtype=torch.int32)
        c["start"] = torch.tensor([0, 2], dtype=torch.int32)
        return c

    vlog, vc, states = model.verify_step(params, prefilled(), burst)
    assert vlog.shape == (2, 5, model.cfg.padded_vocab)
    assert states == [None] * model.cfg.num_layers
    sc = prefilled()
    for t in range(burst.shape[1]):
        lt, sc = model.decode_step(params, sc, burst[:, t])
        assert torch.equal(vlog[:, t], lt), t
    for a, b in zip(_tensors(vc), _tensors(sc), strict=True):
        assert torch.equal(a, b)


def test_verify_view_and_fork():
    """The paged burst read is the gathered position-ordered view with
    the burst's mask; fork / rollback restore the block table."""
    cache = kv_cache.paged_init(2, 8, 1, 4, torch.float32, page_size=4)
    cache.k.copy_(torch.arange(cache.k.numel(), dtype=torch.float32).reshape(cache.k.shape))
    pos, start = torch.tensor([2, 5], dtype=torch.int32), torch.tensor([1, 0], dtype=torch.int32)
    k, _, ks, _, valid = cache.verify_view(pos, start, 3)
    assert ks is None and valid.shape == (2, 3, 8)
    assert torch.equal(k[1, 4], cache.k[cache.block_table[1, 1], 0])
    assert torch.equal(valid, kv_cache.burst_valid(pos, start, 3, 8))
    assert valid[0, 0].tolist() == [False, True, True] + [False] * 5
    assert valid[1, 2].tolist() == [True] * 8
    gk, _, _, _, gvalid = cache.gather_view(pos, start)
    assert torch.equal(gk, k) and torch.equal(gvalid, valid[:, 0])
    snap = cache.fork()
    cache.block_table[0, 1] = 0
    assert cache.rollback(snap) is cache and int(cache.block_table[0, 1]) != 0
    dense = kv_cache.dense_init(2, 8, 1, 4, torch.float32)
    assert dense.fork() is None and dense.rollback(None) is dense


def test_dense_slot_protocol():
    dense = kv_cache.dense_init(3, 8, 1, 4, torch.float32, quantized=True)
    one = dense.prefill_view(1)
    assert one.k.shape == (1, 8, 1, 4) and one.k_s.shape == (1, 8, 1, 1)
    one.write_prompt(torch.ones((1, 5, 1, 4)), torch.ones((1, 5, 1, 4)), 0)
    assert int(dense.k.abs().sum()) == 0           # a fresh view, not the rows
    assert dense.admit(one, 1) is dense and dense.free_slot(1) is dense
    assert torch.equal(dense.k[1], one.k[0]) and torch.equal(dense.v_s[1], one.v_s[0])
    assert int(dense.k[0].abs().sum()) == 0 and int(dense.k[2].abs().sum()) == 0


# .. the engine: spec streams == plain streams ..

def test_divergent_drafter():
    plain, _ = _serve(_params(0))
    spec, eng = _serve(_params(0), spec=_spec(_params(1)))
    assert spec == plain
    assert eng.acceptance_rate is not None and eng.acceptance_rate < 0.5


def test_shared_drafter_full_acceptance():
    model = _model()
    plain, _ = _serve(_params(0), model=model)
    spec, eng = _serve(_params(0), model=model, spec=_spec(_params(0), model=model))
    assert spec == plain
    assert eng.acceptance_rate == 1.0
    st = eng.spec_stats
    assert st["emitted"] > 2 * st["ticks"]


def test_match_mode_hot_temperature():
    plain, _ = _serve(_params(0), temp=0.9)
    spec, _ = _serve(_params(0), spec=_spec(_params(1)), temp=0.9)
    assert spec == plain


def test_dense_backend():
    plain, eng = _serve(_params(0), cache_kind="dense")
    assert eng.cache_kind == "dense" and eng.page_stats is None
    assert eng.prefix_stats is None
    spec, _ = _serve(_params(0), spec=_spec(_params(1)), cache_kind="dense")
    assert spec == plain
    paged, _ = _serve(_params(0), prefix_cache=False)
    assert plain == paged


def test_int8_kv_page_crossing():
    model = _model(kv_quant=True)
    plain, _ = _serve(_params(0), model=model, page_size=2)
    spec, eng = _serve(_params(0), model=model, page_size=2,
                       spec=_spec(_params(1), k=3, model=model))
    assert spec == plain
    eng.check_leaks()


def test_max_new_stops_mid_burst():
    model = _model()
    plain, _ = _serve(_params(0), model=model, max_new=3)
    spec, _ = _serve(_params(0), model=model, max_new=3,
                     spec=_spec(_params(0), k=4, model=model))
    assert spec == plain and all(len(o) == 3 for o in spec)


def test_rejection_mode_temp0():
    plain, _ = _serve(_params(0))
    spec, _ = _serve(_params(0), spec=_spec(_params(1), mode="rejection"))
    assert spec == plain


def test_rejection_mode_hot_deterministic():
    a, _ = _serve(_params(0), spec=_spec(_params(1), mode="rejection"), temp=0.9)
    b, _ = _serve(_params(0), spec=_spec(_params(1), mode="rejection"), temp=0.9)
    assert a == b
    vocab = _model().cfg.vocab_size
    assert all(0 <= t < vocab for o in a for t in o)


def test_degraded_ticks_keep_the_stream():
    """spec_enabled off mid-run: plain ticks (the drafter's pos kept in
    step), then spec again; "match" keeps the stream either way."""
    plain, _ = _serve(_params(0), temp=0.9)
    eng = ServeEngine(_model(), _params(0), slots=2, max_len=64, **_spec(_params(0)))
    uids = [eng.submit(p, max_new_tokens=10, temperature=0.9) for p in PROMPTS]
    for i in range(40):
        eng.spec_enabled = i % 3 != 1
        if not eng.step():
            break
    assert [eng._results[u] for u in uids] == plain


# .. sampling ..

def test_match_mode_generator_state():
    """Position t draws what sample_logits draws on the (t+1)-th tick, and
    each hot generator ends where n_acc + 1 plain draws leave it; a greedy
    row touches no generator."""
    b, s, v = 3, 4, 64
    rng = np.random.default_rng(0)
    logits = torch.from_numpy(rng.normal(size=(b, s, v)).astype(np.float32) * 3)
    temp = [0.7, 1.3, 0.0]
    keys = sampling.init_keys(5, b)
    expect, chain = [], [[k.get_state()] for k in keys]
    plain_keys = sampling.init_keys(5, b)
    for t in range(s):
        tok, _ = sampling.sample_logits(logits[:, t], plain_keys, temp, top_k=20, top_p=0.9)
        expect.append(tok)
        for i, k in enumerate(plain_keys):
            chain[i].append(k.get_state())
    expect = torch.stack(expect, 1)
    draft = expect[:, :s - 1].clone()
    draft[0, 2] = (draft[0, 2] + 1) % v            # slot 0 accepts 2, slot 1 none
    draft[1, 0] = (draft[1, 0] + 1) % v
    toks, n_acc, _ = sampling.spec_verify(logits, draft, keys, temp, top_k=20, top_p=0.9)
    assert torch.equal(toks, expect)
    assert n_acc.tolist() == [2, 0, 3]
    for i in range(2):
        assert torch.equal(keys[i].get_state(), chain[i][int(n_acc[i]) + 1])
    assert torch.equal(keys[2].get_state(), chain[2][0])


def test_greedy_verify_and_rejection_at_temperature_0():
    rng = np.random.default_rng(1)
    logits = torch.from_numpy(rng.normal(size=(2, 3, 8)).astype(np.float32))
    am = logits.argmax(-1).to(torch.int32)
    draft = am[:, :2].clone()
    draft[1, 1] = (draft[1, 1] + 1) % 8
    toks, n_acc = sampling.greedy_verify(logits, draft)
    assert torch.equal(toks, am) and n_acc.tolist() == [2, 1]
    keys = sampling.init_keys(0, 2)
    before = [k.get_state() for k in keys]
    rt, rn, _ = sampling.spec_verify(logits, draft, keys, [0.0, 0.0], mode="rejection")
    assert torch.equal(rt, toks) and torch.equal(rn, n_acc)
    assert all(torch.equal(k.get_state(), s) for k, s in zip(keys, before))
    with pytest.raises(ValueError, match="mode"):
        sampling.spec_verify(logits, draft, keys, [0.0, 0.0], mode="typical")


# .. accounting and guards ..

def test_page_pool_drains_clean():
    _, eng = _serve(_params(0), spec=_spec(_params(1)), page_size=4)
    stats = eng.page_stats
    assert stats["free"] + stats["resident"] == stats["total"]
    assert stats["reserved"] == 0
    assert stats["resident"] == stats["cached"]   # only prefix-cache pins left
    assert not eng._slot_pages and not eng._slot_shared
    assert (eng._table == 0).all()
    eng.check_leaks()


def test_burst_reserves_spec_k_pages():
    eng = ServeEngine(_model(), _params(0), slots=2, max_len=64, page_size=4,
                      **_spec(_params(1), k=4))
    assert eng._pages_needed(8, 10) == 6           # ceil((8 + 10 + 4) / 4)
    plain = ServeEngine(_model(), _params(0), slots=2, max_len=64, page_size=4)
    assert plain._pages_needed(8, 10) == 5


def test_guards_raise():
    model, params = _model(), _params(0)
    base = dict(slots=2, max_len=64)
    with pytest.raises(ValueError, match="spec_k"):
        ServeEngine(model, params, **base, **_spec(params, k=0))
    wide = Model(dataclasses.replace(model.cfg, vocab_size=128), device="cpu")
    with pytest.raises(ValueError, match="vocab"):
        ServeEngine(model, params, **base, draft_model=wide, draft_params=None)
    windowed = Model(port_reduced(port_get_config("starcoder2-15b")), device="cpu")
    assert windowed.cfg.sliding_window
    with pytest.raises(ValueError, match="[Ss]liding-window"):
        ServeEngine(model, params, **base, draft_model=windowed, draft_params=None)
    with pytest.raises(ValueError, match="ring"):
        ServeEngine(windowed, params, **base, draft_model=windowed, draft_params=None)
    # SSM targets and drafters, refused until SSM serving was ported, pass
    # the guards (their streams: tests/test_torch_ssm_serve.py); the
    # rollback of a model without SSM layers passes every cache through
    ssm = Model(port_reduced(port_get_config("mamba2-370m")), device="cpu")
    eng = ServeEngine(ssm, {}, **base, prefix_cache=False, draft_model=ssm, draft_params={})
    assert eng._t_has_ssm and eng._d_has_ssm
    eng = ServeEngine(model, params, **base, draft_model=ssm, draft_params={})
    assert not eng._t_has_ssm and eng._d_has_ssm
    layers = [object(), object()]
    assert model.select_ssm_states(layers, [None, None], None) == layers


# .. kernel 2 with per-sequence offsets ..

@pytest.mark.parametrize("sq,dtype", [(5, torch.float32), (5, torch.bfloat16),
                                      (1, torch.float32)])
def test_plain_offsets_equal_the_burst_mask(sq, dtype):
    g = torch.Generator().manual_seed(3)
    b, hq, hkv, d, w = 3, 4, 2, 64, 40
    q = torch.randn((b, hq, sq, d), generator=g).to(dtype)
    k = torch.randn((b, hkv, w, d), generator=g).to(dtype)
    v = torch.randn((b, hkv, w, d), generator=g).to(dtype)
    pos = torch.tensor([7, 30, 0], dtype=torch.int32)
    start = torch.tensor([2, 0, 0], dtype=torch.int32)
    got = fa.flash_attention_masked(q, k, v, start, q_offsets=pos)
    valid = kv_cache.burst_valid(pos, start, sq, w)
    want = masked_attention_ref(q, k, v, valid=valid, chunk=w).to(dtype)
    if sq == 1:   # a one-row read rotates its columns: the same sum in another order
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    else:
        assert torch.equal(got, want)
    # the offset of every sequence, not of slot 0: slot 1 differs from it
    wrong = fa.flash_attention_masked(q, k, v, start, q_offset=int(pos[0]))
    assert not torch.equal(wrong[1], got[1])


class _Recorder:
    def __init__(self):
        self.calls = []

    def entry(self, name, fname=None):
        def fn(*args):
            self.calls.append((name, fname, args))
            return 0
        return fn


def test_wrapper_hands_q_offsets_to_the_kernel(monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(fa._build, "entry", rec.entry)
    monkeypatch.setattr(fa._build, "stream_of", lambda t: 0)
    monkeypatch.setattr(fa.flash_attention_masked, "launches", 0)
    monkeypatch.setattr(fa.flash_attention_masked, "tc_launches", 0)
    monkeypatch.setattr(fa.flash_attention_masked, "offset_launches", 0)
    meta = torch.device("meta")
    q = torch.empty((8, 16, 5, 128), dtype=torch.bfloat16, device=meta)
    kv = torch.empty((8, 2, 576, 128), dtype=torch.bfloat16, device=meta)
    start = torch.empty((8,), dtype=torch.int32, device=meta)
    fa.flash_attention_masked(q, kv, kv, start, q_offsets=start)
    fa.flash_attention_masked(q, kv, kv, start, q_offset=3)
    (src, fname, with_offsets), (_, _, without) = rec.calls
    assert (src, fname) == ("flash_attention", "flash_attention_masked")
    assert len(with_offsets) == 6 + 10 + 2     # 6 pointers, 10 ints, scale, stream
    assert len(with_offsets) == len(fa._build.ENTRY_POINTS[src][fname])
    assert isinstance(with_offsets[4], int) and without[4] is None
    assert with_offsets[7:12] == (8, 16, 2, 5, 576) and without[13] == 3
    assert fa.flash_attention_masked.launches == 2 == fa.flash_attention_masked.tc_launches
    assert fa.flash_attention_masked.offset_launches == 1
    for bad in (start.to(torch.int64), start[:4]):
        with pytest.raises(ValueError, match="q_offsets"):
            fa.flash_attention_masked(q, kv, kv, start, q_offsets=bad)


# .. the CLI ..

def test_launch_serve_with_a_drafter(capsys):
    port_serve.main(["--arch", "qwen2.5-3b", "--smoke", "--engine", "--quantize",
                     "--device", "cpu", "--draft-arch", "qwen2.5-3b", "--spec-k", "2",
                     "--batch", "2", "--steps", "4", "--prompt-len", "8"])
    out = capsys.readouterr().out
    assert "served 4 ragged requests" in out and "16 tokens" in out
    assert "spec[k=2, match]:" in out and "(100.00%)" in out and "tok/tick" in out
