"""SSM serving in the port against the reference on the CPU: the
``SSMCache`` slot protocol and its bridge, the SSM layer's serving steps
(``decode_step``, ``prefill_step``, ``verify_step``, ``select_state``),
batched prefill ≡ sequential decode bit for bit on the plain path, row
8p's CPU route (the card route's code with 8p's plain version) against
the per-step scan with its planted faults, and the engine (mamba2-370m
and the hybrid jamba-1.5-large): spec rollback ≡ plain decode, retried ≡
fault-free, and the parking check.  The engine's greedy streams against
the reference engine's are in ``tests/test_torch_ssm_engine.py``.

Inputs: reduced configs (f32), reference params from
``PRNGKey(0 or 1)``, numpy-seeded tokens, states and masks.  Tolerances:
both packages compute the same float32 sums, the port's conv window as
an elementwise product summed over W (the reference's ``einsum``) and
its softplus with a cut at 20 (``ssm.py``'s docstring): they agree to
~1e-6 of the largest value, so STEP_RTOL = 2e-5 of each output's
largest element.  The card route runs the chunk algorithm (8p's plain
version) and the conv as shifted products in place of the per-step
scan: the same sums in other orders, ROUTE_RTOL = 1e-4 relative L2,
which each planted fault passes by orders of magnitude.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import reduced_config as ref_reduced  # noqa: E402
from repro.models import ssm as ref_ssm  # noqa: E402
from repro.models.kv_cache import SSMCache as RefSSMCache  # noqa: E402
from repro.models.transformer import build_model as ref_build  # noqa: E402
from repro.runtime.serve_loop import ServeEngine as RefEngine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import (_fwd_chunks,  # noqa: E402
                                              ssd_prefill_steps_ref)
from repro_torch.kernels.ssd_scan.ssd_scan import prefill_operands, ssd_prefill  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models.kv_cache import SSMCache  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402
from repro_torch.runtime.faults import Fault, FaultPlan  # noqa: E402
from repro_torch.runtime.serve_loop import ServeEngine  # noqa: E402

STEP_RTOL = 2e-5
ROUTE_RTOL = 1e-4
SSM_ARCHS = ("mamba2-370m", "jamba-1.5-large")


@functools.lru_cache(maxsize=None)
def _setup(arch, key=0):
    """(reference config, reference params, port config, port params)."""
    cfg = ref_reduced(ref_get_config(arch))
    params = ref_build(cfg).init(jax.random.PRNGKey(key))
    port = bridge.params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    return cfg, params, reduced_config(get_config(arch)), port


def _close(got, want, rtol=STEP_RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rtol * (np.abs(want).max() + 1e-30), (err, np.abs(want).max())


def _rel(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


# .. SSMCache ..

def test_ssm_cache_slot_protocol():
    """prefill_view gives zeroed one-slot state; admit writes it at the slot
    in place; free_slot, fork / rollback, with_table and copy_pages change
    nothing; clone is a deep copy that copy_from restores in place;
    nbytes counts both tensors; update rebinds them on the object."""
    cfg = reduced_config(get_config("mamba2-370m"))
    cache = ssm.init_cache(cfg, 3, torch.float32, device="cpu")
    _, nheads, conv_dim = ssm.dims(cfg)
    s = cfg.ssm
    assert cache.conv.shape == (3, s.conv_width - 1, conv_dim)
    assert cache.ssd.shape == (3, nheads, s.head_dim, s.state_dim)
    assert cache.ssd.dtype == torch.float32
    assert cache.nbytes == 4 * (cache.conv.numel() + cache.ssd.numel())
    gen = torch.Generator().manual_seed(0)
    cache.conv.normal_(generator=gen)
    cache.ssd.normal_(generator=gen)
    conv_t, ssd_t = cache.conv, cache.ssd
    one = cache.prefill_view(1)
    assert one.conv.shape[0] == one.ssd.shape[0] == 1
    assert not one.conv.any() and not one.ssd.any()
    one.conv.fill_(2.0)
    one.ssd.fill_(3.0)
    snap = cache.clone()
    assert cache.admit(one, 1) is cache
    assert cache.conv is conv_t and cache.ssd is ssd_t          # in place
    assert (cache.conv[1] == 2).all() and (cache.ssd[1] == 3).all()
    assert torch.equal(cache.ssd[0], snap.ssd[0]) and torch.equal(cache.ssd[2], snap.ssd[2])
    for op in (lambda c: c.free_slot(1), lambda c: c.rollback(c.fork()),
               lambda c: c.with_table(None), lambda c: c.copy_pages(None, None)):
        before = cache.ssd.clone()
        assert op(cache) is cache
        assert torch.equal(cache.ssd, before)
    assert cache.fork() is None
    cache.copy_from(snap)
    assert cache.ssd is ssd_t and torch.equal(cache.ssd, snap.ssd)
    assert torch.equal(cache.conv, snap.conv)
    new = torch.zeros_like(cache.ssd)
    assert cache.update(cache.conv, new) is cache and cache.ssd is new


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_cache_bridge_both_ways(dtype):
    """A reference SSMCache (conv in the compute dtype, ssd f32) crosses to
    the port and back bit for bit, bfloat16 included."""
    cfg = ref_reduced(ref_get_config("mamba2-370m"))
    rng = np.random.default_rng(3)
    ref = ref_ssm.init_cache(cfg, 2, jnp.dtype(dtype))
    ref = RefSSMCache(conv=jnp.asarray(rng.standard_normal(ref.conv.shape), ref.conv.dtype),
                      ssd=jnp.asarray(rng.standard_normal(ref.ssd.shape), jnp.float32))
    port = bridge.ssm_cache_from_numpy(np.asarray(ref.conv), np.asarray(ref.ssd), "cpu")
    assert isinstance(port, SSMCache)
    assert port.conv.dtype == {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    conv, ssd = bridge.ssm_cache_to_numpy(port)
    np.testing.assert_array_equal(conv, np.asarray(ref.conv, np.float32))
    np.testing.assert_array_equal(ssd, np.asarray(ref.ssd))


def test_model_caches_and_engine_state_bytes():
    """An SSM layer's cache is an SSMCache beside the attention layers'
    backends (jamba: 7 SSM + 1 attention a group); the engine counts its
    states in pool_bytes and ssm_bytes; "auto" prefix caching resolves to
    off and True is refused."""
    _, _, cfg, params = _setup("jamba-1.5-large")
    model = Model(cfg, device="cpu")
    cache = model.init_cache(2, 16, kind="dense")
    kinds = [type(c).__name__ for c in cache["layers"]]
    assert kinds == ["SSMCache" if m == "ssm" else "DenseCache"
                     for m, _ in cfg.group] * cfg.num_groups
    eng = ServeEngine(model, params, slots=2, max_len=32)
    assert eng.prefix_stats is None and eng.cache_kind == "paged"
    ssm_bytes = sum(c.nbytes for c in eng.cache["layers"] if isinstance(c, SSMCache))
    assert eng.ssm_bytes == ssm_bytes > 0
    assert eng.pool_bytes == ssm_bytes + sum(
        c.nbytes for c in eng.cache["layers"] if not isinstance(c, SSMCache))
    with pytest.raises(ValueError, match="SSM"):
        ServeEngine(model, params, slots=2, max_len=32, prefix_cache=True)


# .. the SSM layer's steps against the reference ..

def _layer(arch="mamba2-370m"):
    """(reference cfg, reference layer-0 mixer params, port cfg, port ones)."""
    rcfg, rparams, cfg, port = _setup(arch)
    pos = cfg.ssm_positions[0]
    rp = jax.tree.map(lambda a: a[0], rparams["groups"][pos]["mixer"])
    return rcfg, rp, cfg, port["layers"][pos]["mixer"]


def _state(cfg, b, seed):
    """A random (conv, ssd) entering state, numpy f32."""
    rng = np.random.default_rng(seed)
    _, nheads, conv_dim = ssm.dims(cfg)
    s = cfg.ssm
    conv = rng.standard_normal((b, s.conv_width - 1, conv_dim)).astype(np.float32)
    ssd = rng.standard_normal((b, nheads, s.head_dim, s.state_dim)).astype(np.float32)
    return conv, ssd


def _both(conv, ssd):
    return (RefSSMCache(conv=jnp.asarray(conv), ssd=jnp.asarray(ssd)),
            SSMCache(torch.from_numpy(conv.copy()), torch.from_numpy(ssd.copy())))


def test_decode_step_matches_reference():
    """One token from a random state, a pad in the batch (its conv input
    zeroed, its SSD state carried through exactly)."""
    rcfg, rp, cfg, pp = _layer()
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
    tm = np.array([True, False, True])
    rc, pc = _both(*_state(cfg, 3, 2))
    ssd0 = pc.ssd.clone()
    y_ref, rc = ref_ssm.decode_step(rcfg, rp, jnp.asarray(x), rc, 5,
                                    token_mask=jnp.asarray(tm))
    y, pc = ssm.decode_step(cfg, pp, torch.from_numpy(x), pc, 5,
                            token_mask=torch.from_numpy(tm))
    _close(y, y_ref)
    _close(pc.conv, rc.conv)
    _close(pc.ssd, rc.ssd)
    assert torch.equal(pc.ssd[1], ssd0[1])


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_prefill_and_verify_steps_match_reference(arch):
    """prefill_step over a ragged left-padded batch from a random state,
    verify_step's outputs and per-step states, and select_state at
    per-row steps, against the reference's."""
    rcfg, rp, cfg, pp = _layer(arch)
    rng = np.random.default_rng(4)
    b, s = 3, 9
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    mask = np.arange(s)[None, :] >= np.array([0, 3, 8])[:, None]
    conv, ssd = _state(cfg, b, 5)
    rc, pc = _both(conv, ssd)
    y_ref, rc = ref_ssm.prefill_step(rcfg, rp, jnp.asarray(x), rc, mask=jnp.asarray(mask))
    y, pc = ssm.prefill_step(cfg, pp, torch.from_numpy(x), pc, mask=torch.from_numpy(mask))
    _close(y, y_ref)
    _close(pc.conv, rc.conv)
    _close(pc.ssd, rc.ssd)

    rc, pc = _both(conv, ssd)
    y_ref, rc, rst = ref_ssm.verify_step(rcfg, rp, jnp.asarray(x[:, :5]), rc)
    y, pc, st = ssm.verify_step(cfg, pp, torch.from_numpy(x[:, :5]), pc)
    _close(y, y_ref)
    _close(pc.ssd, rc.ssd)
    assert st.conv.shape[:2] == st.ssd.shape[:2] == (b, 5)
    _close(st.conv, rst.conv)
    _close(st.ssd, rst.ssd)
    sel = np.array([0, 4, 2])
    one_ref = ref_ssm.select_state(rst, jnp.asarray(sel))
    one = ssm.select_state(st, torch.from_numpy(sel))
    _close(one.conv, one_ref.conv)
    _close(one.ssd, one_ref.ssd)
    for row, t in enumerate(sel):
        assert torch.equal(one.ssd[row], st.ssd[row, t])
        assert torch.equal(one.conv[row], st.conv[row, t])


# .. batched prefill ≡ sequential decode, bit for bit on the plain path ..

def _sequential(model, params, toks, mask, max_len):
    cache = model.init_cache(toks.shape[0], max_len, kind="dense")
    cache["start"] = (toks.shape[1] - mask.sum(1)).to(torch.int32)
    logits = None
    for t in range(toks.shape[1]):
        logits, cache = model.decode_step(params, cache, toks[:, t], token_mask=mask[:, t])
    return logits, cache


def _assert_caches_equal(a, b):
    for ca, cb in zip(a["layers"], b["layers"]):
        if isinstance(ca, SSMCache):
            assert torch.equal(ca.conv, cb.conv) and torch.equal(ca.ssd, cb.ssd)
        else:
            assert torch.equal(ca.k, cb.k) and torch.equal(ca.v, cb.v)


@pytest.mark.parametrize("arch", SSM_ARCHS)
@pytest.mark.parametrize("chunk", [None, 3])
def test_batched_prefill_equals_sequential_decode_bit_for_bit(arch, chunk):
    """A ragged left-padded batch: Model.prefill (whole, or chunks of 3)
    gives the last logits and every layer's cache of one decode step a
    token (pads under token_mask), bit for bit."""
    _, _, cfg, params = _setup(arch)
    model = Model(cfg, device="cpu")
    rng = np.random.default_rng(6)
    b, s = 3, 10
    toks = torch.from_numpy(rng.integers(1, cfg.vocab_size, (b, s)))
    mask = torch.arange(s)[None, :] >= torch.tensor([0, 4, 7])[:, None]
    cache = model.init_cache(b, 16, kind="dense")
    la, ca = model.prefill(params, cache, toks, pad_mask=mask, chunk=chunk)
    lb, cb = _sequential(model, params, toks, mask, 16)
    assert torch.equal(la, lb)
    _assert_caches_equal(ca, cb)


# .. row 8p: the card route's code on 8p's CPU plain version ..

def _route(monkeypatch, card: bool):
    """The SSM layer's route: the card's (prefill through 8p) or the plain
    per-step scan, on CPU tensors."""
    monkeypatch.setattr(ssm, "plain_path", lambda x, use_kernel: not card)


def _prefill(model, params, toks, mask, chunk):
    cache = model.init_cache(toks.shape[0], 200, kind="dense")
    logits, cache = model.prefill(params, cache, toks, pad_mask=mask, chunk=chunk)
    return logits, [c.ssd.clone() for c in cache["layers"] if isinstance(c, SSMCache)]


def _reading(run, want):
    (la, sa), (lb, sb) = run, want
    return max(_rel(la, lb), *(_rel(x, y) for x, y in zip(sa, sb)))


@pytest.mark.parametrize("arch", SSM_ARCHS)
@pytest.mark.parametrize("s,chunk", [(12, None), (150, None), (150, 64)])
def test_card_route_matches_the_scan(monkeypatch, arch, s, chunk):
    """prefill_step on the card route's code (conv at once, 8p's plain
    version; at 150 tokens 8p left-pads to 256 rows, in chunks of 64 each
    chunk enters from the last one's state) against the per-step scan:
    the logits and the leaving SSD states within ROUTE_RTOL."""
    _, _, cfg, params = _setup(arch)
    model = Model(cfg, device="cpu")
    rng = np.random.default_rng(7)
    toks = torch.from_numpy(rng.integers(1, cfg.vocab_size, (2, s)))
    mask = torch.arange(s)[None, :] >= torch.tensor([0, 5])[:, None]
    _route(monkeypatch, card=False)
    want = _prefill(model, params, toks, mask, chunk)
    calls = []
    real = ssd_ops.ssd_prefill
    monkeypatch.setattr(ssd_ops, "ssd_prefill",
                        lambda *a, **kw: calls.append(a[0].shape[1]) or real(*a, **kw))
    _route(monkeypatch, card=True)
    got = _prefill(model, params, toks, mask, chunk)
    n_ssm = len(cfg.ssm_positions) * cfg.num_groups
    assert len(calls) == n_ssm * (1 if chunk is None else -(-s // chunk))
    assert _reading(got, want) <= ROUTE_RTOL


def _fault(name):
    """The three planted faults of chip_smoke.py's 8p checks, emulated
    around the plain version: (wrapper of ssd_prefill)."""
    def entering_ignored(real):
        return lambda x, dt, a, b, c, h, **kw: real(x, dt, a, b, c, torch.zeros_like(h), **kw)

    def last_but_one(real):
        def f(x, dt, a, b, c, h, *, mask=None, chunk=128):
            xp, dtp, bp, cp, pad, q = prefill_operands(x, dt, b, c, mask, chunk)
            y, states = _fwd_chunks(xp, dtp, a, bp, cp, q, torch.einsum, h)
            return y[:, pad:], states[:, :, -2]
        return f

    def pads_decay(real):
        return lambda *a, mask=None, **kw: real(*a, mask=None, **kw)

    return {"entering state ignored": entering_ignored,
            "leaving state of the last-but-one chunk": last_but_one,
            "pad rows decay the state": pads_decay}[name]


@pytest.mark.parametrize("name", ["entering state ignored",
                                  "leaving state of the last-but-one chunk"])
def test_card_route_planted_faults_read_over_the_limit(monkeypatch, name):
    """Chunked admission (each chunk entered from the last one's state):
    8p's faults at the model's call read far over ROUTE_RTOL."""
    _, _, cfg, params = _setup("mamba2-370m")
    model = Model(cfg, device="cpu")
    rng = np.random.default_rng(8)
    toks = torch.from_numpy(rng.integers(1, cfg.vocab_size, (2, 150)))
    mask = torch.arange(150)[None, :] >= torch.tensor([0, 5])[:, None]
    _route(monkeypatch, card=False)
    want = _prefill(model, params, toks, mask, 64)
    _route(monkeypatch, card=True)
    monkeypatch.setattr(ssd_ops, "ssd_prefill", _fault(name)(ssd_ops.ssd_prefill))
    assert _reading(_prefill(model, params, toks, mask, 64), want) > 100 * ROUTE_RTOL


@pytest.mark.parametrize("l,pads,chunk", [(100, 7, 32), (70, 0, 32), (20, 3, 32),
                                          (128, 0, 128), (300, 37, 128)])
def test_ssd_prefill_cpu_route_against_the_steps(l, pads, chunk):
    """8p's CPU route (the wrapper's pad mask and left padding, then the
    chunk algorithm from h_init) against the per-step recurrence from the
    same state with dt zeroed at the pads, within 1e-5 of each output's
    largest element; the fault "pad rows decay the state" (the mask
    dropped) reads over 100 times that where there are pads."""
    rng = np.random.default_rng(l)
    b, h, p, g, n = 2, 4, 8, 2, 16
    x = torch.from_numpy(rng.standard_normal((b, l, h, p)).astype(np.float32))
    dt = torch.from_numpy(np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), (b, l, h)))
                          .astype(np.float32))
    a = -torch.arange(1, h + 1, dtype=torch.float32)
    bm, cm = (torch.from_numpy(rng.standard_normal((b, l, g, n)).astype(np.float32))
              for _ in range(2))
    h0 = torch.from_numpy(rng.standard_normal((b, h, p, n)).astype(np.float32))
    mask = torch.arange(l)[None, :].expand(b, l) >= pads
    y, hf = ssd_prefill(x, dt, a, bm, cm, h0, mask=mask, chunk=chunk)
    assert y.shape == x.shape and hf.shape == h0.shape
    yr, hr = ssd_prefill_steps_ref(x, torch.where(mask[..., None], dt, 0.0), a, bm, cm, h0)
    _close(y, yr, 1e-5)
    _close(hf, hr, 1e-5)
    if pads:
        yb, hb = _fault("pad rows decay the state")(ssd_prefill)(x, dt, a, bm, cm, h0,
                                                                  mask=mask, chunk=chunk)
        assert (hb - hr).abs().max() > 100 * 1e-5 * hr.abs().max()
    with pytest.raises(ValueError, match="fault"):
        ssd_prefill(x, dt, a, bm, cm, h0, mask=mask, chunk=chunk, fault=5)


class _Recorder:
    def __init__(self):
        self.calls = []

    def entry(self, name, fname=None):
        def fn(*args):
            self.calls.append((fname, args))
            return 0
        return fn


@pytest.mark.parametrize("l,chunk", [(512, 128), (128, 128), (300, 128)])
def test_ssd_prefill_wrapper_launches(monkeypatch, l, chunk):
    """On card tensors (meta tensors here, with a recorder for the built
    library) 8p is three launches on one stream over nc + 1 state slots:
    the states launch writes h0s and the cum_Q scratch, the carry reads
    them with h_init and writes h_final, the outputs launch reads h0s;
    a length the chunk does not divide is left-padded to the next
    multiple; each launch counted; the argument counts match the entry
    points' declared signatures."""
    from repro_torch.kernels.ssd_scan import ssd_scan as mod
    rec = _Recorder()
    monkeypatch.setattr(mod._build, "entry", rec.entry)
    monkeypatch.setattr(mod._build, "stream_of", lambda t: 7)
    for name in ("launches", "states_launches", "carry_launches", "out_launches"):
        monkeypatch.setattr(ssd_prefill, name, 0)
    meta = torch.device("meta")
    b, h, g, p, n = 1, 32, 1, 64, 128
    x = torch.empty((b, l, h, p), device=meta)
    dt = torch.empty((b, l, h), device=meta)
    a = torch.empty((h,), device=meta)
    bm = torch.empty((b, l, g, n), device=meta)
    h0 = torch.empty((b, h, p, n), device=meta)
    y, hf = ssd_prefill(x, dt, a, bm, bm, h0, chunk=chunk, fault=6)
    lp = -(-l // chunk) * chunk
    assert y.shape == x.shape and hf.shape == h0.shape
    (st, sargs), (ca, cargs), (out, oargs) = rec.calls
    assert (st, ca, out) == ("ssd_prefill_states", "ssd_prefill_carry", "ssd_prefill_out")
    for fname, args in rec.calls:
        assert len(args) == len(mod._build.ENTRY_POINTS["ssd_scan"][fname])
    nc = lp // chunk
    assert sargs[6:] == (b, lp, h, g, p, n, chunk, 7)
    assert cargs[0] == sargs[5] and cargs[1] == sargs[4]        # the scratch, then h0s
    assert cargs[2] == h0.data_ptr() and cargs[3] == hf.data_ptr()
    assert cargs[4:] == (b, lp, h, chunk, 6, 7)
    assert oargs[5] == sargs[4] and oargs[7:] == (b, lp, h, g, p, n, chunk, 7)
    assert (ssd_prefill.launches, ssd_prefill.states_launches, ssd_prefill.carry_launches,
            ssd_prefill.out_launches) == (1, 1, 1, 1)
    assert nc >= 1


# .. the engine (its streams against the reference engine's:
# tests/test_torch_ssm_engine.py) ..

PROMPT_LENS = (5, 11, 3, 16, 9, 14)
NEW = 6


def _prompts(cfg):
    rng = np.random.default_rng(7)
    return [rng.integers(1, cfg.vocab_size, n).tolist() for n in PROMPT_LENS]


def _serve(engine, prompts, **kw):
    for p in prompts:
        engine.submit(p, max_new_tokens=NEW, **kw)
    return engine.run()


# .. speculative rollback, faults, parking ..

@pytest.mark.parametrize("arch", SSM_ARCHS)
@pytest.mark.parametrize("drafter", ["shared", "other"])
def test_spec_rollback_streams_equal_plain_decode(arch, drafter):
    """SSM (and hybrid) targets and drafters: each spec tick selects the
    target's state after the accepted tokens from the verify burst's
    per-step states and the drafter's from its per-step snapshots, so
    the streams equal plain decode's (the reference's
    ``test_ssm_rollback``), with a weight-shared and a divergent drafter;
    the shared one accepts every draft."""
    _, _, cfg, params = _setup(arch)
    _, _, _, dparams = _setup(arch, 1)
    model = Model(cfg, device="cpu")
    prompts = _prompts(cfg)
    plain = _serve(ServeEngine(model, params, slots=3, max_len=48), prompts)
    dp = params if drafter == "shared" else dparams
    eng = ServeEngine(model, params, slots=3, max_len=48, draft_model=model,
                      draft_params=dp, spec_k=3)
    assert _serve(eng, prompts) == plain
    assert eng.spec_stats["ticks"] > 0
    if drafter == "shared":
        assert eng.acceptance_rate == 1.0
    else:
        assert eng.acceptance_rate < 1.0
    eng.check_leaks()


def test_spec_with_an_ssm_drafter_on_the_prefix_route():
    """An attention target with the prefix cache and an SSM drafter: the
    drafter's shadow prefill stays unpadded (its state ends on the last
    prompt token), and the streams equal plain decode's."""
    _, _, qcfg, _ = _setup("mamba2-370m")
    tcfg = reduced_config(get_config("qwen2.5-3b"))
    from repro_torch.launch import serve as port_serve
    model, params = port_serve.build(tcfg, seed=0, device="cpu")
    dmodel = Model(qcfg, device="cpu")
    _, _, _, dparams = _setup("mamba2-370m")
    prompts = _prompts(tcfg)
    plain = _serve(ServeEngine(model, params, slots=3, max_len=48), prompts)
    seen = []
    eng = ServeEngine(model, params, slots=3, max_len=48, draft_model=dmodel,
                      draft_params=dparams, spec_k=2)
    assert eng.prefix_stats is not None
    real = dmodel.prefill
    dmodel.prefill = lambda p, c, toks, **kw: seen.append(toks.shape[1]) or real(p, c, toks, **kw)
    assert _serve(eng, prompts) == plain
    assert seen == list(PROMPT_LENS)


def test_retried_equals_fault_free():
    """Faults at the allocator, prefill, decode and sampler sites under the
    scheduler's snapshot / restore: the retried streams at temperature 0.9
    equal the fault-free synchronous engine's on the hybrid model (the SSM
    states restored in place with the attention pools)."""
    from repro_torch.runtime.scheduler import PipelinedScheduler
    _, _, cfg, params = _setup("jamba-1.5-large")
    model = Model(cfg, device="cpu")
    prompts = _prompts(cfg)
    kw = dict(slots=2, max_len=48, seed=5)
    want = _serve(ServeEngine(model, params, **kw), prompts, temperature=0.9)
    eng = ServeEngine(model, params, **kw)
    sched = PipelinedScheduler(eng, max_retries=3)
    for p in prompts:
        sched.submit(p, max_new_tokens=NEW, temperature=0.9)
    faults = [Fault("allocator.alloc", at=2), Fault("prefill.dispatch", at=1),
              Fault("decode.dispatch", at=2), Fault("decode.dispatch", at=7),
              Fault("sampler", at=3)]
    with FaultPlan(faults) as plan:
        got = sched.run()
    assert len(plan.fired) == len(faults)
    assert got == want
    eng.check_leaks()


@functools.lru_cache(maxsize=None)
def _ref_parked_vs_unparked():
    """The reference engine on reduced mamba2-370m, one slot: a stream
    parked mid-generation while another request takes and finishes in its
    slot, then resumed, against the same stream never parked."""
    cfg, params, _, _ = _setup("mamba2-370m")
    prompts = _prompts(reduced_config(get_config("mamba2-370m")))

    def run(park: bool):
        eng = RefEngine(ref_build(cfg), params, slots=1, max_len=48)
        uid = eng.submit(prompts[0], max_new_tokens=NEW)
        eng.step()
        eng.step()
        if park:
            eng.park_slot(0)
            eng.submit(prompts[1], max_new_tokens=NEW)
            while eng._active or eng._queue:
                eng.step()
            eng.resume_parked(uid)
        return eng.run()[uid]

    return run(False), run(True)


def test_reference_parking_loses_the_ssm_state_and_the_port_refuses_it():
    """The reference's parked record keeps pages only: the next occupant of
    the slot overwrites the SSM state, and the resumed stream differs from
    the unparked one (ROADMAP's quirks).  The port refuses to park an
    engine with SSM layers, as the reference refuses row backends."""
    unparked, parked = _ref_parked_vs_unparked()
    assert len(unparked) == len(parked) == NEW
    assert parked != unparked
    _, _, cfg, params = _setup("mamba2-370m")
    eng = ServeEngine(Model(cfg, device="cpu"), params, slots=1, max_len=48)
    eng.submit(_prompts(cfg)[0], max_new_tokens=NEW)
    eng.step()
    with pytest.raises(ValueError, match="SSM"):
        eng.park_slot(0)
