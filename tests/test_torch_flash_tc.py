"""The tensor-core route of kernels 2, 7, 7b and 7c, rehearsed on the CPU.

The bfloat16 route of the training forward (kernel 7) and of its backward
(7b dK/dV, 7c dQ) runs ``wgmma`` with bf16 operands: the forward rounds
the probabilities P to bf16 (relative to the running max after each
128-column kv tile) before the value product, 7b rounds P and dS to bf16
before the dV and dK products, and 7c rounds dS to bf16 before the dQ
product, computing D_i = rowsum(dO * O) in f32 in the same pass and
handing it to 7b.  ``_emulate_fwd``, ``_emulate_dkdv`` and ``_emulate_dq``
are plain-torch versions of exactly those rounding points.  Held against
the f32 plain versions (``flash_attention_ref``, ``flash_attention_bwd_ref``)
with ``chip_smoke.py``'s own limits and units (``TOL_BF16`` in att|v| and
``bwd_units`` units, ``TOL_F32`` for lse), they read at most 1, and the
planted faults of ``chip_smoke.py`` (a causal mask off by one, the
neighbouring row's lse) read above 1: the limits that the card's run
applies have room for the new rounding and still catch the faults.  Also
the pure-Python route choice and the ``delta`` plumbing of
``flash_attention_bwd_dq`` and ``flash_attention_bwd_dkdv`` on CPU tensors.

Kernel 2 (the masked serving prefill) takes the training forward's
tensor-core body with a start mask and 64-column kv tiles:
``_emulate_masked`` rounds P to bf16 relative to the running max after
each such tile, and is held against ``masked_attention_ref`` (and the JAX
package's) with the same ``TOL_BF16`` in att|v| units, on a ragged batch
(one start past a whole q tile) and a chunked prefill (``q_offset > 0``);
pad-query rows come out as exact zeros, and the planted faults of
``chip_smoke.py``'s ``check_flash`` (start + 1, window + 1) read above 1.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref  # noqa: E402
from repro.kernels.flash_attention.ref import (  # noqa: E402
    masked_attention_ref as jax_masked_attention_ref)
from repro_torch.kernels.flash_attention import flash_attention as fa  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    _band, flash_attention_bwd_ref, flash_attention_ref, masked_attention_ref)

TILE = 128      # the forward kernel's kv tile (FwdTC::BKV)
S = 200         # ragged against the kernels' 64- and 128-row tiles
CASES = [  # hq, hkv, d, window
    (2, 2, 64, None),
    (2, 2, 128, None),
    (16, 2, 64, 64),
    (16, 2, 128, 64),
]
IDS = [f"h{c[0]}kv{c[1]}d{c[2]}w{c[3]}" for c in CASES]


@pytest.fixture(scope="module")
def cs():
    """chip_smoke.py's limits and units, on the CPU."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_limits", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.DEV = "cpu"
    return mod


def _bf16_data(seed, hq, hkv, d, s=S):
    rng = np.random.default_rng(seed)
    f = lambda *sh: torch.from_numpy(rng.standard_normal(sh).astype(np.float32))  # noqa: E731
    return (f(1, hq, s, d).bfloat16(), f(1, hkv, s, d).bfloat16(),
            f(1, hkv, s, d).bfloat16(), f(1, hq, s, d).bfloat16())


def _emulate_fwd(q, k, v, *, window=None, q_offset=None, tile=TILE):
    """Kernel 7's bf16 route: online softmax over kv tiles of ``tile``
    columns; l sums the f32 probabilities, the value product takes them
    rounded to bf16 relative to the running max after the tile; output
    O / l in bf16, lse = m + log(l) (+inf on a fully masked row)."""
    b, hq, sq, d = q.shape
    skv = k.shape[2]
    off = skv - sq if q_offset is None else q_offset
    g = hq // k.shape[1]
    kf, vf = (t.float().repeat_interleave(g, 1) for t in (k, v))
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * d**-0.5
    s = torch.where(_band(sq, skv, off, True, window, q.device), s, -1e30)
    m = torch.full((b, hq, sq, 1), -1e30)
    l = torch.zeros((b, hq, sq, 1))
    acc = torch.zeros((b, hq, sq, d))
    for lo in range(0, skv, tile):
        st = s[..., lo:lo + tile]
        m_new = torch.maximum(m, st.amax(-1, keepdim=True))
        p = torch.where(st > -1e30, torch.exp(st - m_new), 0.0)
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhqk,bhkd->bhqd", p.bfloat16().float(),
                                         vf[:, :, lo:lo + tile])
        m = m_new
    out = (acc / torch.clamp_min(l, 1e-30)).bfloat16()
    lse = torch.where(l > 0, m + torch.log(l), float("inf"))[..., 0]
    return out, lse


def _emulate_dkdv(q, k, v, o, lse, do, *, window=None, q_offset=None, delta=None):
    """Kernel 7b's bf16 route: P = exp(S scale - lse) on the band, dS =
    P (dP - delta) with ``delta`` (default ``bwd_delta(o, do)``); dV =
    bf16(P)^T dO and dK = scale bf16(dS)^T Q, summed over each kv head's
    group, in bf16."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    off = skv - sq if q_offset is None else q_offset
    g = hq // hkv
    kf, vf = (t.float().repeat_interleave(g, 1) for t in (k, v))
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * d**-0.5
    band = _band(sq, skv, off, True, window, q.device)
    p = torch.where(band, torch.exp(s - lse[..., None]), 0.0)
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), vf)
    ds = p * (dp - (fa.bwd_delta(o, do) if delta is None else delta)[..., None])
    dv = torch.einsum("bhqk,bhqd->bhkd", p.bfloat16().float(), do.float())
    dk = torch.einsum("bhqk,bhqd->bhkd", ds.bfloat16().float(), q.float()) * d**-0.5
    return (dk.reshape(b, hkv, g, skv, d).sum(2).bfloat16(),
            dv.reshape(b, hkv, g, skv, d).sum(2).bfloat16())


def _emulate_dq(q, k, v, o, lse, do, *, window=None, q_offset=None):
    """Kernel 7c's bf16 route: D_i = rowsum(dO * O) in f32 from dO and O,
    P = exp(S scale - lse) on the band, dS = P (dP - D_i); dQ = scale
    bf16(dS) K in bf16.  Returns (dq, D_i)."""
    b, hq, sq, d = q.shape
    skv = k.shape[2]
    off = skv - sq if q_offset is None else q_offset
    g = hq // k.shape[1]
    kf, vf = (t.float().repeat_interleave(g, 1) for t in (k, v))
    delta = (do.float() * o.float()).sum(-1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * d**-0.5
    p = torch.where(_band(sq, skv, off, True, window, q.device),
                    torch.exp(s - lse[..., None]), 0.0)
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", do.float(), vf) - delta[..., None])
    dq = torch.einsum("bhqk,bhkd->bhqd", ds.bfloat16().float(), kf) * d**-0.5
    return dq.bfloat16(), delta


def _fwd_reading(cs, q, k, v, got, window):
    want = flash_attention_ref(q, k, v, window=window)[0].float()
    att = flash_attention_ref(q.float(), k.float(), v.float().abs(), window=window)[0]
    return cs.excess(got, want, att, cs.TOL_BF16)


def _bwd_reading(cs, q, k, v, o, lse, do, dk, dv, window, dq=None):
    """The bwd_check reading of kernels 7b + 7c: dk, dv and dq as given
    (dq from the plain version when None)."""
    want = [t.float() for t in flash_attention_bwd_ref(q, k, v, o, lse, do, window=window)]
    units = cs.bwd_units(torch, q, k, v, o, lse, do, window)
    return max(cs.excess(a, w, u, cs.TOL_BF16)
               for a, w, u in zip((want[0] if dq is None else dq, dk, dv), want, units))


@pytest.mark.parametrize("hq,hkv,d,window", CASES, ids=IDS)
def test_forward_rounding_within_the_chip_limit(cs, hq, hkv, d, window):
    q, k, v, _ = _bf16_data(1, hq, hkv, d)
    out, lse = _emulate_fwd(q, k, v, window=window)
    reading = _fwd_reading(cs, q, k, v, out, window)
    assert reading <= 1, reading
    lse_err = float((lse - flash_attention_ref(q, k, v, window=window)[1]).abs().max())
    assert lse_err <= cs.TOL_F32, lse_err
    # and against the JAX package's attention_ref on the same bf16 values
    want = np.asarray(jax_attention_ref(*(jnp.asarray(t.float().numpy()) for t in (q, k, v)),
                                        causal=True, window=window))
    att = flash_attention_ref(q.float(), k.float(), v.float().abs(), window=window)[0]
    assert cs.excess(out, torch.from_numpy(np.array(want)), att, cs.TOL_BF16) <= 1
    # the planted faults of the card's check read above the limit in bf16
    bad, _ = _emulate_fwd(q, k, v, window=window, q_offset=1)
    assert _fwd_reading(cs, q, k, v, bad, window) > 1
    if window:
        bad, _ = _emulate_fwd(q, k, v, window=window + 1)
        assert _fwd_reading(cs, q, k, v, bad, window) > 1


@pytest.mark.parametrize("tile", [64, 128])
def test_forward_rounding_any_tile_width(cs, tile):
    """The reading does not rest on the tile width: P rounded relative to
    a running max is within one bf16 rounding of P for any tiling."""
    q, k, v, _ = _bf16_data(2, 4, 2, 64)
    out, _ = _emulate_fwd(q, k, v, tile=tile)
    assert _fwd_reading(cs, q, k, v, out, None) <= 1


@pytest.mark.parametrize("hq,hkv,d,window", CASES, ids=IDS)
def test_dkdv_rounding_within_the_chip_limit(cs, hq, hkv, d, window):
    q, k, v, do = _bf16_data(3, hq, hkv, d)
    o, lse = flash_attention_ref(q, k, v, window=window)
    dk, dv = _emulate_dkdv(q, k, v, o, lse, do, window=window)
    assert _bwd_reading(cs, q, k, v, o, lse, do, dk, dv, window) <= 1
    bad = _emulate_dkdv(q, k, v, o, lse, do, window=window, q_offset=1)
    assert _bwd_reading(cs, q, k, v, o, lse, do, *bad, window) > 1
    bad = _emulate_dkdv(q, k, v, o, lse.roll(1, -1), do, window=window)
    assert _bwd_reading(cs, q, k, v, o, lse, do, *bad, window) > 1
    if hq > hkv:   # dK / dV of only the first q head of each group
        sel = lambda t: t[:, ::hq // hkv]   # noqa: E731
        bad = _emulate_dkdv(sel(q), k, v, sel(o), sel(lse), sel(do), window=window)
        assert _bwd_reading(cs, q, k, v, o, lse, do, *bad, window) > 1


def test_route_choice():
    assert fa.route(torch.bfloat16, 64) == "tensor-core"
    assert fa.route(torch.bfloat16, 128) == "tensor-core"
    assert fa.route(torch.float32, 64) == "cuda-core"
    assert fa.route(torch.float32, 128) == "cuda-core"
    with pytest.raises(TypeError):
        fa.route(torch.float16, 64)
    with pytest.raises(ValueError):
        fa.route(torch.bfloat16, 32)
    with pytest.raises(ValueError):
        fa.route(torch.float32, 96)
    # the launch counters exist per route and start at zero on the CPU
    assert fa.flash_attention.tc_launches == fa.flash_attention_bwd_dkdv.tc_launches == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dkdv_delta_plumbing_on_cpu(dtype):
    """flash_attention_bwd_dkdv on CPU tensors passes bwd_delta(o, do) to
    the plain version: the same dK and dV as flash_attention_bwd_ref
    computing D itself, and a wrong delta changes them."""
    q, k, v, do = (t.to(dtype) for t in _bf16_data(4, 4, 2, 64, s=48))
    o, lse = flash_attention_ref(q, k, v, window=16)
    delta = fa.bwd_delta(o, do)
    assert delta.shape == q.shape[:3] and delta.dtype == torch.float32
    np.testing.assert_allclose(
        delta.numpy(), (do.double() * o.double()).sum(-1).numpy(), rtol=1e-5, atol=1e-5)
    _, dk, dv = flash_attention_bwd_ref(q, k, v, o, lse, do, window=16)
    got = fa.flash_attention_bwd_dkdv(q, k, v, o, lse, do, window=16)
    assert torch.equal(got[0], dk) and torch.equal(got[1], dv)
    _, dk_bad, _ = flash_attention_bwd_ref(q, k, v, o, lse, do, window=16, delta=delta + 1)
    assert not torch.equal(dk_bad, dk)


@pytest.mark.parametrize("hq,hkv,d,window", CASES, ids=IDS)
def test_dq_rounding_within_the_chip_limit(cs, hq, hkv, d, window):
    """7c's rounding alone, and 7c + 7b as the training path runs them (7b
    reading the D_i that 7c computed), within the card's limits; the
    planted faults read above them; D_i within delta_check's limit of
    ``bwd_delta``."""
    q, k, v, do = _bf16_data(5, hq, hkv, d)
    o, lse = flash_attention_ref(q, k, v, window=window)
    _, dk, dv = flash_attention_bwd_ref(q, k, v, o, lse, do, window=window)
    dq, delta = _emulate_dq(q, k, v, o, lse, do, window=window)
    assert _bwd_reading(cs, q, k, v, o, lse, do, dk, dv, window, dq=dq) <= 1
    dk, dv = _emulate_dkdv(q, k, v, o, lse, do, window=window, delta=delta)
    assert _bwd_reading(cs, q, k, v, o, lse, do, dk, dv, window, dq=dq) <= 1
    unit = 2 * d * 2.0**-24 * (do.float() * o.float()).abs().sum(-1) + 1e-30
    assert float(((delta - fa.bwd_delta(o, do)).abs() / unit).max()) <= 1
    bad, _ = _emulate_dq(q, k, v, o, lse, do, window=window, q_offset=1)
    assert _bwd_reading(cs, q, k, v, o, lse, do, dk, dv, window, dq=bad) > 1
    bad, _ = _emulate_dq(q, k, v, o, lse.roll(1, -1), do, window=window)
    assert _bwd_reading(cs, q, k, v, o, lse, do, dk, dv, window, dq=bad) > 1


def test_dq_route_and_counters():
    """route() governs kernel 7c too; its wrapper counts tensor-core
    launches beside all launches, both zero on the CPU."""
    for dtype, want in ((torch.bfloat16, "tensor-core"), (torch.float32, "cuda-core")):
        assert fa.route(dtype, 64) == want
    q, k, v, do = _bf16_data(6, 2, 2, 64, s=16)
    o, lse = flash_attention_ref(q, k, v)
    fa.flash_attention_bwd_dq(q, k, v, o, lse, do)
    assert fa.flash_attention_bwd_dq.launches == fa.flash_attention_bwd_dq.tc_launches == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dq_delta_plumbing_on_cpu(dtype):
    """flash_attention_bwd_dq(return_delta=True) gives the plain dQ and
    bwd_delta's D_i on CPU tensors; flash_attention_bwd_dkdv with that
    delta equals the call without it; flash_attention_bwd equals the plain
    backward; a delta of the wrong shape or dtype raises."""
    q, k, v, do = (t.to(dtype) for t in _bf16_data(7, 4, 2, 64, s=48))
    o, lse = flash_attention_ref(q, k, v, window=16)
    want = flash_attention_bwd_ref(q, k, v, o, lse, do, window=16)
    dq, delta = fa.flash_attention_bwd_dq(q, k, v, o, lse, do, window=16,
                                          return_delta=True)
    assert torch.equal(dq, want[0]) and torch.equal(delta, fa.bwd_delta(o, do))
    assert torch.equal(fa.flash_attention_bwd_dq(q, k, v, o, lse, do, window=16), dq)
    got = fa.flash_attention_bwd_dkdv(q, k, v, o, lse, do, window=16, delta=delta)
    assert all(torch.equal(a, b) for a, b in
               zip(got, fa.flash_attention_bwd_dkdv(q, k, v, o, lse, do, window=16)))
    assert all(torch.equal(a, b) for a, b in
               zip(fa.flash_attention_bwd(q, k, v, o, lse, do, window=16), want))
    for bad in (delta[..., :-1], delta.double()):
        with pytest.raises(ValueError):
            fa.flash_attention_bwd_dkdv(q, k, v, o, lse, do, window=16, delta=bad)


MASKED_TILE = 64   # kernel 2's kv tile on the tensor-core route (MaskedTC::BKV)
MASKED_CASES = [  # b, sq, skv, starts, q_offset, d, window
    (3, 200, 200, (0, 70, 150), 0, 64, None),     # ragged; 150 is past a whole q tile
    (3, 200, 200, (0, 70, 150), 0, 128, 64),
    (1, 48, 200, (30,), 152, 128, None),          # chunked prefill: q_offset > 0
    (2, 64, 256, (100, 0), 192, 64, 96),
]
MASKED_IDS = [f"b{c[0]}q{c[1]}kv{c[2]}off{c[4]}d{c[5]}w{c[6]}" for c in MASKED_CASES]


def _emulate_masked(q, k, v, start, *, q_offset=0, window=None, tile=MASKED_TILE):
    """Kernel 2's bf16 route: online softmax over kv tiles of ``tile``
    columns with the causal / window / start mask; l sums the f32
    probabilities, the value product takes them rounded to bf16 relative
    to the running max after the tile; output O / l in bf16 (a row with
    no attended column: exact zeros)."""
    b, hq, sq, d = q.shape
    skv = k.shape[2]
    g = hq // k.shape[1]
    kf, vf = (t.float().repeat_interleave(g, 1) for t in (k, v))
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * d**-0.5
    band = _band(sq, skv, q_offset, True, window, q.device)[None] & (
        torch.arange(skv)[None, None, :] >= start[:, None, None])
    s = torch.where(band[:, None], s, -float("inf"))
    m = torch.full((b, hq, sq, 1), -float("inf"))
    l = torch.zeros((b, hq, sq, 1))
    acc = torch.zeros((b, hq, sq, d))
    for lo in range(0, skv, tile):
        st = s[..., lo:lo + tile]
        m_new = torch.maximum(m, st.amax(-1, keepdim=True))
        base = torch.where(m_new == -float("inf"), 0.0, m_new)
        p, alpha = torch.exp(st - base), torch.exp(m - base)
        l = alpha * l + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhqk,bhkd->bhqd", p.bfloat16().float(),
                                         vf[:, :, lo:lo + tile])
        m = m_new
    return (acc / torch.clamp_min(l, 1e-30)).bfloat16()


def _masked_data(seed, b, sq, skv, d, hq=4, hkv=2):
    rng = np.random.default_rng(seed)
    f = lambda *sh: torch.from_numpy(rng.standard_normal(sh).astype(np.float32))  # noqa: E731
    return f(b, hq, sq, d).bfloat16(), f(b, hkv, skv, d).bfloat16(), f(b, hkv, skv, d).bfloat16()


@pytest.mark.parametrize("b,sq,skv,starts,q_offset,d,window", MASKED_CASES, ids=MASKED_IDS)
def test_masked_rounding_within_the_chip_limit(cs, b, sq, skv, starts, q_offset, d, window):
    q, k, v = _masked_data(8, b, sq, skv, d)
    start = torch.tensor(starts, dtype=torch.int32)
    kw = dict(q_offset=q_offset, window=window)
    want = masked_attention_ref(q, k, v, start=start, **kw)
    att = masked_attention_ref(q.float(), k.float(), v.float().abs(), start=start, **kw)
    out = _emulate_masked(q, k, v, start, **kw)
    assert cs.excess(out, want, att, cs.TOL_BF16) <= 1
    # and against the JAX package's masked_attention_ref on the same bf16 values
    jax_want = np.asarray(jax_masked_attention_ref(
        *(jnp.asarray(t.numpy()) for t in (q.float(), k.float(), v.float())),
        start=jnp.asarray(start.numpy()), **kw))
    assert cs.excess(out, torch.from_numpy(np.array(jax_want)), att, cs.TOL_BF16) <= 1
    # pad queries (no attended column) are exact zeros, as in the plain version
    for i, st in enumerate(starts):
        pad = out[i, :, :max(0, st - q_offset)]
        assert torch.equal(pad, torch.zeros_like(pad))
        assert torch.equal(want[i, :, :max(0, st - q_offset)], pad.float())
    # the planted faults of the card's check read above the limit
    bad = _emulate_masked(q, k, v, start + 1, **kw)
    assert cs.excess(bad, want, att, cs.TOL_BF16) > 1
    if window:
        bad = _emulate_masked(q, k, v, start, q_offset=q_offset, window=window + 1)
        assert cs.excess(bad, want, att, cs.TOL_BF16) > 1


def test_aligned_edges_make_one_key_show(cs):
    """chip_smoke.py's ``align_edges`` (its ring-prefill case: G = 12, a
    chunk after a full window, a start inside it), at a small shape: the
    bf16 route's rounding stays within the card's limit, and one key more
    at each row's window edge or one less at its start reads above it."""
    hq, hkv, sq, skv, d, qo, window, st = 24, 2, 128, 640, 64, 512, 512, 37
    g = torch.Generator().manual_seed(5)
    q = torch.randn((1, hq, sq, d), generator=g)
    k, v = (torch.randn((1, hkv, skv, d), generator=g) for _ in range(2))
    cs.align_edges(q, k, st, qo, window)
    q, k, v = (t.bfloat16() for t in (q, k, v))
    start = torch.tensor([st], dtype=torch.int32)
    kw = dict(q_offset=qo, window=window)
    want = masked_attention_ref(q, k, v, start=start, **kw)
    att = masked_attention_ref(q.float(), k.float(), v.float().abs(), start=start, **kw)
    assert cs.excess(_emulate_masked(q, k, v, start, **kw), want, att, cs.TOL_BF16) <= 1
    for bad in (_emulate_masked(q, k, v, start + 1, **kw),
                _emulate_masked(q, k, v, start, q_offset=0, window=window),
                _emulate_masked(q, k, v, start, q_offset=qo, window=window + 1)):
        assert cs.excess(bad, want, att, cs.TOL_BF16) > 1


def test_masked_route_and_counters():
    """route() governs kernel 2 too; on CPU tensors its wrapper runs the
    plain version in q's dtype and counts no launch on either route."""
    for dtype, want in ((torch.bfloat16, "tensor-core"), (torch.float32, "cuda-core")):
        assert fa.route(dtype, 128) == want
    q, k, v = _masked_data(9, 2, 40, 40, 128)
    start = torch.tensor([0, 25], dtype=torch.int32)
    before = fa.flash_attention_masked.launches, fa.flash_attention_masked.tc_launches
    got = fa.flash_attention_masked(q, k, v, start)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, masked_attention_ref(q, k, v, start=start).bfloat16())
    assert (fa.flash_attention_masked.launches,
            fa.flash_attention_masked.tc_launches) == before
    with pytest.raises(TypeError):
        fa.route(torch.float16, 128)
