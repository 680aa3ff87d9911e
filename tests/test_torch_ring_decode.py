"""The ring decode: the paged kernel's split-KV body in its ring form
(``csrc/paged_attention.cu``, C entry ``ring_decode_attention``), the
decode read of a sliding-window ring's pools as ``RingCache`` stores them,
``[B, W, Hkv, D]``, bf16 and int8 KV.  The parts that run on the CPU:

* the plan: ``ring_split_plan`` covers every ring row exactly once in
  runs of whole 32-row stages, gives at least two blocks an SM wherever W
  allows (the starcoder2-15b tick: 10 runs of 448 rows, 320 blocks) and
  caps a run at ``MAX_RING_ROWS``, from shapes alone;
* ``ring_decode_split_ref``, the kernel's per-split partials and their
  combine in split order in plain torch, held against the JAX package's
  ring read (``RingCache.token_view`` and ``masked_attention(valid=)``)
  on the same numpy inputs within ``chip_smoke.py``'s ``TOL_F32``, and
  against the port's plain version within ``TOL_BF16`` with bf16 q, in
  float and int8 KV, at G = 12 and G = 8: the seam inside a split, on a
  split's edge and at its start, pos < W - 1 (rows past the last live
  one, a wholly dead split), ``start`` inside the held range (two live
  runs around the seam), a full ring, one live row.  The planted faults
  of ``chip_smoke.py`` (fault 2: the ring read unrotated; the window off
  by one; fault 1: the last live split dropped) read above the limits;
* the plain version ``ring_decode_ref`` ≡ ``masked_attention_ref`` with
  ``token_view``'s mask over the ring's views, bit for bit, and reading
  unrotated differs;
* the wrapper, driven with ``meta`` tensors and a recorder in place of
  the built library: one launch a call handing the pools' own pointers,
  the plan and the shared workspace to the C entry, counted (int8-KV
  launches apart); it refuses Sq != 1, pools not ``[B, W, Hkv, D]``,
  float pools with scales and an unknown ``fault``;
* the route: on the kernel path's code (``attention.plain_path``
  patched, as ``tests/test_torch_ring.py`` does), ``_token_attention``
  hands ``cache.k`` / ``cache.v`` / their scale pools themselves to the
  ring decode (no transposed, contiguous or dequantized copy, no cast of
  an int8 ring), and its result equals the plain path's bit for bit.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.ops import masked_attention as jax_masked  # noqa: E402
from repro.models import kv_cache as ref_kv  # noqa: E402
from repro_torch.kernels.flash_attention.ref import masked_attention_ref  # noqa: E402
from repro_torch.kernels.paged_attention import ops as paged_ops  # noqa: E402
from repro_torch.kernels.paged_attention import paged_attention as pa  # noqa: E402
from repro_torch.kernels.paged_attention.ref import (  # noqa: E402
    ring_decode_ref, ring_decode_split_ref, unrotated_valid)
from repro_torch.models import attention, kv_cache  # noqa: E402

SMS = 132   # the H100's SMs
META = torch.device("meta")
W, ROWS = 128, 32     # the emulated ring and its runs: 4 splits
# slot: pos, start.  0: the seam inside split 1 (row 45); 1: the seam on
# split 0's last row; 2: the seam at split 2's first row; 3: pos < W - 1,
# rows 71.. dead (split 3 wholly); 4: start inside the held range, the
# live rows two runs around the seam (108..127 and 0..10); 5: a full ring
# before any wrap; 6: one live row; 7: several laps, start below the ring
CASES = ((3 * W + 45, 0), (W + 31, 0), (2 * W + 64, 0), (70, 0), (2 * W + 10, 2 * W - 20),
         (W - 1, 0), (0, 0), (9 * W + 77, 5))
# (Hq, Hkv, D): G = 12 and G = 8
GROUPS = [(24, 2, 64), (16, 2, 128)]
GROUP_IDS = [f"G{hq // hkv}-D{d}" for hq, hkv, d in GROUPS]


@pytest.fixture(scope="module")
def cs():
    """chip_smoke.py's limits, on the CPU."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_ring_limits", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.DEV = "cpu"
    return mod


# ---------------------------------------------------------------- the plan

PLAN_SHAPES = [(8, 4, 4096), (8, 2, 4096), (1, 1, 4096), (1, 8, 32768), (4, 2, 128),
               (2, 2, 8), (3, 1, 33), (64, 8, 4096), (200, 4, 4096), (1, 1, 1 << 20)]


@pytest.mark.parametrize("b,hkv,w", PLAN_SHAPES,
                         ids=[f"B{b}-Hkv{h}-W{w}" for b, h, w in PLAN_SHAPES])
def test_ring_split_plan_covers_every_row_once(b, hkv, w):
    rows, splits = pa.ring_split_plan(b, hkv, w, SMS)
    assert rows % pa.STAGE_ROWS == 0 and 0 < rows <= pa.MAX_RING_ROWS and splits >= 1
    seen = np.zeros(w, dtype=np.int64)
    for s in range(splits):
        lo, hi = s * rows, min((s + 1) * rows, w)
        assert lo < hi   # no split is empty of rows
        seen[lo:hi] += 1
    assert (seen == 1).all()
    # two blocks an SM wherever W allows: else runs of one stage, or one run
    assert b * hkv * splits >= 2 * SMS or rows == pa.STAGE_ROWS or splits == 1 \
        or rows == pa.MAX_RING_ROWS


def test_ring_split_plan_at_the_tick():
    """starcoder2-15b's tick (8 slots, 4 kv heads, a 4096-row ring): 10
    runs of 448 rows, 320 blocks on 132 SMs."""
    rows, splits = pa.ring_split_plan(8, 4, 4096, SMS)
    assert (rows, splits) == (448, 10) and 8 * 4 * splits >= 2 * SMS


@pytest.mark.parametrize("b,hkv,w", [(1, 1, 1 << 20), (1, 2, 1 << 19), (264, 1, 4096)],
                         ids=["B1-Hkv1-W1M", "B1-Hkv2-W512k", "B264-Hkv1-W4096"])
def test_ring_split_plan_caps_a_run(b, hkv, w):
    """A block keeps its run's int8 row scales in shared memory: no run
    holds more than MAX_RING_ROWS rows, however long the ring or however
    many slots fill the card alone."""
    rows, splits = pa.ring_split_plan(b, hkv, w, SMS)
    assert rows == pa.MAX_RING_ROWS and splits == -(-w // pa.MAX_RING_ROWS)
    assert pa.MAX_RING_ROWS == pa.MAX_RUN_PAGES * pa.MAX_PAGE


# ------------------------------------------- the split emulation vs references

def _case(seed, hq, hkv, d, int8):
    """numpy operands in the ring's stored layout: q [B, Hq, 1, D], pools
    [B, W, Hkv, D] (int8 codes with f32 scales [B, W, Hkv, 1]), pos and
    start from CASES."""
    rng = np.random.default_rng(seed)
    b = len(CASES)
    q = rng.standard_normal((b, hq, 1, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, W, hkv, d)).astype(np.float32) for _ in range(2))
    pos = np.asarray([p for p, _ in CASES], np.int32)
    start = np.asarray([s for _, s in CASES], np.int32)
    scales = ()
    if int8:
        k, v = (np.clip(np.round(t * 40), -127, 127).astype(np.int8) for t in (k, v))
        scales = tuple(rng.uniform(1e-3, 5e-2, (b, W, hkv, 1)).astype(np.float32)
                       for _ in range(2))
    return q, k, v, pos, start, scales


def _jax_ring_read(q, k, v, pos, start, scales, window):
    """The JAX package's ring decode read: ``RingCache.token_view``'s mask
    through ``masked_attention(valid=)`` (``models/attention.py:179-203``)."""
    sc = [jnp.asarray(torch.from_numpy(s).to(torch.bfloat16).float().numpy()).astype(
        jnp.bfloat16) for s in scales]
    ring = ref_kv.RingCache(k=jnp.asarray(k), v=jnp.asarray(v), k_s=sc[0] if sc else None,
                            v_s=sc[1] if sc else None, window=window)
    kop, vop, ks, vs, valid = ring.token_view(jnp.asarray(pos), jnp.asarray(start))
    if kop.dtype == jnp.int8:
        kop, vop = kop.astype(jnp.float32), vop.astype(jnp.float32)
    fold = lambda s: None if s is None else s[..., 0].transpose(0, 2, 1).astype(jnp.float32)  # noqa: E731
    out = jax_masked(jnp.asarray(q), kop.transpose(0, 2, 1, 3), vop.transpose(0, 2, 1, 3),
                     valid=valid[:, None, :], k_scale=fold(ks), v_scale=fold(vs))
    return torch.from_numpy(np.array(out))


def _torch_ops(q, k, v, pos, start, scales, dtype):
    t = torch.from_numpy
    pool = (lambda a: t(a)) if k.dtype == np.int8 else (lambda a: t(a).to(dtype))
    return (t(q).to(dtype), pool(k), pool(v), t(pos), t(start),
            *(t(s).to(torch.bfloat16) for s in scales))


@pytest.mark.parametrize("int8", [False, True], ids=["float-kv", "int8-kv"])
@pytest.mark.parametrize("hq,hkv,d", GROUPS, ids=GROUP_IDS)
def test_split_emulation_within_chip_smoke_limits(cs, hq, hkv, d, int8):
    q, k, v, pos, start, scales = _case(hq * 10 + d + int8, hq, hkv, d, int8)
    # float32 q: the emulation against the JAX reference's ring read, TOL_F32
    tq, tk, tv, tp, ts, *tsc = _torch_ops(q, k, v, pos, start, scales, torch.float32)
    want = _jax_ring_read(q, k, v, pos, start, scales, W)
    att = ring_decode_ref(tq, tk, tv.abs(), tp, ts, *tsc, window=W)
    got = ring_decode_split_ref(tq, tk, tv, tp, ts, *tsc, window=W, rows_per_split=ROWS)
    plain = ring_decode_ref(tq, tk, tv, tp, ts, *tsc, window=W)
    assert cs.excess(got, want, att, cs.TOL_F32) <= 1
    assert cs.excess(plain, want, att, cs.TOL_F32) <= 1
    faults = {"unrotated": dict(fault=2), "last split dropped": dict(fault=1),
              "window off by one": dict(window=W - 1)}
    for name, kw in faults.items():
        bad = ring_decode_split_ref(tq, tk, tv, tp, ts, *tsc, rows_per_split=ROWS,
                                    **{"window": W, **kw})
        assert cs.excess(bad, want, att, cs.TOL_F32) > 1, name
    # bf16 q: the emulation's per-split rounding against the plain version's
    bq, bk, bv, *_ = _torch_ops(q, k, v, pos, start, scales, torch.bfloat16)
    want16 = ring_decode_ref(bq, bk, bv, tp, ts, *tsc, window=W)
    got16 = ring_decode_split_ref(bq, bk, bv, tp, ts, *tsc, window=W, rows_per_split=ROWS)
    assert cs.excess(got16, want16, att, cs.TOL_BF16) <= 1
    for name, kw in faults.items():
        bad16 = ring_decode_split_ref(bq, bk, bv, tp, ts, *tsc, rows_per_split=ROWS,
                                      **{"window": W, **kw})
        assert cs.excess(bad16, want16, att, cs.TOL_BF16) > 1, name


@pytest.mark.parametrize("window", [W, 2 * W, 40], ids=["window-W", "window-2W", "window-40"])
def test_split_emulation_under_other_windows(cs, window):
    """A ring narrower than the window (max_len < window) and a window
    inside the ring: the emulation still reads what the reference reads."""
    q, k, v, pos, start, scales = _case(window, 24, 2, 64, False)
    tq, tk, tv, tp, ts = _torch_ops(q, k, v, pos, start, scales, torch.float32)
    want = _jax_ring_read(q, k, v, pos, start, scales, window)
    att = ring_decode_ref(tq, tk, tv.abs(), tp, ts, window=window)
    got = ring_decode_split_ref(tq, tk, tv, tp, ts, window=window, rows_per_split=ROWS)
    assert cs.excess(got, want, att, cs.TOL_F32) <= 1


def test_split_emulation_at_the_plan_of_the_tick(cs):
    """chip_smoke.py's ring check, on the CPU, split as the card's plan
    splits it (10 runs of 448 rows): within the limits in both dtypes and
    both pool kinds, and the three planted faults over them."""
    from repro_torch.models.kv_cache import quantize_kv
    g = torch.Generator().manual_seed(15)
    b, hq, hkv, d, w = 8, 48, 4, 128, cs.RING_W
    q = torch.randn((b, hq, 1, d), generator=g)
    k = torch.randn((b, w, hkv, d), generator=g)
    v = torch.randn((b, w, hkv, d), generator=g)
    k[0, (cs.RING_POS[0] + 1) % w] = q[0, :, 0].reshape(hkv, hq // hkv, d).sum(1)
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    pos = torch.tensor(cs.RING_POS, dtype=torch.int32)
    start = torch.tensor(cs.RING_START, dtype=torch.int32)
    rows, _ = pa.ring_split_plan(b, hkv, w, SMS)
    for int8 in (False, True):
        kp, vp, sc = k, v, ()
        if int8:
            (kp, ks), (vp, vs) = quantize_kv(k), quantize_kv(v)
            sc = (ks, vs)
        cast = (lambda t, dt: t) if int8 else (lambda t, dt: t.to(dt))   # noqa: E731
        att = ring_decode_ref(q.float(), cast(kp, torch.float32), cast(vp, torch.float32).abs(),
                              pos, start, *sc, window=w)
        for dt, tol in ((torch.bfloat16, cs.TOL_BF16), (torch.float32, cs.TOL_F32)):
            ops = (q.to(dt), cast(kp, dt), cast(vp, dt), pos, start, *sc)
            want = ring_decode_ref(*ops, window=w)
            got = ring_decode_split_ref(*ops, window=w, rows_per_split=rows)
            assert cs.excess(got, want, att, tol) <= 1, (int8, dt)
            for kw in (dict(fault=1), dict(fault=2), dict(window=w - 1)):
                bad = ring_decode_split_ref(*ops, rows_per_split=rows, **{"window": w, **kw})
                assert cs.excess(bad, want, att, tol) > 1, (int8, dt, kw)


# ------------------------------------------------------- the plain version

@pytest.mark.parametrize("int8", [False, True], ids=["float-kv", "int8-kv"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_plain_version_is_the_ring_cache_read(int8, dtype):
    """``ring_decode_ref`` ≡ ``masked_attention_ref`` with
    ``RingCache.token_view``'s mask over the ring's own views, int8 codes
    cast to q's dtype and their scales folded as the ring's CPU decode
    read folds them: bit for bit.  The unrotated read differs."""
    q, k, v, pos, start, scales = _case(7, 24, 2, 64, int8)
    tq, tk, tv, tp, ts, *tsc = _torch_ops(q, k, v, pos, start, scales, dtype)
    ring = kv_cache.RingCache(tk, tv, *tsc, window=W)
    kop, vop, ks, vs, valid = ring.token_view(tp, ts)
    if kop.dtype == torch.int8:
        kop, vop = kop.to(dtype), vop.to(dtype)
    fold = lambda s: None if s is None else s[..., 0].transpose(1, 2).float()  # noqa: E731
    want = masked_attention_ref(tq, kop.transpose(1, 2), vop.transpose(1, 2),
                                k_scale=fold(ks), v_scale=fold(vs), valid=valid[:, None, :])
    got = ring_decode_ref(tq, tk, tv, tp, ts, *tsc, window=W)
    assert got.dtype == torch.float32 and torch.equal(got, want)
    assert torch.equal(pa.ring_decode_kernel(tq, tk, tv, tp, ts, *tsc, window=W), want)
    assert torch.equal(paged_ops.ring_attention(tq, tk, tv, tp, ts, window=W, k_scales=ks,
                                                v_scales=vs, use_kernel=False), want)
    flat = masked_attention_ref(tq, kop.transpose(1, 2), vop.transpose(1, 2),
                                k_scale=fold(ks), v_scale=fold(vs),
                                valid=unrotated_valid(tp, ts, W, W)[:, None, :])
    assert not torch.allclose(flat, want)


def test_fault_is_refused_on_the_plain_version():
    q, k, v, pos, start, _ = _case(0, 16, 2, 128, False)
    args = _torch_ops(q, k, v, pos, start, (), torch.float32)
    for fault in (1, 2):
        with pytest.raises(ValueError, match="fault"):
            pa.ring_decode_kernel(*args, window=W, fault=fault)
    with pytest.raises(ValueError, match="fault"):
        ring_decode_split_ref(*args, window=W, rows_per_split=ROWS, fault=3)


# ------------------------------------------------ the wrapper's kernel branch

class _Recorder:
    def __init__(self):
        self.calls = []

    def entry(self, name, fname=None):
        def fn(*args):
            self.calls.append((name, fname, args))
            return 0
        return fn


class _Ptr(torch.Tensor):
    """A meta tensor that answers ``data_ptr`` with a given number."""

    def data_ptr(self):
        return self._ptr


def _meta(shape, dtype, ptr):
    t = torch.Tensor._make_subclass(_Ptr, torch.empty(shape, dtype=dtype, device=META))
    t._ptr = ptr
    return t


@pytest.fixture
def recorder(monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(pa._build, "entry", rec.entry)
    monkeypatch.setattr(pa._build, "stream_of", lambda t: 77)
    monkeypatch.setitem(pa._build._sms, META, SMS)
    monkeypatch.setattr(pa._build, "_workspaces", {})
    monkeypatch.setattr(pa.ring_decode_kernel, "launches", 0)
    monkeypatch.setattr(pa.ring_decode_kernel, "int8_kv_launches", 0)
    return rec


def _operands(b=8, hq=48, hkv=4, w=4096, d=128, int8=False, qdt=torch.bfloat16):
    pool = torch.int8 if int8 else qdt
    ops = dict(q=_meta((b, hq, 1, d), qdt, 1000), k=_meta((b, w, hkv, d), pool, 2000),
               v=_meta((b, w, hkv, d), pool, 3000), pos=_meta((b,), torch.int32, 4000),
               start=_meta((b,), torch.int32, 5000))
    if int8:
        ops.update(ks=_meta((b, w, hkv, 1), torch.bfloat16, 6000),
                   vs=_meta((b, w, hkv, 1), torch.bfloat16, 7000))
    return ops


def _call(ops, **kw):
    return pa.ring_decode_kernel(ops["q"], ops["k"], ops["v"], ops["pos"], ops["start"],
                                 ops.get("ks"), ops.get("vs"), **{"window": 4096, **kw})


@pytest.mark.parametrize("int8", [False, True], ids=["bf16-kv", "int8-kv"])
def test_wrapper_hands_the_pools_to_the_kernel_once(recorder, int8):
    f = pa.ring_decode_kernel
    ops = _operands(int8=int8)
    out = _call(ops)
    assert out.shape == (8, 48, 1, 128) and out.dtype == torch.float32
    ((name, fname, args),) = recorder.calls
    assert (name, fname) == ("paged_attention", "ring_decode_attention")
    assert len(args) == len(pa._build.ENTRY_POINTS[name][fname])
    # q, the pools and their scales as stored (their own pointers), pos, start
    assert args[:7] == (1000, 2000, 3000, 6000 if int8 else None, 7000 if int8 else None,
                        4000, 5000)
    # is_bf16, kv_int8, B, Hq, Hkv, W, D, rows a split, splits, window
    assert args[12:22] == (1, int(int8), 8, 48, 4, 4096, 128, 448, 10, 4096)
    assert args[22] == pytest.approx(128**-0.5) and args[23:] == (0, 77)
    # kernel 3's workspace of this stream: f32 partials, a ticket a (slot, kv head)
    ws, tk = pa._build._workspaces[(META, 77, "paged")]
    assert ws.numel() >= 8 * 4 * 10 * 12 * (128 + 2) and tk.numel() >= 8 * 4
    assert (args[9], args[11]) == (ws.numel(), tk.numel())
    assert (f.launches, f.int8_kv_launches) == (1, int(int8))
    _call(ops, window=None)
    assert recorder.calls[1][2][21] == 0 and f.launches == 2
    assert pa._build._workspaces[(META, 77, "paged")][0] is ws


def test_wrapper_shares_kernel_3s_workspace(recorder, monkeypatch):
    """The ring decode and the paged decode on one stream take one
    workspace (each leaves its tickets zero); a call that needs more grows
    it for both."""
    monkeypatch.setattr(pa.paged_attention_kernel, "launches", 0)
    e = lambda shape, dt: torch.empty(shape, dtype=dt, device=META)   # noqa: E731
    pa.paged_attention_kernel(e((8, 16, 1, 128), torch.bfloat16),
                              e((8 * 36 + 1, 16, 2, 128), torch.bfloat16),
                              e((8 * 36 + 1, 16, 2, 128), torch.bfloat16),
                              e((8, 36), torch.int32), e((8,), torch.int32),
                              e((8,), torch.int32), page_size=16)
    small = pa._build._workspaces[(META, 77, "paged")][0]
    _call(_operands())
    big, tk = pa._build._workspaces[(META, 77, "paged")]
    assert big is not small and big.numel() >= 8 * 4 * 10 * 12 * 130 and tk.numel() >= 32
    assert [c[1] for c in recorder.calls] == ["paged_attention", "ring_decode_attention"]


def test_wrapper_one_split_needs_no_workspace(recorder):
    """A ring of one stage (or enough slots to fill the card alone at one
    run) is one split: no workspace is handed over."""
    _call(_operands(w=32))
    _call(_operands(b=200, hkv=4, w=256, qdt=torch.float32))
    for _, _, args in recorder.calls:
        assert args[20] == 1 and args[8:12] == (None, 0, None, 0)
    assert recorder.calls[1][2][12] == 0   # float32 q: the CUDA-core route
    assert pa._build._workspaces == {}


def test_wrapper_reads_nothing_on_the_host(recorder):
    """pos and start stay on the device: the plan comes from shapes, and a
    meta tensor would raise on any read of its values."""
    with pytest.raises(Exception):
        torch.empty((8,), dtype=torch.int32, device=META).tolist()
    _call(_operands(int8=True))
    assert len(recorder.calls) == 1


def test_wrapper_refuses_what_the_form_does_not_take(recorder):
    ops = _operands()
    bad = {
        "Sq != 1": dict(ops, q=_meta((8, 48, 5, 128), torch.bfloat16, 1)),
        "[B, Hkv, W, D] pools": dict(ops, k=_meta((8, 4, 4096, 128), torch.bfloat16, 2),
                                     v=_meta((8, 4, 4096, 128), torch.bfloat16, 3)),
        "B != the pools'": dict(ops, k=_meta((4, 4096, 4, 128), torch.bfloat16, 2),
                                v=_meta((4, 4096, 4, 128), torch.bfloat16, 3)),
        "K and V apart": dict(ops, v=_meta((8, 2048, 4, 128), torch.bfloat16, 3)),
        "pos not int32 [B]": dict(ops, pos=_meta((8,), torch.int64, 4)),
        "start not [B]": dict(ops, start=_meta((4,), torch.int32, 5)),
    }
    for name, o in bad.items():
        with pytest.raises(ValueError):
            _call(o)
    with pytest.raises(NotImplementedError, match="float pools with scales"):
        _call(dict(ops, ks=_meta((8, 4096, 4, 1), torch.bfloat16, 6),
                   vs=_meta((8, 4096, 4, 1), torch.bfloat16, 7)))
    i8 = _operands(int8=True)
    with pytest.raises(ValueError, match="scale pools"):
        _call(dict(i8, ks=_meta((8, 4096, 4, 1), torch.float32, 6)))
    with pytest.raises(ValueError, match="scale pools"):
        _call(dict(i8, vs=None))
    for fault in (3, -1):
        with pytest.raises(ValueError, match="fault"):
            _call(ops, fault=fault)
    assert recorder.calls == []
    for fault in (1, 2):   # the planted faults reach the C entry
        _call(ops, fault=fault)
    assert [c[2][23] for c in recorder.calls] == [1, 2]


# --------------------------------------------------------------- the route

@pytest.mark.parametrize("quantized", [False, True], ids=["float-kv", "int8-kv"])
def test_token_attention_hands_the_ring_as_stored(monkeypatch, quantized):
    """On the kernel path's code, the decode read hands the ring's pools
    and scale pools themselves to the ring decode: no transposed,
    contiguous or dequantized copy, no cast of an int8 ring; the result is
    the plain path's, bit for bit."""
    from repro_torch.configs import get_config, reduced_config
    cfg = reduced_config(get_config("starcoder2-15b"))
    rng = np.random.default_rng(3)
    b, w, hkv, hd = 3, 8, cfg.num_kv_heads, cfg.head_dim
    ring = kv_cache.ring_init(b, w, hkv, hd, torch.float32, window=w, quantized=quantized)
    for t in range(13):   # write 13 positions: the ring wraps
        k, v = (torch.from_numpy(rng.standard_normal((b, 1, hkv, hd)).astype(np.float32))
                for _ in range(2))
        ring.write_token(k, v, torch.full((b,), t, dtype=torch.int32), per_seq=True)
    q = torch.from_numpy(rng.standard_normal((b, cfg.num_heads, 1, hd)).astype(np.float32))
    pos = torch.tensor([12, 12, 12], dtype=torch.int32)
    start = torch.tensor([0, 6, 11], dtype=torch.int32)
    want = attention._token_attention(cfg, q, ring, pos, start, use_kernel=True)   # plain
    seen = []

    def spy(q_, k_, v_, pos_, start_, k_s=None, v_s=None, **kw):
        seen.append((k_, v_, k_s, v_s, kw))
        return ring_decode_ref(q_, k_, v_, pos_, start_, k_s, v_s, **kw)

    monkeypatch.setattr(attention, "plain_path", lambda x, use_kernel: not use_kernel)
    monkeypatch.setattr(paged_ops, "ring_decode_kernel", spy)
    got = attention._token_attention(cfg, q, ring, pos, start, use_kernel=True)
    ((k_, v_, ks, vs, kw),) = seen
    assert k_ is ring.k and v_ is ring.v and ks is ring.k_s and vs is ring.v_s
    assert k_.dtype == (torch.int8 if quantized else torch.float32)
    assert kw["window"] == w
    assert torch.equal(got, want)
