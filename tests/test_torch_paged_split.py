"""Kernels 3 and 3b (paged decode, bf16 and int8 KV) in their split-KV
form, the parts that run on the CPU.

The CUDA kernel (``csrc/paged_attention.cu``) cuts each (slot, kv head)'s
table row into runs of pages (``split_plan``), forms each run's partial
with its probabilities rounded to q's dtype against its own running max,
and combines the partials in split order in the same launch.  Here:

* the plan covers every table column exactly once and gives at least two
  blocks an SM at the serving tick's shape and at long context;
* ``paged_attention_split_ref``, the split's rounding and the fixed-order
  combine in plain torch, is held against the port's plain version and
  the JAX package's reference (and the Pallas kernel in interpret mode)
  on the same numpy inputs, with ``chip_smoke.py``'s own limits
  (``TOL_BF16`` with bf16 q, ``TOL_F32`` with float32 q, in att|v|
  units), at G = 1, 7, 8, 12 and 16, D = 64 and 128, pages of 4 and 16,
  float and int8 pools: ragged pos and start, a null page inside a live
  range, a split that is wholly null, pos on a split boundary, and an
  idle slot, which gives exact zeros.  The planted fault of
  ``chip_smoke.py`` (the combine drops the last live split) reads above
  the limit;
* the wrapper's kernel branch, driven with ``meta`` tensors and a
  recorder in place of the built library: one launch a call with the plan
  and the cached workspace, no host read of pos, start or the table (a
  meta tensor has no values to read), and a non-zero ``fault`` refused on
  the plain version.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels.paged_attention.paged_attention import (  # noqa: E402
    paged_attention_kernel as pallas_paged)
from repro.kernels.paged_attention.ref import paged_attention_ref as jax_paged_ref  # noqa: E402
from repro_torch.kernels.paged_attention import paged_attention as pa  # noqa: E402
from repro_torch.kernels.paged_attention.ref import (  # noqa: E402
    paged_attention_ref, paged_attention_split_ref)

SMS = 132   # the H100's SMs
META = torch.device("meta")
# (Hq, Hkv, D, page): G = 1, 7, 8, 12, 16
GROUPS = [(2, 2, 64, 4), (14, 2, 128, 16), (16, 2, 128, 16), (24, 2, 64, 4), (16, 1, 64, 4)]
GROUP_IDS = [f"G{hq // hkv}-D{d}-page{page}" for hq, hkv, d, page in GROUPS]
B, PPS = 4, 12


@pytest.fixture(scope="module")
def cs():
    """chip_smoke.py's limits, on the CPU."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_limits", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.DEV = "cpu"
    return mod


# ---------------------------------------------------------------- the plan

PLAN_SHAPES = [(8, 2, 36), (8, 2, 256), (4, 2, 16), (1, 1, 527), (1, 1, 4096), (64, 8, 36),
               (3, 2, 1), (8, 2, 0), (200, 2, 36), (33, 8, 1700), (64, 8, 8192)]


@pytest.mark.parametrize("b,hkv,pps", PLAN_SHAPES,
                         ids=[f"B{b}-Hkv{h}-pps{p}" for b, h, p in PLAN_SHAPES])
def test_split_plan_covers_every_column_once(b, hkv, pps):
    pages, splits = pa.split_plan(b, hkv, pps, SMS)
    assert pages >= 1 and splits >= 1
    seen = np.zeros(pps, dtype=np.int64)
    for s in range(splits):
        lo, hi = s * pages, min((s + 1) * pages, pps)
        assert lo < hi or pps == 0   # no split is empty of pages
        seen[lo:hi] += 1
    assert (seen == 1).all()
    # as many blocks as 2 an SM wherever the table allows: else one page a split
    assert b * hkv * splits >= 2 * SMS or pages == 1 or splits == 1


@pytest.mark.parametrize("pps", [36, 256])
def test_split_plan_gives_two_blocks_an_sm(pps):
    """The serving tick (8 slots, 2 kv heads, 36 pages of 16) and long
    context (4096 tokens a slot): 18 splits, 288 blocks."""
    pages, splits = pa.split_plan(8, 2, pps, SMS)
    assert 8 * 2 * splits >= 2 * SMS
    assert (pages, splits) == ((2, 18) if pps == 36 else (15, 18))


@pytest.mark.parametrize("b,hkv,pps", [(33, 8, 1700), (64, 8, 8192), (1, 1, 100_000)],
                         ids=["B33-Hkv8-pps1700", "B64-Hkv8-pps8192", "B1-Hkv1-pps100000"])
def test_split_plan_caps_a_run(b, hkv, pps):
    """Where the slots and kv heads fill the card alone (B Hkv >= 2 SMs) or
    the table is long, no split holds more than MAX_RUN_PAGES pages: a
    block keeps its run's table entries and int8 row scales in shared
    memory, which would outgrow the SM at tens of thousands of tokens."""
    pages, splits = pa.split_plan(b, hkv, pps, SMS)
    assert pages == pa.MAX_RUN_PAGES and splits == -(-pps // pa.MAX_RUN_PAGES)


# ------------------------------------------- the split emulation vs references

def _case(seed, hq, hkv, d, page, pps_split, int8):
    """numpy operands: slot 0's pos on the first column of split 3 with a
    null page inside its range, slot 1 ragged at both ends with every page
    of split 2 null, slot 2 a few columns, slot 3 idle."""
    rng = np.random.default_rng(seed)
    npool = B * PPS + 1
    width = pps_split * page
    q = rng.standard_normal((B, hq, 1, d)).astype(np.float32)
    kp, vp = (rng.standard_normal((npool, page, hkv, d)).astype(np.float32) for _ in range(2))
    pos = np.asarray([3 * width, PPS * page - 1, 5, 0], np.int32)
    start = np.asarray([0, page + 1, 2, 0], np.int32)
    table = np.zeros((B, PPS), np.int32)
    perm = rng.permutation(npool - 1) + 1
    for i in range(B - 1):
        live = min(PPS, int(pos[i]) // page + 1)
        table[i, :live] = perm[i * PPS:i * PPS + live]
    table[0, 1] = 0
    table[1, 2 * pps_split:3 * pps_split] = 0
    scales = ()
    if int8:
        kp, vp = (np.clip(np.round(t * 40), -127, 127).astype(np.int8) for t in (kp, vp))
        scales = tuple(rng.uniform(1e-3, 5e-2, (npool, page, hkv, 1)).astype(np.float32)
                       for _ in range(2))
    return q, kp, vp, table, pos, start, scales


def _torch_ops(q, kp, vp, table, pos, start, scales, dtype):
    t = torch.from_numpy
    pool = (lambda a: t(a)) if kp.dtype == np.int8 else (lambda a: t(a).to(dtype))
    sc = tuple(t(s).to(torch.bfloat16) for s in scales)
    return (t(q).to(dtype), pool(kp), pool(vp), t(table), t(pos), t(start)), sc


@pytest.mark.parametrize("int8", [False, True], ids=["float-kv", "int8-kv"])
@pytest.mark.parametrize("pps_split", [1, 2, 3])
@pytest.mark.parametrize("hq,hkv,d,page", GROUPS, ids=GROUP_IDS)
def test_split_emulation_within_chip_smoke_limits(cs, hq, hkv, d, page, pps_split, int8):
    q, kp, vp, table, pos, start, scales = _case(hq * 100 + d + page, hq, hkv, d, page,
                                                 pps_split, int8)
    # float32 q: the emulation against the JAX reference, TOL_F32
    (tq, tk, tv, tt, tp, ts), tsc = _torch_ops(q, kp, vp, table, pos, start, scales,
                                               torch.float32)
    kw = dict(page_size=page)
    if int8:
        kw.update(k_scales=tsc[0], v_scales=tsc[1])
        jkw = dict(k_scales=jnp.asarray(tsc[0].float().numpy()).astype(jnp.bfloat16),
                   v_scales=jnp.asarray(tsc[1].float().numpy()).astype(jnp.bfloat16))
    else:
        jkw = {}
    jargs = tuple(map(jnp.asarray, (q, kp, vp, table, pos, start)))
    want = torch.from_numpy(np.array(jax_paged_ref(*jargs, page_size=page, **jkw)))
    plain = paged_attention_ref(tq, tk, tv, tt, tp, ts, **kw)
    att = paged_attention_ref(tq, tk, tv.abs(), tt, tp, ts, **kw)
    got = paged_attention_split_ref(tq, tk, tv, tt, tp, ts, pages_per_split=pps_split, **kw)
    assert cs.excess(got, want, att, cs.TOL_F32) <= 1
    assert cs.excess(plain, want, att, cs.TOL_F32) <= 1
    assert not got[3].any() and not want[3].any()          # the idle slot: exact zeros
    if pps_split == 1:
        pallas = np.array(pallas_paged(*jargs, *jkw.values(), page_size=page, interpret=True))
        assert cs.excess(got, torch.from_numpy(pallas), att, cs.TOL_F32) <= 1
    # the planted fault: the combine drops each row's last live split
    bad = paged_attention_split_ref(tq, tk, tv, tt, tp, ts, pages_per_split=pps_split,
                                    fault=1, **kw)
    assert cs.excess(bad, want, att, cs.TOL_F32) > 1
    # bf16 q: the emulation's per-split rounding against the plain version's
    (bq, bk, bv, *_), _ = _torch_ops(q, kp, vp, table, pos, start, scales, torch.bfloat16)
    want16 = paged_attention_ref(bq, bk, bv, tt, tp, ts, **kw)
    got16 = paged_attention_split_ref(bq, bk, bv, tt, tp, ts, pages_per_split=pps_split, **kw)
    assert cs.excess(got16, want16, att, cs.TOL_BF16) <= 1
    assert not got16[3].any()
    bad16 = paged_attention_split_ref(bq, bk, bv, tt, tp, ts, pages_per_split=pps_split,
                                      fault=1, **kw)
    assert cs.excess(bad16, want16, att, cs.TOL_BF16) > 1


def test_split_emulation_at_the_plan_of_the_tick(cs):
    """chip_smoke.py's tick case, on the CPU, split as the card's plan
    splits it: within the limits in both dtypes and both pool kinds."""
    for int8 in (False, True):
        q, kp, vp, table, pos, start, scales = cs.paged_case(torch, cs.PAGED_CASES["tick"], int8)
        pages, _ = pa.split_plan(8, 2, table.shape[1], SMS)
        kw = dict(page_size=kp.shape[1], k_scales=scales[0] if int8 else None,
                  v_scales=scales[1] if int8 else None)
        cast = (lambda t, dt: t) if int8 else (lambda t, dt: t.to(dt))   # noqa: E731
        att = paged_attention_ref(q.float(), cast(kp, torch.float32),
                                  cast(vp, torch.float32).abs(), table, pos, start, **kw)
        for dt, tol in ((torch.bfloat16, cs.TOL_BF16), (torch.float32, cs.TOL_F32)):
            ops = (q.to(dt), cast(kp, dt), cast(vp, dt), table, pos, start)
            got = paged_attention_split_ref(*ops, pages_per_split=pages, **kw)
            assert cs.excess(got, paged_attention_ref(*ops, **kw), att, tol) <= 1, (int8, dt)


# ------------------------------------------------ the wrapper's kernel branch

class _Recorder:
    def __init__(self):
        self.calls = []

    def entry(self, name, fname=None):
        def fn(*args):
            self.calls.append((name, fname, args))
            return 0
        return fn


@pytest.fixture
def recorder(monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(pa._build, "entry", rec.entry)
    monkeypatch.setattr(pa._build, "stream_of", lambda t: 0)
    monkeypatch.setitem(pa._build._sms, META, SMS)
    monkeypatch.setattr(pa._build, "_workspaces", {})
    monkeypatch.setattr(pa.paged_attention_kernel, "launches", 0)
    monkeypatch.setattr(pa.paged_attention_kernel, "int8_kv_launches", 0)
    return rec


def _meta_call(b=8, hq=16, hkv=2, d=128, page=16, pps=36, int8=False, qdt=torch.bfloat16,
               **kw):
    e = lambda shape, dt: torch.empty(shape, dtype=dt, device=META)   # noqa: E731
    pool = torch.int8 if int8 else qdt
    scales = (e((b * pps + 1, page, hkv, 1), torch.bfloat16),) * 2 if int8 else ()
    return pa.paged_attention_kernel(
        e((b, hq, 1, d), qdt), e((b * pps + 1, page, hkv, d), pool),
        e((b * pps + 1, page, hkv, d), pool), e((b, pps), torch.int32), e((b,), torch.int32),
        e((b,), torch.int32), *scales, page_size=page, **kw)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16-kv", "int8-kv"])
def test_wrapper_launches_once_with_plan_and_workspace(recorder, int8):
    f = pa.paged_attention_kernel
    out = _meta_call(int8=int8)
    assert out.shape == (8, 16, 1, 128) and out.dtype == torch.float32
    ((name, fname, args),) = recorder.calls
    assert (name, fname) == ("paged_attention", "paged_attention")
    assert (f.launches, f.int8_kv_launches) == (1, int(int8))
    # is_bf16, kv_int8, B, Hq, Hkv, pps, page, D, pages a split, splits
    assert args[13:23] == (1, int(int8), 8, 16, 2, 36, 16, 128, 2, 18)
    assert args[23] == pytest.approx(128**-0.5) and args[24:] == (0, 0)
    ws, tk = pa._build._workspaces[(META, 0, "paged")]
    assert ws.numel() >= 8 * 2 * 18 * 8 * (128 + 2) and tk.numel() >= 8 * 2
    assert (args[10], args[12]) == (ws.numel(), tk.numel())
    # a second call: one more launch, the same workspace, no allocation but out
    _meta_call(int8=int8)
    assert len(recorder.calls) == 2 and f.launches == 2
    assert pa._build._workspaces[(META, 0, "paged")][0] is ws
    # the matmuls' workspace of the same stream is another one
    assert (META, 0) not in pa._build._workspaces


def test_wrapper_one_split_needs_no_workspace(recorder):
    """A table of one page (or enough slots to fill the card alone) is one
    split: the block writes out itself, and no workspace is handed over."""
    _meta_call(pps=1)
    _meta_call(b=200, qdt=torch.float32)
    for _, _, args in recorder.calls:
        assert args[22] == 1 and args[9:13] == (None, 0, None, 0)
    assert recorder.calls[1][2][13] == 0   # float32 q: the CUDA-core route
    assert pa._build._workspaces == {}


@pytest.mark.parametrize("int8", [False, True], ids=["bf16-kv", "int8-kv"])
def test_wrapper_caps_a_run_where_the_slots_fill_the_card(recorder, int8):
    """qwen2-72b's 8 kv heads at 33 slots of 54,400 tokens (chip_smoke.py's
    wide case): the plan hands over runs of MAX_RUN_PAGES pages and a
    workspace for all of their partials."""
    _meta_call(b=33, hq=64, hkv=8, d=128, page=32, pps=1700, int8=int8)
    ((_, _, args),) = recorder.calls
    splits = -(-1700 // pa.MAX_RUN_PAGES)
    assert args[13:23] == (1, int(int8), 33, 64, 8, 1700, 32, 128, pa.MAX_RUN_PAGES, splits)
    assert args[10] >= 33 * 8 * splits * 8 * (128 + 2) and args[12] >= 33 * 8


def test_wrapper_reads_nothing_on_the_host(recorder):
    """pos, start and the table stay on the device: the plan comes from
    shapes, and a meta tensor would raise on any read of its values."""
    t = torch.empty((8,), dtype=torch.int32, device=META)
    with pytest.raises(Exception):
        t.item()
    with pytest.raises(Exception):
        t.tolist()
    _meta_call()
    assert len(recorder.calls) == 1


def test_fault_is_refused_on_the_plain_version():
    q, kp, vp, table, pos, start, _ = _case(0, 4, 2, 64, 4, 1, False)
    args = [torch.from_numpy(a) for a in (q, kp, vp, table, pos, start)]
    with pytest.raises(ValueError):
        pa.paged_attention_kernel(*args, page_size=4, fault=1)
    with pytest.raises(ValueError):
        pa.paged_attention_kernel(*args, page_size=4, fault=2)
    with pytest.raises(ValueError):
        paged_attention_split_ref(*args, page_size=4, pages_per_split=1, fault=2)
    # fault 0 is the plain version itself
    got = pa.paged_attention_kernel(*args, page_size=4, fault=0)
    assert torch.equal(got, paged_attention_ref(*args, page_size=4))


def test_fault_is_refused_for_an_unknown_value_on_the_card_branch(recorder):
    with pytest.raises(ValueError):
        _meta_call(fault=3)
    assert recorder.calls == []
    _meta_call(fault=1)
    assert recorder.calls[0][2][24] == 1
