"""The split-K workspace of kernels 1, 4, 5 and 6 and of the paged decode
(``kernels/_build.stream_workspace``), and ``chip_smoke.py``'s checks of
it, on the CPU: one workspace per (device, CUDA stream[, kind]) key, grown
never shrunk, zeroed when made; the invariant every split call keeps (zero
words and tickets) read by ``check_workspace_zero``; and the three-way
reading of a failed exact matmul check (``diagnose_exact``: the kernel,
the card's reference and a CPU int64 product; where the wrong places
fall, and a wrong value read as one K split's partial sum missing or
counted twice) on planted wrong outputs."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.core.multiplier import ent_packed_planes  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.ent_matmul import ent_matmul as em  # noqa: E402
from repro_torch.kernels.ent_matmul.ops import row_scale  # noqa: E402
from repro_torch.kernels.ent_matmul.ref import (ent_packed_matmul_ref,  # noqa: E402
                                                quantize_with_scale)
from repro_torch.kernels.int8_matmul.ref import int8_matmul_int32_ref  # noqa: E402

SMS = 132
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def cs():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_split_k", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def workspaces(monkeypatch):
    table = {}
    monkeypatch.setattr(_build, "_workspaces", table)
    return table


# -- the workspace helper ---------------------------------------------------

REQUESTS = [[(100, 4), (50, 2), (200, 3), (10, 9), (200, 9)],
            [(16384, 32), (16384, 32), (65536, 172), (8, 1)],
            [(0, 0), (1, 1), (0, 5)]]


@pytest.mark.parametrize("requests", REQUESTS, ids=["mixed", "serving", "tiny"])
def test_workspace_keeps_what_was_asked_and_grows_only(workspaces, requests):
    """Each (device, stream) key has one workspace; it holds at least the
    most words and tickets asked for so far, is replaced only when a call
    needs more (zeroed when made), and is handed back as is otherwise."""
    key = (CPU, 0)
    most_w = most_t = 0
    prev = None
    for words, tickets in requests:
        ws, tk = _build.stream_workspace(key, words, tickets)
        most_w, most_t = max(most_w, words), max(most_t, tickets)
        assert ws.numel() == most_w and tk.numel() == most_t
        assert ws.dtype == tk.dtype == torch.int32
        grew = prev is not None and (words > prev[0].numel() or tickets > prev[1].numel())
        if prev is not None and not grew:
            assert ws is prev[0] and tk is prev[1]
        if prev is None or grew:
            assert not ws.any() and not tk.any()
        prev = ws, tk
        ws.fill_(7)   # a tensor handed back as is keeps what a call left in it
    assert list(workspaces) == [key]


def test_streams_devices_and_the_paged_kind_are_kept_apart(workspaces):
    meta = torch.device("meta")
    a = _build.stream_workspace((CPU, 0), 64, 4)
    b = _build.stream_workspace((CPU, 1), 64, 4)
    c = _build.stream_workspace((CPU, 0, "paged"), 64, 4)
    d = _build.stream_workspace((meta, 0), 64, 4)
    tensors = [t for pair in (a, b, c, d) for t in pair]
    assert len({id(t) for t in tensors}) == 8
    assert set(workspaces) == {(CPU, 0), (CPU, 1), (CPU, 0, "paged"), (meta, 0)}
    assert d[0].device == meta and a[0].device == CPU
    # growing one kind leaves the others
    _build.stream_workspace((CPU, 0, "paged"), 1000, 40)
    assert _build.stream_workspace((CPU, 0), 64, 4) == a


def test_the_wrappers_key_the_matmuls_and_the_paged_decode_apart(workspaces, monkeypatch):
    """Kernels 1 and 6 share the (device, stream) workspace; the paged
    decode keeps its own under the kind "paged"."""
    from repro_torch.kernels.int8_matmul import int8_matmul as im
    from repro_torch.kernels.paged_attention import paged_attention as pa
    meta = torch.device("meta")
    monkeypatch.setattr(_build, "entry", lambda name, fname=None: lambda *a: 0)
    monkeypatch.setattr(_build, "stream_of", lambda t: 5)
    monkeypatch.setitem(_build._sms, meta, SMS)
    e = lambda *s, dt=torch.int8: torch.empty(s, dtype=dt, device=meta)  # noqa: E731
    f32 = torch.float32
    em.ent_matmul_packed_fused(e(8, 2048, dt=torch.bfloat16), e(2, 2048, 2048), e(8, 1, dt=f32),
                               e(1, 2048, dt=f32))
    first = workspaces[(meta, 5)]
    im.int8_matmul(e(8, 2048), e(2048, 2048), e(8, 1, dt=f32), e(1, 2048, dt=f32))
    assert workspaces[(meta, 5)] == first   # the same shape: the same workspace
    q = e(8, 16, 1, 128, dt=torch.bfloat16)
    pool = e(8 * 36 + 1, 16, 2, 128, dt=torch.bfloat16)
    i32 = lambda *s: e(*s, dt=torch.int32)  # noqa: E731
    pa.paged_attention_kernel(q, pool, pool, i32(8, 36), i32(8), i32(8), page_size=16)
    assert set(workspaces) == {(meta, 5), (meta, 5, "paged")}


# -- chip_smoke.py's workspace invariant ------------------------------------

def test_check_workspace_zero_passes_on_zero_workspaces(cs, workspaces, capsys):
    _build.stream_workspace((CPU, 0), 128, 8)
    _build.stream_workspace((CPU, 0, "paged"), 128, 8)[0].fill_(3.0)   # partials: not read
    cs.check_workspace_zero(torch, "a phase")
    assert "cpu/0, cpu/0/paged all zero" in capsys.readouterr().out
    assert cs.workspace_state(torch) == {(CPU, 0): (0, 0), (CPU, 0, "paged"): (None, 0)}


@pytest.mark.parametrize("where,what", [((CPU, 0), 0), ((CPU, 0), 1), ((CPU, 0, "paged"), 1)])
def test_check_workspace_zero_names_a_left_word_or_ticket(cs, workspaces, where, what):
    _build.stream_workspace((CPU, 0), 128, 8)
    _build.stream_workspace((CPU, 0, "paged"), 128, 8)
    workspaces[where][what][3] = 5
    with pytest.raises(AssertionError, match="/".join(str(p) for p in where)):
        cs.check_workspace_zero(torch, "a phase")


# -- the three-way reading of a failed exact check --------------------------

def _operands(m, k, n, seed=0):
    g = torch.Generator().manual_seed(seed)
    w8 = torch.randint(-127, 128, (k, n), generator=g, dtype=torch.int8)
    x = torch.randn((m, k), generator=g).to(torch.bfloat16)
    sx = row_scale(x)
    sw = torch.rand((1, n), generator=g) * 1e-2 + 1e-4
    return x, sx, sw, w8, int8_matmul_int32_ref(quantize_with_scale(x, sx), w8)


def _split_partial(x, sx, w8, lo, hi):
    xq = quantize_with_scale(x, sx).long()
    return (xq[:, lo:hi] @ w8[lo:hi].long()).to(torch.int32)


@pytest.mark.parametrize("route", ["stream", "tc"])
def test_a_split_missing_reads_as_the_kernel_wrong(cs, workspaces, route):
    """A kernel output that lacks one K split's partial sums in some places
    is read as the kernel wrong there, the card's reference right, the
    places in the strips and chunks they lie in, and that split missing."""
    m, k, n = (8, 2048, 2048) if route == "stream" else (32, 2048, 2048)
    x, sx, sw, w8, acc = _operands(m, k, n)
    if route == "stream":
        _, kslice, splits, _ = em.stream_plan(m, n, k, SMS)
    else:
        kslice, splits, _ = em.tc_plan(m, n, k, SMS)
    assert splits > 2
    s = 2
    part = _split_partial(x, sx, w8, s * kslice, min((s + 1) * kslice, k))
    got = acc.clone()
    got[1:3, 70:90] -= part[1:3, 70:90]   # strips 1 (64..127): 40 places
    text = cs.diagnose_exact(torch, "planted", got, acc, x, sx, sw, w8, route, sms=SMS)
    wrong = int((got != acc).sum())
    assert f"{wrong} of {m * n} places differ" in text
    assert f"the kernel wrong at {wrong}, the card's reference wrong at 0, both wrong at 0" in text
    assert f"missing {{{s}: {wrong}}}, twice {{}}, neither 0" in text
    where = "64-column strips [1]" if route == "stream" else "128-column tiles [0]"
    assert where in text and "1 of 1 M chunks" in text
    assert "split workspaces after the call" in text


def test_a_wrong_reference_and_a_doubled_split_are_told_apart(cs, workspaces):
    m, k, n = 8, 2048, 2048
    x, sx, sw, w8, acc = _operands(m, k, n, seed=1)
    _, kslice, splits, _ = em.stream_plan(m, n, k, SMS)
    bad_ref = acc.clone()
    bad_ref[0, :10] += 1
    text = cs.diagnose_exact(torch, "ref", acc, bad_ref, x, sx, sw, w8, "stream", sms=SMS)
    assert "the kernel wrong at 0, the card's reference wrong at 10, both wrong at 0" in text
    twice = acc.clone()
    twice[7, 2000:] += _split_partial(x, sx, w8, 0, kslice)[7, 2000:]
    text = cs.diagnose_exact(torch, "twice", twice, acc, x, sx, sw, w8, "stream", sms=SMS)
    assert "missing {}, twice {0: 48}" in text


def test_float_outputs_are_recomputed_through_the_plain_epilogue(cs, workspaces):
    """For an f32 / bf16 output the CPU's int64 accumulator goes through
    the plain version's epilogue: a right kernel value equals it bit for
    bit, and ``assert_exact`` raises with the reading."""
    m, k, n = 8, 1000, 300
    x, sx, sw, w8, _ = _operands(m, k, n, seed=2)
    packed = ent_packed_planes(w8)
    for dt in (torch.float32, torch.bfloat16):
        want = ent_packed_matmul_ref(quantize_with_scale(x, sx), packed, sx, sw, dt)
        got = want.clone()
        got[3, 5] = -got[3, 5] + 1
        text = cs.diagnose_exact(torch, "float", got, want, x, sx, sw, w8, "stream", sms=SMS)
        assert "the kernel wrong at 1, the card's reference wrong at 0, both wrong at 0" in text
        assert "(3, 5, " in text
        with pytest.raises(AssertionError, match="the kernel wrong at 1"):
            cs.assert_exact(torch, "float", got, want, x, sx, sw, w8, "stream", sms=SMS)
        cs.assert_exact(torch, "float", want, want.clone(), x, sx, sw, w8, "stream", sms=SMS)


def test_int8_x_is_taken_as_it_is(cs, workspaces):
    """Kernels 4, 5 and 6 take int8 X: the CPU product uses it unquantized."""
    g = np.random.default_rng(3)
    xq = torch.from_numpy(g.integers(-127, 128, (4, 64), dtype=np.int8))
    w8 = torch.from_numpy(g.integers(-127, 128, (64, 48), dtype=np.int8))
    acc = int8_matmul_int32_ref(xq, w8)
    got = acc.clone()
    got[0, 0] += 3
    text = cs.diagnose_exact(torch, "int8", got, acc, xq, torch.ones((4, 1)), torch.ones((1, 48)),
                             w8, "stream", sms=SMS)
    assert "the kernel wrong at 1, the card's reference wrong at 0" in text
