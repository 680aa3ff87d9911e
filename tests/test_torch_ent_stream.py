"""Kernel 1's two routes, the split-K weight stream (``csrc/int8_stream.cuh``)
and the int8 tensor-core loop (``csrc/int8_tc.cuh``), the parts that run on
the CPU: their launch plans (``stream_plan``, ``tc_plan``), the wrapper's
choice of route by M, the plain version that CPU tensors take, and the
operand checks.  The kernels themselves run only on the card, where
``chip_smoke.py`` holds them bit for bit against the plain version.

The route test drives the wrapper with ``meta`` tensors (not CPU, so the
wrapper takes its kernel branch) and a recorder in place of the built
library: it sees which C entry point the wrapper calls, with which plan,
and whether it hands over a workspace."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.core import multiplier as ref_mult  # noqa: E402
from repro.kernels.ent_matmul import ref as ref_ent  # noqa: E402
from repro_torch.core.multiplier import PACKED_MAX_K  # noqa: E402
from repro_torch.kernels.ent_matmul import ent_matmul as em  # noqa: E402
from repro_torch.kernels.ent_matmul import ops  # noqa: E402

SMS = 132   # the H100's SMs
QWEN = [(2048, 2048), (2048, 256), (2048, 11008), (11008, 2048)]   # K -> N
SHAPES = QWEN + [(1000, 300), (16, 7), (5, 64), (20000, 64)]


def _slices(k, kslice, splits):
    return [(i * kslice, min((i + 1) * kslice, k)) for i in range(splits)]


@pytest.mark.parametrize("k,n", SHAPES, ids=[f"{k}x{n}" for k, n in SHAPES])
def test_plan_covers_every_k_once(k, n):
    for m in (1, 3, 5, 8, 16, 32, 33, 64, 100):
        mb, kslice, splits, (strips, gsplits, chunks) = em.stream_plan(m, n, k, SMS)
        assert gsplits == splits and mb in em.STREAM_MB and mb >= min(m, em.STREAM_MB[-1])
        assert chunks * mb >= m > (chunks - 1) * mb
        assert strips * em.STREAM_BN >= n > (strips - 1) * em.STREAM_BN
        # K slices: multiples of the 16-row step, none empty, every k exactly once
        assert kslice % em.STREAM_KSTEP == 0 and 0 < kslice <= em.STREAM_KSLICE_MAX
        seen = np.zeros(k, dtype=np.int64)
        for lo, hi in _slices(k, kslice, splits):
            assert lo < hi
            seen[lo:hi] += 1
        assert (seen == 1).all(), m


@pytest.mark.parametrize("k,n", QWEN, ids=[f"{k}x{n}" for k, n in QWEN])
def test_plan_gives_two_blocks_per_sm(k, n):
    for m in range(1, em.M_STREAM + 1):
        _, _, _, grid = em.stream_plan(m, n, k, SMS)
        assert int(np.prod(grid)) >= 2 * SMS, (m, grid)


class _Recorder:
    def __init__(self):
        self.calls = []

    def entry(self, name, fname=None):
        def fn(*args):
            self.calls.append((fname, args))
            return 0
        return fn


@pytest.fixture
def recorder(monkeypatch):
    rec = _Recorder()
    meta = torch.device("meta")
    monkeypatch.setattr(em._build, "entry", rec.entry)
    monkeypatch.setattr(em._build, "stream_of", lambda t: 0)
    monkeypatch.setitem(em._build._sms, meta, SMS)
    monkeypatch.setattr(em._build, "_workspaces", {})
    for name in ("launches", "stream_launches", "tc_launches"):
        monkeypatch.setattr(em.ent_matmul_packed_fused, name, 0)
    return rec


def _meta_operands(m, k, n):
    meta = torch.device("meta")
    return (torch.empty((m, k), dtype=torch.bfloat16, device=meta),
            torch.empty((2, k, n), dtype=torch.int8, device=meta),
            torch.empty((m, 1), dtype=torch.float32, device=meta),
            torch.empty((1, n), dtype=torch.float32, device=meta))


@pytest.mark.parametrize("m", [1, 8, 16, em.M_STREAM, em.M_STREAM + 1, 512])
def test_wrapper_routes_decode_rows_to_the_stream(recorder, m):
    f = em.ent_matmul_packed_fused
    for k, n in QWEN + [(1000, 300)]:
        recorder.calls.clear()
        before = f.launches, f.stream_launches, f.tc_launches
        out = f(*_meta_operands(m, k, n), torch.bfloat16)
        assert out.shape == (m, n) and out.dtype == torch.bfloat16
        (fname, args), = recorder.calls
        assert f.launches == before[0] + 1
        assert args[6] == em.OUT_KINDS[torch.bfloat16]
        if m <= em.M_STREAM:
            assert fname == "ent_matmul_packed_fused_stream"
            assert (f.stream_launches, f.tc_launches) == (before[1] + 1, before[2])
            mb, kslice, splits, (strips, _, chunks) = em.stream_plan(m, n, k, SMS)
            assert args[11:17] == (m, n, k, mb, kslice, splits)
            tickets = strips * chunks
        else:   # prefill sizes of M: the tensor-core loop
            assert fname == "ent_matmul_packed_fused_tc"
            assert (f.stream_launches, f.tc_launches) == (before[1], before[2] + 1)
            kslice, splits, (mt, nt, _) = em.tc_plan(m, n, k, SMS)
            assert args[11:16] == (m, n, k, kslice, splits) and len(args) == 17
            tickets = mt * nt
        # a workspace exactly when K is split: int32 [M, N] sums, one ticket a
        # strip or tile, handed over with their lengths for the launcher's check
        if splits > 1:
            ws, tk = em._build._workspaces[(torch.device("meta"), 0)]
            assert ws.numel() >= m * n and tk.numel() >= tickets
            assert ws.dtype == tk.dtype == torch.int32
            assert (args[8], args[10]) == (ws.numel(), tk.numel())
        else:
            assert args[7:11] == (None, 0, None, 0)


def test_wrapper_loop_override(recorder):
    """The launch helper chip_smoke.py times the two loops with takes the
    loop it is given, whatever M, and counts it as the wrapper does; it
    refuses the removed CUDA-core tile loop; the public wrapper has no
    override."""
    em._launch_fused(*_meta_operands(64, 2048, 256), torch.float32, "stream")
    em._launch_fused(*_meta_operands(8, 2048, 256), torch.float32, "tc")
    assert [c[0] for c in recorder.calls] == ["ent_matmul_packed_fused_stream",
                                              "ent_matmul_packed_fused_tc"]
    f = em.ent_matmul_packed_fused
    assert (f.launches, f.stream_launches, f.tc_launches) == (2, 1, 1)
    for route in ("tile", "dp4a"):
        with pytest.raises(ValueError):
            em._launch_fused(*_meta_operands(8, 2048, 256), torch.float32, route)
    assert len(recorder.calls) == 2 and f.launches == 2
    with pytest.raises(TypeError):
        em.ent_matmul_packed_fused(*_meta_operands(8, 64, 64), loop="tile")


TC_SHAPES = QWEN + [(1000, 300), (16, 7), (5, 64), (20000, 64), (300, 4096)]


@pytest.mark.parametrize("k,n", TC_SHAPES, ids=[f"{k}x{n}" for k, n in TC_SHAPES])
def test_tc_plan_covers_every_tile_and_k_once(k, n):
    """Every output element lies in exactly one (M tile, N tile) of the
    grid, and every k in exactly one K slice of whole TC_BK steps (the last
    may be shorter), at every M the tensor-core route takes, the small M
    that chip_smoke.py also runs on it (the cut table, the decode tick's
    route comparison) and more."""
    for m in (1, 3, 8, em.M_STREAM + 1, 96, 128, 129, 260, 505, 512, 4096):
        kslice, splits, (mt, nt, gsplits) = em.tc_plan(m, n, k, SMS)
        assert gsplits == splits >= 1
        assert mt * em.TC_BM >= m > (mt - 1) * em.TC_BM
        assert nt * em.TC_BN >= n > (nt - 1) * em.TC_BN
        assert kslice % em.TC_BK == 0 and kslice > 0
        if splits > 1:
            assert kslice >= em.TC_MIN_STEPS * em.TC_BK
        seen = np.zeros(k, dtype=np.int64)
        for lo, hi in _slices(k, kslice, splits):
            assert lo < hi
            seen[lo:hi] += 1
        assert (seen == 1).all(), m


@pytest.mark.parametrize("k,n", QWEN, ids=[f"{k}x{n}" for k, n in QWEN])
def test_tc_plan_fills_the_card_in_one_wave(k, n):
    """At the prefill sizes of M, the grid fills at least half the SMs
    wherever the tiles and K allow it (a split needs TC_MIN_STEPS steps),
    and a split never spills into a second wave."""
    for m in (em.M_STREAM + 1, 128, 260, 384, 505, 512):
        kslice, splits, grid = em.tc_plan(m, n, k, SMS)
        tiles, blocks = grid[0] * grid[1], int(np.prod(grid))
        steps = -(-k // em.TC_BK)
        if splits > 1:
            assert blocks <= SMS, (m, grid)
        assert 2 * blocks > SMS or blocks == tiles * max(1, steps // em.TC_MIN_STEPS), (m, grid)


def test_workspace_grows_and_is_reused(recorder):
    key = (torch.device("meta"), 0)
    a = em._build.stream_workspace(key, 100, 4)
    assert em._build.stream_workspace(key, 50, 2) == a     # big enough: the same tensors
    b = em._build.stream_workspace(key, 200, 3)
    assert b[0].numel() == 200 and b[1].numel() == 4  # grown, never shrunk
    # another CUDA stream on the same device gets its own workspace
    c = em._build.stream_workspace((torch.device("meta"), 1), 50, 2)
    assert c[0] is not b[0] and c[1] is not b[1]
    assert em._build.stream_workspace(key, 50, 2) == b


@pytest.mark.parametrize("m", [1, 3, 8, 16])
def test_cpu_tensors_take_the_plain_version(m):
    """On CPU tensors the wrapper is the plain version, bit-equal to the
    JAX reference's oracle at the decode rows, and counts no launch."""
    for out_dtype in (torch.float32, torch.bfloat16, torch.int32):
        _check_plain(m, out_dtype)


def _check_plain(m, out_dtype):
    rng = np.random.default_rng(m)
    k, n = 200, 72
    x = (rng.standard_normal((m, k)) * 2).astype(np.float32)
    w8 = rng.integers(-127, 128, (k, n)).astype(np.int8)
    packed = np.asarray(ref_mult.ent_packed_planes(jnp.asarray(w8)))
    sw = rng.uniform(1e-3, 1e-2, (1, n)).astype(np.float32)
    xt, pt, swt = (torch.from_numpy(np.array(a)) for a in (x, packed, sw))
    sx = ops.row_scale(xt)
    xq_j, sx_j = ref_ent.quantize_rows(jnp.asarray(x))
    np.testing.assert_array_equal(np.asarray(sx_j), sx.numpy())
    if out_dtype == torch.int32:
        want = np.asarray(ref_ent.ent_packed_matmul_int32_ref(xq_j, jnp.asarray(packed)))
    else:
        want = np.asarray(ref_ent.ent_packed_matmul_ref(
            xq_j, jnp.asarray(packed), sx_j, jnp.asarray(sw),
            jnp.bfloat16 if out_dtype == torch.bfloat16 else jnp.float32)).astype(np.float32)
    before = em.ent_matmul_packed_fused.launches, em.ent_matmul_packed_fused.stream_launches
    got = em.ent_matmul_packed_fused(xt, pt, sx, swt, out_dtype)
    assert got.dtype == out_dtype
    np.testing.assert_array_equal(got.float().numpy() if out_dtype == torch.bfloat16
                                  else got.numpy(), want)
    assert (em.ent_matmul_packed_fused.launches,
            em.ent_matmul_packed_fused.stream_launches) == before


def _ok(m=8, k=64, n=32):
    return (torch.zeros((m, k)), torch.zeros((2, k, n), dtype=torch.int8),
            torch.ones((m, 1)), torch.ones((1, n)))


@pytest.mark.parametrize("bad,exc", [
    (lambda x, p, sx, sw: (x.to(torch.float16), p, sx, sw), TypeError),
    (lambda x, p, sx, sw: (x, p.to(torch.int16), sx, sw), TypeError),
    (lambda x, p, sx, sw: (x, p[:1], sx, sw), ValueError),
    (lambda x, p, sx, sw: (x, p[:, :-1], sx, sw), ValueError),
    (lambda x, p, sx, sw: (x, p, sx[:-1], sw), ValueError),
    (lambda x, p, sx, sw: (x, p, sx, sw.double()), TypeError),
    (lambda x, p, sx, sw: (x.t().contiguous().t(), p, sx, sw), ValueError),
    (lambda x, p, sx, sw: (x[:, ::2], p[:, ::2], sx, sw), ValueError),
], ids=["x-fp16", "planes-int16", "one-plane", "k-mismatch", "sx-rows", "sw-f64",
        "x-strided", "x-noncontig"])
def test_wrapper_refuses_bad_operands(bad, exc):
    with pytest.raises(exc):
        em.ent_matmul_packed_fused(*bad(*_ok()))


def test_wrapper_refuses_k_past_the_int32_bound():
    k = PACKED_MAX_K + 16
    x, p, sx, sw = _ok(m=1, k=k, n=1)
    with pytest.raises(ValueError):
        em.ent_matmul_packed_fused(x, p, sx, sw)
    with pytest.raises(TypeError):
        em.ent_matmul_packed_fused(*_ok(), torch.float16)
