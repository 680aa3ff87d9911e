"""Kernel 4 (``ent_matmul_packed``: two packed EN-T planes, pre-quantized
int8 X) on its two routes, the split-K weight stream
(``csrc/int8_stream.cuh``, ``<int8_t, 2, 4>``) and the int8 tensor-core
loop (``csrc/int8_tc.cuh``, 128-row blocks, two accumulator sets), the
parts that run on the CPU: the wrapper's choice of route by its own cut
``M_STREAM_PACKED`` with the plans and workspace it hands over, the plans'
coverage of every output tile and every k, the launch helper that
``chip_smoke.py`` times the loops with (which refuses the removed CUDA-core
tile loop), and the plain version that CPU tensors take.  The kernels
themselves run only on the card, where ``chip_smoke.py`` holds them bit
for bit against the plain version.

The route tests drive the wrapper with ``meta`` tensors (not CPU, so the
wrapper takes its kernel branch) and a recorder in place of the built
library, as ``tests/test_torch_int8_tc.py`` does for kernel 6."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels.ent_matmul.ref import ent_packed_matmul_ref as jax_ref  # noqa: E402
from repro_torch.core.multiplier import ent_packed_planes  # noqa: E402
from repro_torch.kernels.ent_matmul import ent_matmul as em  # noqa: E402

SMS = 132   # the H100's SMs
QWEN = [(2048, 2048), (2048, 256), (2048, 11008), (11008, 2048)]   # K -> N
SHAPES = QWEN + [(1000, 300)]
META = torch.device("meta")


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
    monkeypatch.setattr(em._build, "entry", rec.entry)
    monkeypatch.setattr(em._build, "stream_of", lambda t: 0)
    monkeypatch.setitem(em._build._sms, META, SMS)
    monkeypatch.setattr(em._build, "_workspaces", {})
    for f in (em.ent_matmul_packed, em.ent_matmul_packed_fused, em.ent_matmul):
        for name in ("launches", "stream_launches", "tc_launches"):
            monkeypatch.setattr(f, name, 0)
    return rec


def _meta_operands(m, k, n):
    return (torch.empty((m, k), dtype=torch.int8, device=META),
            torch.empty((2, k, n), dtype=torch.int8, device=META),
            torch.empty((m, 1), dtype=torch.float32, device=META),
            torch.empty((1, n), dtype=torch.float32, device=META))


@pytest.mark.parametrize("m", [1, 3, 8, em.M_STREAM_PACKED, em.M_STREAM_PACKED + 1, 128, 129,
                               260, 512])
def test_wrapper_routes_by_its_own_cut(recorder, m):
    """Up to kernel 4's cut (M_STREAM_PACKED) the two-plane stream with
    stream_plan's plan, above it the tensor-core loop with tc_plan's at 128
    rows a block, each counted on its route and on no other wrapper; f32 is
    the default output, as in the reference."""
    f = em.ent_matmul_packed
    for k, n in SHAPES:
        recorder.calls.clear()
        before = f.launches, f.stream_launches, f.tc_launches
        out = f(*_meta_operands(m, k, n))
        assert out.shape == (m, n) and out.dtype == torch.float32
        (source, fname, args), = recorder.calls
        assert source == "ent_matmul" and f.launches == before[0] + 1
        assert args[5] == em.OUT_KINDS[torch.float32]
        if m <= em.M_STREAM_PACKED:
            assert fname == "ent_matmul_packed_stream"
            assert (f.stream_launches, f.tc_launches) == (before[1] + 1, before[2])
            mb, kslice, splits, (strips, _, chunks) = em.stream_plan(m, n, k, SMS)
            assert args[10:16] == (m, n, k, mb, kslice, splits) and len(args) == 17
            tickets = strips * chunks
        else:
            assert fname == "ent_matmul_packed_tc"
            assert (f.stream_launches, f.tc_launches) == (before[1], before[2] + 1)
            kslice, splits, (mt, nt, _) = em.tc_plan(m, n, k, SMS, em.TC_BM)
            assert args[10:15] == (m, n, k, kslice, splits) and len(args) == 16
            tickets = mt * nt
        if splits > 1:
            ws, tk = em._build._workspaces[(META, 0)]
            assert ws.numel() >= m * n and tk.numel() >= tickets
            assert (args[7], args[9]) == (ws.numel(), tk.numel())
        else:
            assert args[6:10] == (None, 0, None, 0)
    assert em.ent_matmul_packed_fused.launches == em.ent_matmul.launches == 0


@pytest.mark.parametrize("k,n", SHAPES, ids=[f"{k}x{n}" for k, n in SHAPES])
def test_plans_cover_every_tile_and_k_once(recorder, k, n):
    """The plans kernel 4's wrapper hands over: on the stream every column
    lies in one strip, every row in one M chunk and every k in one K slice
    of whole KSTEP rows; on the tensor-core loop every output element in
    one 128 x 128 tile and every k in one slice of whole TC_BK steps, a
    split never spilling past one wave."""
    f = em.ent_matmul_packed
    for m in (1, 3, 8, em.M_STREAM_PACKED, em.M_STREAM_PACKED + 1, 128, 260, 512, 4096):
        recorder.calls.clear()
        f(*_meta_operands(m, k, n))
        (_, fname, args), = recorder.calls
        if fname == "ent_matmul_packed_stream":
            mb, kslice, splits = args[13:16]
            _, _, _, (strips, gsplits, chunks) = em.stream_plan(m, n, k, SMS)
            assert gsplits == splits and mb in em.STREAM_MB
            assert strips * em.STREAM_BN >= n > (strips - 1) * em.STREAM_BN
            assert chunks * mb >= m > (chunks - 1) * mb
            assert kslice % em.STREAM_KSTEP == 0
        else:
            kslice, splits = args[13:15]
            _, _, (mt, nt, gsplits) = em.tc_plan(m, n, k, SMS, em.TC_BM)
            assert gsplits == splits
            assert mt * em.TC_BM >= m > (mt - 1) * em.TC_BM
            assert nt * em.TC_BN >= n > (nt - 1) * em.TC_BN
            assert kslice % em.TC_BK == 0
            if splits > 1:
                assert mt * nt * splits <= SMS and kslice >= em.TC_MIN_STEPS * em.TC_BK
        assert (splits - 1) * kslice < k <= splits * kslice


def test_launch_helper_takes_the_route_it_is_given(recorder):
    """chip_smoke.py times kernel 4's two loops at one M through the
    private launch helper, whatever M; each launch is counted as the
    wrapper counts it, and the removed CUDA-core tile loop is refused."""
    for route in ("stream", "tc"):
        em._launch_packed(*_meta_operands(512, 2048, 256), torch.float32, route)
    em._launch_packed(*_meta_operands(8, 2048, 256), torch.bfloat16, "tc")
    assert [c[1] for c in recorder.calls] == ["ent_matmul_packed_stream", "ent_matmul_packed_tc",
                                              "ent_matmul_packed_tc"]
    assert recorder.calls[2][2][5] == em.OUT_KINDS[torch.bfloat16]
    f = em.ent_matmul_packed
    assert (f.launches, f.stream_launches, f.tc_launches) == (3, 1, 2)
    for route in ("tile", "dp4a"):
        with pytest.raises(ValueError):
            em._launch_packed(*_meta_operands(8, 2048, 256), torch.float32, route)
    assert len(recorder.calls) == 3 and f.launches == 3


def test_the_cut_is_read_at_call_time(recorder, monkeypatch):
    """Kernel 4 follows M_STREAM_PACKED, read at each call, and moving
    kernel 1's cut leaves it alone."""
    ops = _meta_operands(8, 2048, 256)
    monkeypatch.setattr(em, "M_STREAM_PACKED", 0)
    em.ent_matmul_packed(*ops)
    monkeypatch.setattr(em, "M_STREAM_PACKED", 16)
    em.ent_matmul_packed(*ops)
    monkeypatch.setattr(em, "M_STREAM", 0)
    em.ent_matmul_packed(*ops)
    assert [c[1] for c in recorder.calls] == ["ent_matmul_packed_tc", "ent_matmul_packed_stream",
                                              "ent_matmul_packed_stream"]


@pytest.mark.parametrize("m", [1, 8, em.M_STREAM_PACKED + 1, 130])
def test_cpu_tensors_take_the_plain_version(m):
    """On CPU tensors the wrapper is the plain version, at the sizes of
    both routes, bit-equal to the JAX reference's oracle (f32 and bf16),
    its int32 accumulator equal to X @ W (the EN-T identity), and counts no
    launch."""
    rng = np.random.default_rng(m)
    k, n = 200, 72
    x = rng.integers(-127, 128, (m, k)).astype(np.int8)
    w8 = rng.integers(-127, 128, (k, n)).astype(np.int8)
    packed = ent_packed_planes(torch.from_numpy(w8)).numpy()
    sx = rng.uniform(1e-3, 1e-1, (m, 1)).astype(np.float32)
    sw = rng.uniform(1e-3, 1e-2, (1, n)).astype(np.float32)
    f = em.ent_matmul_packed
    before = f.launches, f.stream_launches, f.tc_launches
    args = tuple(torch.from_numpy(a) for a in (x, packed, sx, sw))
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        want = np.asarray(jax_ref(*map(jnp.asarray, (x, packed, sx, sw)),
                                  out_dtype=jdt).astype(jnp.float32))
        got = f(*args, dt)
        assert got.dtype == dt
        np.testing.assert_array_equal(got.float().numpy(), want)
    np.testing.assert_array_equal(f(*args, torch.int32).numpy(),
                                  x.astype(np.int64) @ w8.astype(np.int64))
    assert (f.launches, f.stream_launches, f.tc_launches) == before
