"""Kernel 5 (``ent_matmul``, the legacy 4-plane records) on its two
routes, the split-K weight stream (``csrc/int8_stream.cuh``, four planes)
and the int8 tensor-core loop (``csrc/int8_tc.cuh``, 64-row blocks at four
planes), the parts that run on the CPU: the wrapper's choice of route by
its own cut with its plans and workspace, the launch helper that
``chip_smoke.py`` times the loops with, the plain version that CPU tensors
take, and the tensor-core loop's shared memory at every instantiation.
The kernels themselves run only on the card, where ``chip_smoke.py``
holds them bit for bit against the plain version.

The route tests drive the wrapper with ``meta`` tensors (not CPU, so the
wrapper takes its kernel branch) and a recorder in place of the built
library, as ``tests/test_torch_int8_tc.py`` does for kernel 6."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.ent_matmul.ref import ent_matmul_int32_ref as jax_int32_ref  # noqa: E402
from repro.kernels.ent_matmul.ref import ent_matmul_ref as jax_ref  # noqa: E402
from repro_torch.kernels.ent_matmul import ent_matmul as em  # noqa: E402
from repro_torch.kernels.ent_matmul.ops import encode_weights  # noqa: E402

SMS = 132   # the H100's SMs
QWEN = [(2048, 2048), (2048, 256), (2048, 11008), (11008, 2048)]   # K -> N
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
    for name in ("launches", "stream_launches", "tc_launches"):
        monkeypatch.setattr(em.ent_matmul, name, 0)
    return rec


def _meta_operands(m, k, n):
    return (torch.empty((m, k), dtype=torch.int8, device=META),
            torch.empty((4, k, n), dtype=torch.int8, device=META),
            torch.empty((m, 1), dtype=torch.float32, device=META),
            torch.empty((1, n), dtype=torch.float32, device=META))


@pytest.mark.parametrize("m", [1, 2, 8, em.M_STREAM_PLANES, em.M_STREAM_PLANES + 1, 128,
                               260, 512])
def test_wrapper_routes_by_its_own_cut(recorder, m):
    """Up to kernel 5's cut (M_STREAM_PLANES) the four-plane stream with
    stream_plan's plan, above it the tensor-core loop with tc_plan's at
    64 rows a block, each counted on its route; f32 is the default
    output, as in the reference."""
    f = em.ent_matmul
    for k, n in QWEN + [(1000, 300)]:
        recorder.calls.clear()
        before = f.launches, f.stream_launches, f.tc_launches
        out = f(*_meta_operands(m, k, n))
        assert out.shape == (m, n) and out.dtype == torch.float32
        (source, fname, args), = recorder.calls
        assert source == "ent_matmul" and f.launches == before[0] + 1
        assert args[5] == em.OUT_KINDS[torch.float32]
        if m <= em.M_STREAM_PLANES:
            assert fname == "ent_matmul_planes_stream"
            assert (f.stream_launches, f.tc_launches) == (before[1] + 1, before[2])
            mb, kslice, splits, (strips, _, chunks) = em.stream_plan(m, n, k, SMS)
            assert args[10:16] == (m, n, k, mb, kslice, splits) and len(args) == 17
            tickets = strips * chunks
        else:
            assert fname == "ent_matmul_planes_tc"
            assert (f.stream_launches, f.tc_launches) == (before[1], before[2] + 1)
            kslice, splits, (mt, nt, _) = em.tc_plan(m, n, k, SMS, em.TC_BM_PLANES)
            assert args[10:15] == (m, n, k, kslice, splits) and len(args) == 16
            assert mt * em.TC_BM_PLANES >= m > (mt - 1) * em.TC_BM_PLANES
            tickets = mt * nt
        if splits > 1:
            ws, tk = em._build._workspaces[(META, 0)]
            assert ws.numel() >= m * n and tk.numel() >= tickets
            assert (args[7], args[9]) == (ws.numel(), tk.numel())
        else:
            assert args[6:10] == (None, 0, None, 0)


def test_the_cut_is_read_at_call_time(recorder, monkeypatch):
    """Kernel 5 follows M_STREAM_PLANES, read at each call, and moving it
    leaves kernel 1's cut alone."""
    ops = _meta_operands(8, 2048, 256)
    monkeypatch.setattr(em, "M_STREAM_PLANES", 0)
    em.ent_matmul(*ops)
    monkeypatch.setattr(em, "M_STREAM_PLANES", 8)
    em.ent_matmul(*ops)
    monkeypatch.setattr(em, "M_STREAM", 0)
    em.ent_matmul(*ops)
    assert [c[1] for c in recorder.calls] == ["ent_matmul_planes_tc", "ent_matmul_planes_stream",
                                              "ent_matmul_planes_stream"]


def test_launch_helper_takes_the_route_it_is_given(recorder):
    """chip_smoke.py times kernel 5's three loops at one M through the
    private launch helper; the tile loop is the planes entry with the
    plane count, and each launch is counted as the wrapper counts it."""
    for route in ("stream", "tc", "tile"):
        em._launch_planes(*_meta_operands(512, 2048, 256), torch.float32, route)
    assert [c[1] for c in recorder.calls] == ["ent_matmul_planes_stream", "ent_matmul_planes_tc",
                                              "ent_matmul_planes"]
    assert recorder.calls[2][2][2] == 4 and recorder.calls[2][2][7:10] == (512, 256, 2048)
    f = em.ent_matmul
    assert (f.launches, f.stream_launches, f.tc_launches) == (3, 1, 1)
    with pytest.raises(ValueError):
        em._launch_planes(*_meta_operands(8, 2048, 256), torch.float32, "dp4a")


@pytest.mark.parametrize("k,n", QWEN + [(1000, 300)], ids=[f"{k}x{n}" for k, n in QWEN]
                         + ["1000x300"])
def test_tc_plan_at_64_rows_covers_every_tile_and_k_once(k, n):
    """At 64 rows a block, every output element lies in exactly one tile
    and every k in exactly one K slice of whole TC_BK steps, and a split
    never spills into a second wave."""
    for m in (em.M_STREAM_PLANES + 1, 64, 65, 128, 260, 512, 4096):
        kslice, splits, (mt, nt, gsplits) = em.tc_plan(m, n, k, SMS, em.TC_BM_PLANES)
        assert gsplits == splits >= 1
        assert mt * em.TC_BM_PLANES >= m > (mt - 1) * em.TC_BM_PLANES
        assert nt * em.TC_BN >= n > (nt - 1) * em.TC_BN
        assert kslice % em.TC_BK == 0 and (splits - 1) * kslice < k <= splits * kslice
        if splits > 1:
            assert mt * nt * splits <= SMS and kslice >= em.TC_MIN_STEPS * em.TC_BK


@pytest.mark.parametrize("m", [1, 2, em.M_STREAM_PLANES + 1, 70])
def test_cpu_tensors_take_the_plain_version(m):
    """On CPU tensors the wrapper is the plain version, at the sizes of
    both routes, bit-equal to the JAX reference's oracle, and counts no
    launch."""
    rng = np.random.default_rng(m)
    k, n = 200, 72
    x = rng.integers(-127, 128, (m, k)).astype(np.int8)
    w8 = rng.integers(-127, 128, (k, n)).astype(np.int8)
    planes = encode_weights(torch.from_numpy(w8)).numpy()
    sx = rng.uniform(1e-3, 1e-1, (m, 1)).astype(np.float32)
    sw = rng.uniform(1e-3, 1e-2, (1, n)).astype(np.float32)
    f = em.ent_matmul
    before = f.launches, f.stream_launches, f.tc_launches
    args = tuple(torch.from_numpy(a) for a in (x, planes, sx, sw))
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        want = np.asarray(jax_ref(*map(jnp.asarray, (x, planes, sx, sw)),
                                  out_dtype=jdt).astype(jnp.float32))
        got = f(*args, dt)
        assert got.dtype == dt
        np.testing.assert_array_equal(got.float().numpy(), want)
    acc = f(*args, torch.int32).numpy()
    np.testing.assert_array_equal(acc, np.asarray(jax_int32_ref(jnp.asarray(x),
                                                                jnp.asarray(planes))))
    np.testing.assert_array_equal(acc, x.astype(np.int64) @ w8.astype(np.int64))
    assert (f.launches, f.stream_launches, f.tc_launches) == before


# A mirror of csrc/int8_tc.cuh's shared-memory sizing (BK, TILE, bm,
# x_in_stage, slot_x, a_bytes, stage_bytes, fixed_bytes, ring_slots,
# smem_bytes), for each instantiation the port builds.
H100_SMEM = 232448   # a block's shared memory on the H100 (227 KB)
SMEM_MAX = H100_SMEM - 16   # less the kernel's static `last`
BK, TILE = 128, 128 * 128


def _tc_smem(x_bytes, np_):
    int8_x = x_bytes == 1
    bm = 64 if np_ > 2 else 128
    x_in_stage = int8_x and np_ > 2
    slot = (0 if x_in_stage else bm * BK * x_bytes) + np_ * TILE
    stage = (0 if int8_x and not x_in_stage else bm * BK) + np_ * TILE
    fixed = 2 * stage + (0 if int8_x else 4 * bm) + 1024
    slots = 4
    while slots > 1 and fixed + slots * slot > SMEM_MAX:
        slots -= 1
    return slots, fixed + slots * slot


# (X dtype, planes) of every instantiation: kernel 1 (bf16 and f32 X, two
# packed planes), kernel 6 (int8 X, one plane), kernel 5 (int8 X, four
# planes), with the ring each gets
INSTANTIATIONS = {("bf16", 2): 2, ("f32", 2): 1, ("int8", 1): 4, ("int8", 4): 1}


@pytest.mark.parametrize("inst", list(INSTANTIATIONS), ids=[f"{x}x{p}" for x, p in
                                                          INSTANTIATIONS])
def test_tc_loop_shared_memory_fits_every_instantiation(inst):
    """The tensor-core loop's ring is sized to what fits beside its two
    converted stages: four slots with int8 X at one plane, two with bf16
    X, one with f32 X and one at four planes (whose int8 X lands in the
    stage), each within the H100's 227 KB a block."""
    (x, np_), slots = inst, INSTANTIATIONS[inst]
    x_bytes = {"bf16": 2, "f32": 4, "int8": 1}[x]
    got_slots, smem = _tc_smem(x_bytes, np_)
    assert got_slots == slots and smem <= SMEM_MAX < H100_SMEM
    if inst == ("int8", 4):
        assert smem == 214016   # two stages of 72 KB, one 64 KB slot, alignment slack
