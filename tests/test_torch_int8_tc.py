"""Kernel 6 (``int8_matmul``) on its two routes, the split-K weight stream
(``csrc/int8_stream.cuh``, one plane) and the int8 tensor-core loop
(``csrc/int8_tc.cuh``), the parts that run on the CPU: the wrapper's choice
of route by M with kernel 1's plans and workspace, the launch helper that
``chip_smoke.py`` times the loops with, and the plain version that CPU
tensors take at the sizes of both routes.  The kernels themselves run only
on the card, where ``chip_smoke.py`` holds them bit for bit against the
plain version.

The route tests drive the wrapper with ``meta`` tensors (not CPU, so the
wrapper takes its kernel branch) and a recorder in place of the built
library: it sees which C entry point the wrapper calls, with which plan,
and whether it hands over a workspace."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.int8_matmul.ref import int8_matmul_ref as jax_ref  # noqa: E402
from repro_torch.kernels.ent_matmul import ent_matmul as em  # noqa: E402
from repro_torch.kernels.int8_matmul import int8_matmul as im  # noqa: E402

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
    for f in (im.int8_matmul, em.ent_matmul_packed_fused):
        for name in ("launches", "stream_launches", "tc_launches"):
            monkeypatch.setattr(f, name, 0)
    return rec


def _meta_operands(m, k, n):
    return (torch.empty((m, k), dtype=torch.int8, device=META),
            torch.empty((k, n), dtype=torch.int8, device=META),
            torch.empty((m, 1), dtype=torch.float32, device=META),
            torch.empty((1, n), dtype=torch.float32, device=META))


@pytest.mark.parametrize("m", [1, 8, 16, im.M_STREAM, im.M_STREAM + 1, 128, 260, 512])
def test_wrapper_routes_by_m(recorder, m):
    """Up to kernel 6's own cut (int8_matmul.M_STREAM) the one-plane stream
    with stream_plan's plan, above it the tensor-core loop with tc_plan's,
    each counted on its route; bf16 is the default output, as in the
    reference."""
    f = im.int8_matmul
    for k, n in QWEN + [(1000, 300)]:
        recorder.calls.clear()
        before = f.launches, f.stream_launches, f.tc_launches
        out = f(*_meta_operands(m, k, n))
        assert out.shape == (m, n) and out.dtype == torch.bfloat16
        (source, fname, args), = recorder.calls
        assert source == "int8_matmul" and f.launches == before[0] + 1
        assert args[5] == em.OUT_KINDS[torch.bfloat16]
        if m <= im.M_STREAM:
            assert fname == "int8_matmul_stream"
            assert (f.stream_launches, f.tc_launches) == (before[1] + 1, before[2])
            mb, kslice, splits, (strips, _, chunks) = em.stream_plan(m, n, k, SMS)
            assert args[10:16] == (m, n, k, mb, kslice, splits) and len(args) == 17
            tickets = strips * chunks
        else:
            assert fname == "int8_matmul_tc"
            assert (f.stream_launches, f.tc_launches) == (before[1], before[2] + 1)
            kslice, splits, (mt, nt, _) = em.tc_plan(m, n, k, SMS)
            assert args[10:15] == (m, n, k, kslice, splits) and len(args) == 16
            tickets = mt * nt
        if splits > 1:
            ws, tk = em._build._workspaces[(META, 0)]
            assert ws.numel() >= m * n and tk.numel() >= tickets
            assert (args[7], args[9]) == (ws.numel(), tk.numel())
        else:
            assert args[6:10] == (None, 0, None, 0)


def test_launch_helper_takes_the_route_it_is_given(recorder):
    """chip_smoke.py times kernel 6's three loops at one M through the
    private launch helper; each launch is counted as the wrapper counts it."""
    for route in ("stream", "tc", "tile"):
        im._launch(*_meta_operands(512, 2048, 256), torch.float32, route)
    assert [c[1] for c in recorder.calls] == ["int8_matmul_stream", "int8_matmul_tc",
                                              "int8_matmul"]
    assert recorder.calls[2][2][6:9] == (512, 256, 2048)   # the tile loop: no plan
    f = im.int8_matmul
    assert (f.launches, f.stream_launches, f.tc_launches) == (3, 1, 1)
    with pytest.raises(ValueError):
        im._launch(*_meta_operands(8, 2048, 256), torch.float32, "mma")


def test_kernels_1_and_6_share_one_workspace(recorder):
    """Both wrappers take the split-K workspace of their (device, CUDA
    stream) from one cache, grown to the larger call."""
    x8, w, sx, sw = _meta_operands(8, 2048, 2048)
    im.int8_matmul(x8, w, sx, sw)
    ws, tk = em._build._workspaces[(META, 0)]
    xf = torch.empty((512, 2048), dtype=torch.bfloat16, device=META)
    packed = torch.empty((2, 2048, 2048), dtype=torch.int8, device=META)
    em.ent_matmul_packed_fused(xf, packed, torch.empty((512, 1), device=META), sw)
    assert list(em._build._workspaces) == [(META, 0)]
    grown = em._build._workspaces[(META, 0)]
    assert grown[0].numel() >= max(ws.numel(), 512 * 2048)
    assert [c[1] for c in recorder.calls] == ["int8_matmul_stream", "ent_matmul_packed_fused_tc"]


@pytest.mark.parametrize("m", [1, 8, im.M_STREAM, im.M_STREAM + 1, 130])
def test_cpu_tensors_take_the_plain_version(m):
    """On CPU tensors the wrapper is the plain version, at the sizes of
    both routes, bit-equal to the JAX reference's oracle, and counts no
    launch."""
    rng = np.random.default_rng(m)
    k, n = 200, 72
    x = rng.integers(-127, 128, (m, k)).astype(np.int8)
    w = rng.integers(-127, 128, (k, n)).astype(np.int8)
    sx = rng.uniform(1e-3, 1e-1, (m, 1)).astype(np.float32)
    sw = rng.uniform(1e-3, 1e-2, (1, n)).astype(np.float32)
    f = im.int8_matmul
    before = f.launches, f.stream_launches, f.tc_launches
    args = tuple(torch.from_numpy(a) for a in (x, w, sx, sw))
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        want = np.asarray(jax_ref(*map(jnp.asarray, (x, w, sx, sw)),
                                  out_dtype=jdt).astype(jnp.float32))
        got = f(*args, dt)
        assert got.dtype == dt
        np.testing.assert_array_equal(got.float().numpy(), want)
    np.testing.assert_array_equal(f(*args, torch.int32).numpy(),
                                  x.astype(np.int64) @ w.astype(np.int64))
    assert (f.launches, f.stream_launches, f.tc_launches) == before


def test_each_wrapper_follows_its_own_cut(recorder, monkeypatch):
    """Kernels 1 and 6 each route by their own module's M_STREAM, read at
    call time (chip_smoke.py moves one to compare the decode tick's two
    routes): moving kernel 1's cut leaves kernel 6's route alone, and the
    other way round."""
    x8, w, sx, sw = _meta_operands(8, 2048, 256)
    xf = torch.empty((8, 2048), dtype=torch.bfloat16, device=META)
    packed = torch.empty((2, 2048, 256), dtype=torch.int8, device=META)

    def routes():
        recorder.calls.clear()
        im.int8_matmul(x8, w, sx, sw)
        em.ent_matmul_packed_fused(xf, packed, sx, sw)
        return [c[1].rsplit("_", 1)[-1] for c in recorder.calls]

    cut = em.M_STREAM
    assert routes() == ["stream", "stream"]
    monkeypatch.setattr(em, "M_STREAM", 0)
    assert routes() == ["stream", "tc"]
    monkeypatch.setattr(im, "M_STREAM", 0)
    monkeypatch.setattr(em, "M_STREAM", cut)
    assert routes() == ["tc", "stream"]
    assert (em.route_of(9, 16), em.route_of(17, 16), em.route_of(9, 8)) == ("stream", "tc", "tc")
    assert (em.route_of(cut), em.route_of(cut + 1)) == ("stream", "tc")
