"""The port's SSD scan against the reference on the CPU: the plain
forwards (per-step recurrence, chunk algorithm, the Pallas kernel in
interpret mode), the chunk states, the explicit backward against
``jax.vjp`` and torch autograd, ``SSDScan``'s gradients in float64, and
the wrappers' checks.

Inputs as the reference's sweep (``tests/test_kernels.py:250-253``):
x, B, C normal, dt in [0.001, 0.1], a in [-2, -0.5], from a numpy seed.
Tolerances: both packages compute the same float32 sums in other
orders (the chunk algorithm's intra-chunk products and the carried
state, over at most 512 steps of O(1..10) values): they agree to ~1e-6
of the largest output, so FWD_RTOL = 2e-5 of the largest element leaves
a margin of ~10x; the Pallas kernel's f32 dots round like the chunked
jnp path, held to the same.  Gradients sum over more terms (every
position of every chunk for da): GRAD_RTOL = 1e-4 of each gradient's
largest element.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssd_scan.ref import ssd_decode_step_ref as jax_decode  # noqa: E402
from repro.kernels.ssd_scan.ref import ssd_scan_chunked as jax_chunked  # noqa: E402
from repro.kernels.ssd_scan.ref import ssd_scan_ref as jax_ref  # noqa: E402
from repro.kernels.ssd_scan.ssd_scan import ssd_scan as pallas_ssd  # noqa: E402
from repro_torch.kernels.ssd_scan import ops  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import (  # noqa: E402
    ssd_decode_step_ref, ssd_scan_bwd_ref, ssd_scan_chunked, ssd_scan_fwd_ref, ssd_scan_ref)
from repro_torch.kernels.ssd_scan.ssd_scan import (  # noqa: E402
    ssd_scan, ssd_scan_bwd, ssd_scan_bwd_chunk, ssd_scan_bwd_state)

FWD_RTOL = 2e-5
GRAD_RTOL = 1e-4
# (B, L, H, P, G, N, chunk): the reference's sweep
SWEEP = [(1, 128, 2, 16, 1, 16, 64), (2, 256, 4, 32, 2, 16, 64),
         (1, 256, 4, 64, 1, 32, 128), (1, 512, 2, 32, 2, 64, 128)]


def _data(b, l, h, p, g, n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, l, h, p)).astype(np.float32),
            rng.uniform(0.001, 0.1, size=(b, l, h)).astype(np.float32),
            -rng.uniform(0.5, 2.0, size=(h,)).astype(np.float32),
            rng.normal(size=(b, l, g, n)).astype(np.float32),
            rng.normal(size=(b, l, g, n)).astype(np.float32))


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _close(got, want, rtol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() / (np.abs(want).max() + 1e-30)
    assert err <= rtol, f"{what}: {err:.3e} > {rtol}"


@pytest.mark.parametrize("shape", SWEEP)
def test_plain_forwards_match_reference(shape):
    *dims, chunk = shape
    arrays = _data(*dims)
    want = np.asarray(jax_ref(*map(jnp.asarray, arrays)))
    _close(ssd_scan_ref(*_t(arrays)), want, FWD_RTOL, "ssd_scan_ref")
    _close(ssd_scan_chunked(*_t(arrays), chunk=chunk),
           np.asarray(jax_chunked(*map(jnp.asarray, arrays), chunk=chunk)), FWD_RTOL,
           "ssd_scan_chunked vs the reference's")
    _close(ssd_scan_chunked(*_t(arrays), chunk=chunk), want, FWD_RTOL,
           "ssd_scan_chunked vs the recurrence")
    _close(ssd_scan(*_t(arrays), chunk=chunk),
           np.asarray(pallas_ssd(*map(jnp.asarray, arrays), chunk=chunk, interpret=True)),
           FWD_RTOL, "ssd_scan wrapper (CPU) vs Pallas interpret")


@pytest.mark.parametrize("shape", SWEEP[:2])
def test_chunk_states_match_the_recurrence(shape):
    """h0s[:, :, c] is the recurrence's state after c * chunk steps, built
    from the reference's ``ssd_decode_step_ref``."""
    *dims, chunk = shape
    b, l, h, p, g, n = dims
    x, dt, a, bm, cm = arrays = _data(*dims)
    y, h0s = ssd_scan_fwd_ref(*_t(arrays), chunk=chunk)
    state = jnp.zeros((b, h, p, n), jnp.float32)
    for t in range(l):
        if t % chunk == 0:
            _close(h0s[:, :, t // chunk], state, FWD_RTOL, f"h0s at step {t}")
        state, yt = jax_decode(state, jnp.asarray(x[:, t]), jnp.asarray(dt[:, t]),
                               jnp.asarray(a), jnp.asarray(bm[:, t]), jnp.asarray(cm[:, t]))
        if t % 37 == 0:
            _close(y[:, t], yt, FWD_RTOL, f"y at step {t}")
    assert not h0s[:, :, 0].any()


def test_decode_step_matches_reference():
    b, h, p, g, n = 2, 4, 8, 2, 16
    rng = np.random.default_rng(1)
    arrays = (rng.normal(size=(b, h, p, n)).astype(np.float32),
              rng.normal(size=(b, h, p)).astype(np.float32),
              rng.uniform(0.001, 0.1, size=(b, h)).astype(np.float32),
              -rng.uniform(0.5, 2.0, size=(h,)).astype(np.float32),
              rng.normal(size=(b, g, n)).astype(np.float32),
              rng.normal(size=(b, g, n)).astype(np.float32))
    got = ssd_decode_step_ref(*_t(arrays))
    want = jax_decode(*map(jnp.asarray, arrays))
    for gt, wt, what in zip(got, want, ("state", "y")):
        _close(gt, wt, 1e-6, what)


@pytest.mark.parametrize("shape", SWEEP)
def test_backward_matches_jax_vjp_and_autograd(shape):
    """``ssd_scan_bwd_ref`` (explicit formulas) against ``jax.vjp`` of the
    reference's ``ssd_scan_chunked`` and torch autograd through the
    port's, all five inputs, a random cotangent."""
    *dims, chunk = shape
    arrays = _data(*dims)
    dy = np.random.default_rng(2).normal(size=arrays[0].shape).astype(np.float32)
    _, vjp = jax.vjp(lambda *t: jax_chunked(*t, chunk=chunk), *map(jnp.asarray, arrays))
    want = vjp(jnp.asarray(dy))
    ts = [t.requires_grad_(True) for t in _t(arrays)]
    y, h0s = ssd_scan_fwd_ref(*ts, chunk=chunk)
    auto = torch.autograd.grad(y, ts, torch.from_numpy(dy))
    got = ssd_scan_bwd_ref(*_t(arrays), h0s.detach(), torch.from_numpy(dy), chunk=chunk)
    for name, g, w, a in zip(("dx", "ddt", "da", "db", "dc"), got, want, auto):
        _close(g, w, GRAD_RTOL, f"{name} vs jax.vjp")
        _close(g, a, GRAD_RTOL, f"{name} vs torch autograd")


@pytest.mark.parametrize("l,chunk", [(24, 8), (16, 128)])
def test_ssdscan_gradcheck_float64(l, chunk):
    """Several chunks (the chunk algorithm and the explicit backward) and
    one chunk (the recurrence forward)."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(1, l, 2, 3))).requires_grad_(True)
    dt = torch.from_numpy(rng.uniform(0.01, 0.3, size=(1, l, 2))).requires_grad_(True)
    a = torch.from_numpy(-rng.uniform(0.5, 2.0, size=(2,))).requires_grad_(True)
    b, c = (torch.from_numpy(rng.normal(size=(1, l, 1, 4))).requires_grad_(True)
            for _ in range(2))
    assert torch.autograd.gradcheck(lambda *t: ops.ssd(*t, chunk=chunk), (x, dt, a, b, c))


def _counts():
    """Every launch counter of the three SSD wrappers, and the plain route's."""
    return ([f.launches for f in (ssd_scan, ssd_scan_bwd_state, ssd_scan_bwd_chunk)]
            + [getattr(ssd_scan, f"{p}_launches") for p in ("states", "carry", "out")]
            + [getattr(ssd_scan_bwd_state, f"{p}_launches") for p in ("own", "carry")]
            + [ops.ssd.plain_launches])


def test_ops_routes_on_the_cpu():
    """use_kernel=True goes through SSDScan (the wrappers' plain
    versions), use_kernel=False through the reference's CPU route; both
    agree, and the CPU launches no kernel and counts no plain run."""
    before = _counts()
    for l, chunk in ((256, 64), (64, 128)):
        arrays = _t(_data(1, l, 2, 8, 1, 16))
        ts = [t.clone().requires_grad_(True) for t in arrays]
        y = ops.ssd(*ts, chunk=chunk)
        assert y.grad_fn is not None and type(y.grad_fn).__name__ == "SSDScanBackward"
        yp = ops.ssd(*arrays, chunk=chunk, use_kernel=False)
        want = ssd_scan_ref(*arrays) if l <= chunk else ssd_scan_chunked(*arrays, chunk=chunk)
        assert torch.equal(yp, want)
        _close(y.detach(), yp, FWD_RTOL, "SSDScan vs the plain route")
        y.sum().backward()
    assert _counts() == before


def test_wrappers_refuse_bad_arguments():
    x, dt, a, b, c = _t(_data(1, 96, 2, 8, 1, 16))
    dy = torch.ones_like(x)
    with pytest.raises(ValueError, match="multiple of chunk"):
        ssd_scan(x, dt, a, b, c, chunk=64)
    with pytest.raises(ValueError, match="multiple of chunk"):
        ssd_scan_bwd_state(dt, a, c, dy, chunk=64)
    with pytest.raises(ValueError, match="multiple of chunk"):
        ssd_scan_chunked(x, dt, a, b, c, chunk=64)
    with pytest.raises(ValueError, match="multiple of chunk"):
        ops.ssd(x, dt, a, b, c, chunk=64)
    with pytest.raises(ValueError, match="multiple of G"):
        ssd_scan(x, dt, a, b.expand(1, 96, 3, 16), c.expand(1, 96, 3, 16), chunk=32)
    with pytest.raises(ValueError, match="fault"):
        ssd_scan(x, dt, a, b, c, chunk=32, fault=1)
    _, h0s = ssd_scan(x, dt, a, b, c, chunk=32, save_states=True)
    with pytest.raises(ValueError, match="h0s"):
        ssd_scan_bwd(x, dt, a, b, c, h0s[:, :, :2], dy, chunk=32)


@pytest.mark.parametrize("shape", SWEEP[:2])
def test_state_gradient_wrapper_on_the_cpu(shape):
    """Kernel 8b's wrapper on CPU tensors is its plain version: with 8c's
    it gives jax.vjp's five gradients, and it counts none of its launches
    (calls, own, carry); a planted fault has no plain version."""
    *dims, chunk = shape
    arrays = _data(*dims)
    dy = np.random.default_rng(4).normal(size=arrays[0].shape).astype(np.float32)
    _, vjp = jax.vjp(lambda *t: jax_chunked(*t, chunk=chunk), *map(jnp.asarray, arrays))
    want = vjp(jnp.asarray(dy))
    x, dt, a, b, c = _t(arrays)
    f = ssd_scan_bwd_state
    assert (f.launches, f.own_launches, f.carry_launches) == (0, 0, 0)
    _, h0s = ssd_scan_fwd_ref(x, dt, a, b, c, chunk)
    dhs = f(dt, a, c, torch.from_numpy(dy), chunk=chunk)
    got = ssd_scan_bwd_chunk(x, dt, a, b, c, h0s, dhs, torch.from_numpy(dy), chunk=chunk)
    for name, g, w in zip(("dx", "ddt", "da", "db", "dc"), got, want):
        _close(g, w, GRAD_RTOL, f"{name} vs jax.vjp")
    assert (f.launches, f.own_launches, f.carry_launches) == (0, 0, 0)
    for fault in (3, 4):
        with pytest.raises(ValueError, match="fault"):
            f(dt, a, c, torch.from_numpy(dy), chunk=chunk, fault=fault)


class _Recorder:
    def __init__(self):
        self.calls = []

    def entry(self, name, fname=None):
        def fn(*args):
            self.calls.append((fname, args))
            return 0
        return fn


@pytest.mark.parametrize("l,chunk", [(4096, 128), (128, 128), (96, 32)])
def test_state_gradient_wrapper_launches_own_then_carry(monkeypatch, l, chunk):
    """On card tensors (meta tensors here, with a recorder for the built
    library) kernel 8b is two launches on one stream: the own kernel
    writes dhs and the [B, H, nc] cum_Q scratch that the reverse carry
    then reads, each counted beside the call; the fault reaches both."""
    from repro_torch.kernels.ssd_scan import ssd_scan as mod
    rec = _Recorder()
    monkeypatch.setattr(mod._build, "entry", rec.entry)
    monkeypatch.setattr(mod._build, "stream_of", lambda t: 7)
    f = ssd_scan_bwd_state
    for name in ("launches", "own_launches", "carry_launches"):
        monkeypatch.setattr(f, name, 0)
    meta = torch.device("meta")
    bsz, h, g = 2, 4, 1
    dt = torch.empty((bsz, l, h), device=meta)
    a = torch.empty((h,), device=meta)
    c = torch.empty((bsz, l, g, 128), device=meta)
    dy = torch.empty((bsz, l, h, 64), device=meta)
    dhs = f(dt, a, c, dy, chunk=chunk, fault=4)
    nc = l // chunk
    assert dhs.shape == (bsz, h, nc, 64, 128) and dhs.dtype == torch.float32
    (own, oargs), (carry, cargs) = rec.calls
    assert (own, carry) == ("ssd_bwd_own", "ssd_bwd_carry")
    assert oargs[4] == dhs.data_ptr() and oargs[6:] == (bsz, l, h, g, 64, 128, chunk, 4, 7)
    assert cargs[0] == oargs[5] and cargs[1] == dhs.data_ptr()   # the scratch, then dhs
    assert cargs[2:] == (bsz, l, h, chunk, 4, 7)
    assert (f.launches, f.own_launches, f.carry_launches) == (1, 1, 1)
