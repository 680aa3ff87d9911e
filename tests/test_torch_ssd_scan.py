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


def test_ops_routes_on_the_cpu():
    """use_kernel=True goes through SSDScan (the wrappers' plain
    versions), use_kernel=False through the reference's CPU route; both
    agree, and the CPU launches no kernel and counts no plain run."""
    counters = (ssd_scan, ssd_scan_bwd_state, ssd_scan_bwd_chunk)
    before = [f.launches for f in counters] + [ops.ssd.plain_launches]
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
    assert [f.launches for f in counters] + [ops.ssd.plain_launches] == before


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
