"""The split-bf16 three-pass products of SSD kernels 8, 8b and 8c,
rehearsed on the CPU.

Kernels 8 (the scan), 8b (the state gradients' own term of each chunk)
and 8c (the chunk gradients) run every chunk product on the tensor cores
with each float32 operand split once into bf16 hi + lo and the product
taken as hi hi + hi lo + lo hi, summed in f32 (``csrc/ssd_scan.cu`` has
the error budget).  ``split_bf16_einsum`` (``kernels/ssd_scan/ref.py``) is
that product in plain torch; the chunk algorithm run with it
(``ssd_scan_fwd_ref``, ``ssd_scan_bwd_state_ref`` and
``ssd_scan_bwd_chunk_ref`` with ``einsum=``, the backward fed the
emulated dhs as 8c is fed 8b's) is held to ``chip_smoke.py``'s own SSD limits
(``ssd_units`` / ``ssd_reading``: TOL_F32 plus the decay slack in units
of each output's absolute computation, and da's 6 sigma), against the
float32 plain versions and, for y, against the JAX package's
``ssd_scan_chunked``, on the same numpy inputs, drawn as ``ssd_inputs``
draws them.  It reads at most 1; the same run with one bf16 pass
(``bf16_einsum``) reads above 1, so the limit the card's run applies has
room for the three passes and none for fewer.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssd_scan.ref import ssd_scan_chunked as jax_chunked  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import (  # noqa: E402
    bf16_einsum, split_bf16_einsum, ssd_scan_bwd_chunk_ref, ssd_scan_bwd_state_ref,
    ssd_scan_fwd_ref)

# (B, L, H, P, G, N, chunk): small shapes with several chunks (one with
# groups and a chunk the kernels pad, one at the kernels' widths), and one
# chunk of chip_smoke.py's training check shape
SHAPES = [(2, 192, 4, 16, 2, 32, 48), (1, 512, 4, 64, 1, 128, 128),
          (1, 128, 32, 64, 1, 128, 128)]
IDS = ["small-groups", "kernel-widths", "one-check-chunk"]


@pytest.fixture(scope="module")
def cs():
    """chip_smoke.py's limits and units, on the CPU."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_ssd_limits", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.DEV = "cpu"
    return mod


def _inputs(shape, seed=20):
    """x, dt, a, b, c, dy as numpy float32, drawn as chip_smoke.ssd_inputs
    draws them: dt log-uniform in [0.001, 0.1], a = -(1..H), the rest
    normal."""
    b, l, h, p, g, n, _ = shape
    rng = np.random.default_rng(seed)
    f = lambda *sh: rng.standard_normal(sh).astype(np.float32)  # noqa: E731
    lo, hi = np.log(1e-3), np.log(1e-1)
    dt = np.exp(rng.uniform(lo, hi, size=(b, l, h))).astype(np.float32)
    a = -np.arange(1, h + 1, dtype=np.float32)
    return f(b, l, h, p), dt, a, f(b, l, g, n), f(b, l, g, n), f(b, l, h, p)


def _readings(cs, arrays, chunk, einsum):
    """(forward, backward, dhs) readings of the chunk algorithm with
    ``einsum`` against the float32 plain versions, in chip_smoke.py's
    units; the backward takes the dhs computed with ``einsum``."""
    x, dt, a, bm, cm, dy = map(torch.from_numpy, arrays)
    units, slack, sigma = cs.ssd_units(torch, x, dt, a, bm, cm, dy, chunk)
    want_f = ssd_scan_fwd_ref(x, dt, a, bm, cm, chunk)
    got_f = ssd_scan_fwd_ref(x, dt, a, bm, cm, chunk, einsum=einsum)
    dhs = ssd_scan_bwd_state_ref(dt, a, cm, dy, chunk)
    got_dhs = ssd_scan_bwd_state_ref(dt, a, cm, dy, chunk, einsum=einsum)
    want_b = ssd_scan_bwd_chunk_ref(x, dt, a, bm, cm, want_f[1], dhs, dy, chunk)
    got_b = ssd_scan_bwd_chunk_ref(x, dt, a, bm, cm, got_f[1], got_dhs, dy, chunk,
                                   einsum=einsum)
    return (cs.ssd_reading(got_f, want_f, units, slack, cs.SSD_FWD_OUT),
            cs.ssd_reading(got_b, want_b, units, slack, cs.SSD_BWD_OUT, sigma),
            cs.ssd_reading((got_dhs,), (dhs,), units, slack, ("dhs",)),
            got_f[0], units, slack)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_split_bf16_fits_the_chip_limits(cs, shape):
    chunk = shape[-1]
    arrays = _inputs(shape)
    r_fwd, r_bwd, r_dhs, y, units, slack = _readings(cs, arrays, chunk, split_bf16_einsum)
    assert r_fwd <= 1 and r_bwd <= 1 and r_dhs <= 1, (r_fwd, r_bwd, r_dhs)
    y_jax = torch.from_numpy(np.asarray(jax_chunked(*map(jnp.asarray, arrays[:5]),
                                                    chunk=chunk)))
    r_jax = cs.ssd_reading((y,), (y_jax,), units, slack, ("y",))
    assert r_jax <= 1, r_jax


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_one_bf16_pass_breaks_the_limits(cs, shape):
    """The limits bite: one bf16 pass reads above 1."""
    r_fwd, r_bwd, *_ = _readings(cs, _inputs(shape), shape[-1], bf16_einsum)
    assert min(r_fwd, r_bwd) > 1, (r_fwd, r_bwd)


# the shapes with more than one chunk: the last chunk's dhs is zeros, so a
# one-chunk call has no own term
MULTI = [s for s in SHAPES if s[1] > s[-1]]


@pytest.mark.parametrize("shape", MULTI, ids=[i for s, i in zip(SHAPES, IDS) if s in MULTI])
def test_state_gradients_split_fit_and_one_pass_breaks(cs, shape):
    """8b's own term, (dy exp(cum))^T C, as three split-bf16 passes reads
    within chip_smoke.py's dhs limit (<= 0.02 of it here: 0.0125 and
    0.0067); as one bf16 pass it reads above 1 (5.8 and 3.5), so the
    limit has no room for fewer passes."""
    x, dt, a, bm, cm, dy = map(torch.from_numpy, _inputs(shape))
    chunk = shape[-1]
    units, slack, _ = cs.ssd_units(torch, x, dt, a, bm, cm, dy, chunk)
    want = ssd_scan_bwd_state_ref(dt, a, cm, dy, chunk)

    def reading(einsum):
        got = ssd_scan_bwd_state_ref(dt, a, cm, dy, chunk, einsum=einsum)
        return cs.ssd_reading((got,), (want,), units, slack, ("dhs",))
    split, one = reading(split_bf16_einsum), reading(bf16_einsum)
    assert split <= 0.02 and one > 1, (split, one)


def test_split_residual_and_product_bounds():
    """bf16 keeps 8 significant bits (unit roundoff 2^-8), so hi + lo
    recovers a float32 to 2^-16 of it, and the three-pass product of one
    pair, whose dropped lo lo and two residual terms are each <= 2^-16
    |a| |b|, is within 3 2^-16 of |a| |b| (+ the f32 sums)."""
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal((64, 96)).astype(np.float32) * 10.0)
    b = torch.from_numpy(rng.standard_normal((96, 48)).astype(np.float32))
    hi = a.to(torch.bfloat16).float()
    lo = (a - hi).to(torch.bfloat16).float()
    assert float(((a - hi).abs() / a.abs()).max()) <= 2.0**-8
    assert float(((a - hi - lo).abs() / a.abs()).max()) <= 2.0**-16
    got = split_bf16_einsum("ik,kj->ij", a, b).double()
    want = a.double() @ b.double()
    unit = a.double().abs() @ b.double().abs()
    assert float(((got - want).abs() / unit).max()) <= 3 * 2.0**-16 + 96 * 2.0**-24
