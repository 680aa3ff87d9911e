"""Masked flash prefill and paged decode attention: the port's plain
versions against the reference oracles and the Pallas kernels (interpret
mode), on the same numpy inputs in float32.

Tolerances: the port and the reference compute the same float32 math
with different summation orders (torch vs XLA einsums, online vs
blocked softmax), so outputs of O(1) agree to ~1e-6; ``ATOL = 2e-5``
leaves room for that and nothing more.  Fully masked rows must be
exact zeros in every implementation.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.flash_attention import (  # noqa: E402
    flash_attention_masked as pallas_flash_masked)
from repro.kernels.flash_attention.ref import (  # noqa: E402
    masked_attention_ref as ref_masked)
from repro.kernels.paged_attention.paged_attention import (  # noqa: E402
    paged_attention_kernel as pallas_paged)
from repro.kernels.paged_attention.ref import (  # noqa: E402
    paged_attention_ref as ref_paged)
from repro_torch.kernels.flash_attention import ops as attn_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import masked_attention_ref  # noqa: E402
from repro_torch.kernels.paged_attention import ops as paged_ops  # noqa: E402
from repro_torch.kernels.paged_attention.ref import paged_attention_ref  # noqa: E402

ATOL = 2e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _qkv(rng, b, hq, hkv, sq, skv, d):
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return f(b, hq, sq, d), f(b, hkv, skv, d), f(b, hkv, skv, d)


CASES = [  # b, hq, hkv, sq, skv, q_offset, window, start
    (2, 4, 2, 16, 16, 0, None, [0, 5]),
    (2, 4, 2, 16, 48, 32, None, [3, 40]),      # chunk at q_offset, row 1 masked early
    (1, 4, 1, 32, 32, 0, 8, [4]),             # sliding window
    (3, 4, 2, 8, 8, 0, None, [0, 8, 2]),      # slot 1: every row fully masked
]


@pytest.mark.parametrize("b,hq,hkv,sq,skv,q_offset,window,start", CASES)
def test_masked_attention_matches_reference(b, hq, hkv, sq, skv, q_offset,
                                            window, start):
    rng = np.random.default_rng(sq * 7 + skv)
    q, k, v = _qkv(rng, b, hq, hkv, sq, skv, 16)
    st = np.asarray(start, np.int32)
    want = np.asarray(ref_masked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 start=jnp.asarray(st), q_offset=q_offset,
                                 window=window))
    got = attn_ops.masked_attention(_t(q), _t(k), _t(v), start=_t(st),
                                    q_offset=q_offset, window=window)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    # the explicit plain route and the kv-chunked plain version agree too
    plain = attn_ops.masked_attention(_t(q), _t(k), _t(v), start=_t(st),
                                      q_offset=q_offset, window=window,
                                      use_kernel=False, chunk=8)
    np.testing.assert_allclose(plain.numpy(), want, atol=ATOL, rtol=0)
    # the Pallas kernel (interpret mode) computes the same function
    pallas = np.asarray(pallas_flash_masked(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(st),
        q_offset=q_offset, window=window, block_q=8, block_kv=8,
        interpret=True))
    np.testing.assert_allclose(got.numpy(), pallas, atol=ATOL, rtol=0)
    # fully masked query rows (left pad) are exact zeros everywhere
    qpos = q_offset + np.arange(sq)
    dead = qpos[None, :] < st[:, None]                       # [B, Sq]
    for bi, t in zip(*np.nonzero(dead)):
        assert not got[bi, :, t].any() and not want[bi, :, t].any()


def test_masked_attention_valid_mask_matches_reference():
    rng = np.random.default_rng(5)
    q, k, v = _qkv(rng, 2, 4, 2, 1, 24, 16)
    valid = rng.random((2, 1, 24)) < 0.6
    want = np.asarray(ref_masked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 valid=jnp.asarray(valid)))
    got = attn_ops.masked_attention(_t(q), _t(k), _t(v), valid=_t(valid))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def _pool_case(rng, b=4, hq=4, hkv=2, d=16, page=4, pps=5, npool=14):
    q = rng.standard_normal((b, hq, 1, d)).astype(np.float32)
    kp = rng.standard_normal((npool, page, hkv, d)).astype(np.float32)
    vp = rng.standard_normal((npool, page, hkv, d)).astype(np.float32)
    table = np.zeros((b, pps), np.int32)
    table[0] = [1, 2, 3, 4, 5]
    table[1] = [6, 0, 7, 0, 0]          # a null page inside the live range
    table[2] = [8, 9, 10, 11, 12]
    table[3] = 0                        # an idle slot: every entry null
    pos = np.asarray([17, 9, 6, 3], np.int32)
    start = np.asarray([0, 2, 5, 0], np.int32)
    return q, kp, vp, table, pos, start


def test_paged_attention_matches_reference_and_pallas():
    rng = np.random.default_rng(11)
    q, kp, vp, table, pos, start = _pool_case(rng)
    args = (q, kp, vp, table, pos, start)
    want = np.asarray(ref_paged(*map(jnp.asarray, args), page_size=4))
    got = paged_ops.paged_attention(*map(_t, args), page_size=4).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    pallas = np.asarray(pallas_paged(*map(jnp.asarray, args), page_size=4,
                                     interpret=True))
    np.testing.assert_allclose(got, pallas, atol=ATOL, rtol=0)
    assert not got[3].any() and not want[3].any() and not pallas[3].any()
    plain = paged_ops.paged_attention(*map(_t, args), page_size=4,
                                      use_kernel=False).numpy()
    np.testing.assert_array_equal(plain, got)


def test_paged_attention_equals_gathered_masked_attention():
    """Paged read == the dense masked core over the gathered rows."""
    rng = np.random.default_rng(12)
    q, kp, vp, table, pos, start = _pool_case(rng)
    page = 4
    gathered = lambda p: _t(p)[_t(table).long()].reshape(4, -1, 2, 16).transpose(1, 2)  # noqa: E731
    w = table.shape[1] * page
    cols = np.arange(w)
    valid = ((cols[None] <= pos[:, None]) & (cols[None] >= start[:, None])
             & np.repeat(table != 0, page, axis=1))
    dense = masked_attention_ref(_t(q), gathered(kp), gathered(vp),
                                 valid=_t(valid)[:, None, :])
    paged = paged_attention_ref(_t(q), _t(kp), _t(vp), _t(table), _t(pos),
                                _t(start), page_size=page)
    np.testing.assert_array_equal(paged.numpy(), dense.numpy())


def test_int8_kv_scales_are_refused():
    """int8-KV scales fold into masked attention as in the reference;
    scales whose shape is not k/v's [B, Hkv, Skv] are refused."""
    rng = np.random.default_rng(8)
    q, k, v = _qkv(rng, 2, 4, 2, 6, 6, 16)
    k, v = np.round(k * 40), np.round(v * 40)            # int8-like codes
    ks, vs = (rng.uniform(1e-3, 5e-2, (2, 2, 6)).astype(np.float32) for _ in range(2))
    st = np.asarray([0, 2], np.int32)
    want = np.asarray(ref_masked(*map(jnp.asarray, (q, k, v)), start=jnp.asarray(st),
                                 k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs)))
    got = attn_ops.masked_attention(*map(_t, (q, k, v)), start=_t(st), k_scale=_t(ks),
                                    v_scale=_t(vs))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    with pytest.raises(ValueError):
        attn_ops.masked_attention(*map(_t, (q, k, v)), k_scale=_t(ks)[:, :, :4],
                                  v_scale=_t(vs))
