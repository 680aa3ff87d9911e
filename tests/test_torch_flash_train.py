"""Training flash attention: the port's plain forward versions, its
backward (the plain version of kernels 7b/7c) and the autograd route on
the CPU, against the reference's ``attention_ref`` /
``attention_blockwise``, the Pallas ``flash_attention`` in interpret mode
and ``jax.vjp`` of ``attention_ref``, on the same numpy inputs in f32.

Tolerance: the port and the reference compute the same float32 math in
other summation orders (torch vs XLA einsums, a fused softmax vs an
online one); outputs and gradients of O(1) agree to ~1e-6, and ATOL =
2e-5 (with RTOL = 1e-5 for the larger gradients) leaves room for that
and nothing more.  Fully masked rows must be exact zeros everywhere.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.flash_attention import (  # noqa: E402
    flash_attention as pallas_flash)
from repro.kernels.flash_attention.ref import attention_blockwise as ref_blockwise  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref as ref_attention  # noqa: E402
from repro_torch.kernels.flash_attention import ops as attn_ops  # noqa: E402
from repro_torch.kernels.flash_attention.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_bwd, flash_attention_bwd_dkdv,
    flash_attention_bwd_dq)
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_blockwise, attention_ref, flash_attention_bwd_ref,
    flash_attention_ref)

ATOL, RTOL = 2e-5, 1e-5

CASES = [  # b, hq, hkv, sq, skv, causal, window
    (2, 4, 4, 32, 32, True, None),      # MHA, causal
    (1, 4, 2, 32, 32, True, None),      # GQA
    (2, 4, 1, 48, 48, True, 8),         # GQA + sliding window
    (1, 4, 2, 16, 48, True, None),      # Sq < Skv: queries are the suffix
    (1, 2, 2, 16, 48, True, 12),        # suffix + window
    (1, 4, 2, 24, 24, False, None),     # not causal
]
IDS = [f"b{c[0]}h{c[1]}kv{c[2]}q{c[3]}k{c[4]}{'c' if c[5] else 'n'}w{c[6]}" for c in CASES]


def _t(a):
    return torch.from_numpy(np.array(a))


def _data(seed, b, hq, hkv, sq, skv, d=16):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return f(b, hq, sq, d), f(b, hkv, skv, d), f(b, hkv, skv, d), f(b, hq, sq, d)


def _ref_vjp(q, k, v, do, causal, window):
    out, vjp = jax.vjp(lambda q, k, v: ref_attention(q, k, v, causal=causal,
                                                     window=window),
                       jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(do))]


@pytest.mark.parametrize("b,hq,hkv,sq,skv,causal,window", CASES, ids=IDS)
def test_plain_forwards_match_reference(b, hq, hkv, sq, skv, causal, window):
    q, k, v, _ = _data(sq + skv, b, hq, hkv, sq, skv)
    want = np.asarray(ref_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    causal=causal, window=window))
    got = attention_ref(_t(q), _t(k), _t(v), causal=causal, window=window).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    out, lse = flash_attention_ref(_t(q), _t(k), _t(v), causal=causal, window=window)
    assert torch.equal(out, torch.from_numpy(got))
    assert lse.shape == (b, hq, sq) and lse.dtype == torch.float32
    chunk = 8 if skv % 8 == 0 else skv
    want_bw = np.asarray(ref_blockwise(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                       causal=causal, window=window, chunk=chunk))
    got_bw = attention_blockwise(_t(q), _t(k), _t(v), causal=causal, window=window,
                                 chunk=chunk).numpy()
    np.testing.assert_allclose(got_bw, want_bw, atol=ATOL)
    np.testing.assert_allclose(got_bw, want, atol=ATOL)


@pytest.mark.parametrize("b,hq,hkv,sq,skv,causal,window",
                         [c for c in CASES if c[3] % 16 == 0 and c[4] % 16 == 0],
                         ids=[i for c, i in zip(CASES, IDS) if c[3] % 16 == 0 and c[4] % 16 == 0])
def test_pallas_interpret_matches_the_port(b, hq, hkv, sq, skv, causal, window):
    """The Pallas kernel (interpret mode, as tests/test_kernels.py runs
    it) against the port's plain forward and its kernel wrapper's CPU
    route."""
    q, k, v, _ = _data(7 * sq + skv, b, hq, hkv, sq, skv)
    want = np.asarray(pallas_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   causal=causal, window=window, interpret=True,
                                   block_q=16, block_kv=16))
    out, _ = flash_attention(_t(q), _t(k), _t(v), causal=causal, window=window)
    np.testing.assert_allclose(out.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("b,hq,hkv,sq,skv,causal,window", CASES, ids=IDS)
def test_backward_matches_jax_grad(b, hq, hkv, sq, skv, causal, window):
    """flash_attention_bwd_ref from the saved lse, and the wrappers' CPU
    routes, against jax.vjp of the reference's attention_ref."""
    q, k, v, do = _data(3 * sq + skv, b, hq, hkv, sq, skv)
    want_out, want = _ref_vjp(q, k, v, do, causal, window)
    out, lse = flash_attention_ref(_t(q), _t(k), _t(v), causal=causal, window=window)
    grads = flash_attention_bwd_ref(_t(q), _t(k), _t(v), out, lse, _t(do),
                                    causal=causal, window=window)
    for g, w, name in zip(grads, want, ("dq", "dk", "dv")):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, atol=ATOL, rtol=RTOL, err_msg=name)
    args = (_t(q), _t(k), _t(v), out, lse, _t(do))
    kw = dict(causal=causal, window=window)
    for a, bb in zip(flash_attention_bwd(*args, **kw), grads):
        assert torch.equal(a, bb)
    assert all(torch.equal(a, bb) for a, bb in
               zip(flash_attention_bwd_dkdv(*args, **kw), grads[1:]))
    assert torch.equal(flash_attention_bwd_dq(*args, **kw), grads[0])


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("b,hq,hkv,sq,skv,causal,window", CASES, ids=IDS)
def test_autograd_route_matches_jax_grad(b, hq, hkv, sq, skv, causal, window,
                                         use_kernel):
    """ops.attention under autograd: the kernel route (FlashAttention, whose
    wrappers take their plain versions on CPU tensors) and the plain route
    (autograd through attention_ref)."""
    q, k, v, do = _data(5 * sq + skv, b, hq, hkv, sq, skv)
    want_out, want = _ref_vjp(q, k, v, do, causal, window)
    tq, tk, tv = (_t(x).requires_grad_(True) for x in (q, k, v))
    out = attn_ops.attention(tq, tk, tv, causal=causal, window=window,
                             use_kernel=use_kernel)
    np.testing.assert_allclose(out.detach().numpy(), want_out, atol=ATOL)
    out.backward(_t(do))
    for g, w, name in zip((tq.grad, tk.grad, tv.grad), want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), w, atol=ATOL, rtol=RTOL, err_msg=name)


def test_fully_masked_rows_are_zero_with_no_gradient():
    """Sq > Skv: the first Sq - Skv query rows see no column (causal)."""
    q, k, v, do = _data(11, 1, 2, 2, 24, 16)
    want_out, want = _ref_vjp(q, k, v, do, True, None)
    out, lse = flash_attention(_t(q), _t(k), _t(v))
    assert torch.equal(out[:, :, :8], torch.zeros_like(out[:, :, :8]))
    assert torch.isinf(lse[:, :, :8]).all() and torch.isfinite(lse[:, :, 8:]).all()
    np.testing.assert_allclose(out.numpy(), want_out, atol=ATOL)
    dq, dk, dv = flash_attention_bwd(_t(q), _t(k), _t(v), out, lse, _t(do))
    assert torch.equal(dq[:, :, :8], torch.zeros_like(dq[:, :, :8]))
    for g, w in zip((dq, dk, dv), want):
        np.testing.assert_allclose(g.numpy(), w, atol=ATOL, rtol=RTOL)


def test_long_plain_route_is_blockwise_and_cpu_launches_nothing():
    """At Skv >= BLOCKWISE_THRESHOLD the plain route is the blockwise
    version (as the reference's CPU route); CPU tensors launch no kernel."""
    n = attn_ops.BLOCKWISE_THRESHOLD
    q, k, v, _ = _data(2, 1, 1, 1, n, n, d=8)
    counts = [f.launches for f in (flash_attention, flash_attention_bwd_dkdv,
                                   flash_attention_bwd_dq)]
    got = attn_ops.attention(_t(q), _t(k), _t(v), use_kernel=False)
    torch.testing.assert_close(got, attention_blockwise(_t(q), _t(k), _t(v)),
                               rtol=0, atol=0)
    np.testing.assert_allclose(got.numpy(), attention_ref(_t(q), _t(k), _t(v)).numpy(),
                               atol=ATOL)
    assert attn_ops.attention.plain_launches == 0
    tq = _t(q).requires_grad_(True)
    attn_ops.attention(tq, _t(k), _t(v)).sum().backward()
    assert [f.launches for f in (flash_attention, flash_attention_bwd_dkdv,
                                 flash_attention_bwd_dq)] == counts


def test_wrappers_refuse_bad_arguments():
    q, k, v, do = _data(0, 1, 4, 2, 8, 8)
    with pytest.raises(ValueError, match="window"):
        flash_attention(_t(q), _t(k), _t(v), window=0)
    with pytest.raises(ValueError, match="multiple"):
        flash_attention(_t(q), _t(k[:, :1].repeat(3, 1)), _t(v[:, :1].repeat(3, 1)))
    out, lse = flash_attention(_t(q), _t(k), _t(v))
    with pytest.raises(ValueError, match="lse"):
        flash_attention_bwd(_t(q), _t(k), _t(v), out, lse[..., :4], _t(do))
    with pytest.raises(ValueError, match="do"):
        flash_attention_bwd(_t(q), _t(k), _t(v), out, lse, _t(do)[:, :2])
