"""int8 KV cache: ``quantize_kv``, the scale pools of the paged and dense
caches, the scale folds of paged and masked attention, and serving the
plain int8 configuration (w8a8 without EN-T planes, int8 KV) — the port
against the reference on the same numpy inputs.

Tolerances: ``quantize_kv`` codes and scales, the cache's storage-form
reads and the serving token streams are exact.  Attention outputs are
float32 math in other summation orders (torch vs XLA einsums, online vs
blocked softmax), so outputs of O(1) agree to ~1e-6; ``ATOL = 2e-5``, as
in ``test_torch_attention.py``.  Within the port, paged decode equals
dense decode bit for bit, as in the reference.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import QuantConfig, get_config, reduced_config  # noqa: E402
from repro.kernels.flash_attention import ops as ref_attn_ops  # noqa: E402
from repro.kernels.flash_attention.ref import masked_attention_ref as ref_masked  # noqa: E402
from repro.kernels.paged_attention.paged_attention import (  # noqa: E402
    paged_attention_kernel as pallas_paged)
from repro.kernels.paged_attention.ref import paged_attention_ref as ref_paged  # noqa: E402
from repro.models import kv_cache as ref_kv  # noqa: E402
from repro.models.transformer import build_model as ref_build  # noqa: E402
from repro.quant.quantize import quantize_params as ref_quantize  # noqa: E402
from repro.runtime.serve_loop import ServeEngine as RefEngine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config as port_get_config  # noqa: E402
from repro_torch.configs import reduced_config as port_reduced  # noqa: E402
from repro_torch.configs.base import QuantConfig as PortQuantConfig  # noqa: E402
from repro_torch.kernels.flash_attention import ops as attn_ops  # noqa: E402
from repro_torch.kernels.flash_attention.flash_attention import (  # noqa: E402
    flash_attention_masked)
from repro_torch.kernels.paged_attention import ops as paged_ops  # noqa: E402
from repro_torch.kernels.paged_attention.paged_attention import (  # noqa: E402
    paged_attention_kernel)
from repro_torch.launch import serve as port_serve  # noqa: E402
from repro_torch.models import kv_cache  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402
from repro_torch.runtime.serve_loop import ServeEngine  # noqa: E402

ATOL = 2e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def test_quantize_kv_codes_and_scales_bit_equal():
    rng = np.random.default_rng(0)
    t = (rng.standard_normal((2, 7, 3, 16)) * rng.uniform(0.05, 8, (2, 7, 3, 1)))
    t = t.astype(np.float32)
    t[0, 0, 0] = 0.0                                # all-zero row: the 1e-8 floor
    t[1, 2, 1] = 0.25
    t[1, 2, 1, :4] = [127.0, 2.5, -0.5, 1.5]        # scale 1: ties round half to even
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        want_q, want_s = ref_kv.quantize_kv(jnp.asarray(t).astype(jdt))
        got_q, got_s = kv_cache.quantize_kv(_t(t).to(dt))
        assert got_q.dtype == torch.int8 and got_s.dtype == torch.bfloat16
        assert got_s.shape == (2, 7, 3, 1)
        np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
        np.testing.assert_array_equal(got_s.float().numpy(),
                                      np.asarray(want_s.astype(jnp.float32)))


def _write_both(rng, quantized_kind, b=2, max_len=16, h=2, hd=16, page=4):
    """The reference's and the port's cache of one kind, written through
    the same prompt chunk and decode tokens; returns both and the
    per-slot positions written."""
    if quantized_kind == "paged":
        ref = ref_kv.paged_init(b, max_len, h, hd, jnp.float32, page_size=page,
                                quantized=True)
        port = kv_cache.paged_init(b, max_len, h, hd, torch.float32, page_size=page,
                                   quantized=True, device="cpu")
    else:
        shape = (b, max_len, h, hd)
        ref = ref_kv.DenseCache(
            k=jnp.zeros(shape, jnp.int8), v=jnp.zeros(shape, jnp.int8),
            k_s=jnp.zeros(shape[:-1] + (1,), jnp.bfloat16),
            v_s=jnp.zeros(shape[:-1] + (1,), jnp.bfloat16))
        port = kv_cache.dense_init(b, max_len, h, hd, torch.float32, quantized=True,
                                   device="cpu")
    k, v = (rng.standard_normal((b, 6, h, hd)).astype(np.float32) for _ in range(2))
    ref, *ref_fresh = ref.write_prompt(jnp.asarray(k), jnp.asarray(v), 0)
    port, *port_fresh = port.write_prompt(_t(k), _t(v), 0)
    for a, g in zip(ref_fresh, port_fresh):        # storage-form operands
        np.testing.assert_array_equal(g.float().numpy(), np.asarray(a.astype(jnp.float32)))
    pos = np.asarray([6, 6], np.int32)
    for _ in range(3):
        k, v = (rng.standard_normal((b, 1, h, hd)).astype(np.float32) for _ in range(2))
        ref = ref.write_token(jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos), True)
        port = port.write_token(_t(k), _t(v), _t(pos), True)
        pos = pos + 1
    return ref, port, pos


@pytest.mark.parametrize("kind", ["paged", "dense"])
def test_int8_cache_writes_and_context_bit_equal(kind):
    ref, port, pos = _write_both(np.random.default_rng(1), kind)
    assert port.quantized and port.k.dtype == torch.int8
    assert port.k_s.dtype == torch.bfloat16
    assert tuple(port.k_s.shape) == tuple(port.k.shape[:-1]) + (1,)
    for name in ("k", "v", "k_s", "v_s"):
        np.testing.assert_array_equal(
            getattr(port, name).float().numpy(),
            np.asarray(getattr(ref, name).astype(jnp.float32)))
    for a, g in zip(ref.context(8)[:4], port.context(8)[:4]):
        np.testing.assert_array_equal(g.float().numpy(), np.asarray(a.astype(jnp.float32)))
    if kind == "paged":
        view = port.token_view(_t(pos), _t(np.zeros(2, np.int32)))
        assert view.k_s is port.k_s and view.v_s is port.v_s


def _int8_pool_case(rng, b=4, hq=4, hkv=2, d=16, page=4, pps=5, npool=14):
    """Pools of int8 codes with bf16 scales (as quantize_kv writes them),
    the table layout of test_torch_attention's pool case."""
    codes = lambda: rng.integers(-127, 128, (npool, page, hkv, d)).astype(np.int8)  # noqa: E731
    scales = lambda: np.asarray(jnp.asarray(                                        # noqa: E731
        rng.uniform(1e-3, 5e-2, (npool, page, hkv, 1)).astype(np.float32)).astype(
            jnp.bfloat16).astype(jnp.float32))       # bf16 values, held in f32
    q = rng.standard_normal((b, hq, 1, d)).astype(np.float32)
    table = np.zeros((b, pps), np.int32)
    table[0] = [1, 2, 3, 4, 5]
    table[1] = [6, 0, 7, 0, 0]          # a null page inside the live range
    table[2] = [8, 9, 10, 11, 12]
    table[3] = 0                        # an idle slot: every entry null
    pos = np.asarray([17, 9, 6, 3], np.int32)
    start = np.asarray([0, 2, 5, 0], np.int32)
    return q, codes(), codes(), scales(), scales(), table, pos, start


def test_paged_int8_attention_matches_reference_and_pallas():
    q, kp, vp, ks, vs, table, pos, start = _int8_pool_case(np.random.default_rng(2))
    jargs = tuple(map(jnp.asarray, (q, kp, vp, table, pos, start)))
    jks, jvs = (jnp.asarray(s).astype(jnp.bfloat16) for s in (ks, vs))
    want = np.asarray(ref_paged(*jargs, page_size=4, k_scales=jks, v_scales=jvs))
    targs = tuple(map(_t, (q, kp, vp, table, pos, start)))
    tks, tvs = (_t(s).to(torch.bfloat16) for s in (ks, vs))
    assert tks.dtype == torch.bfloat16
    launches = paged_attention_kernel.launches
    got = paged_ops.paged_attention(*targs, page_size=4, k_scales=tks, v_scales=tvs).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    pallas = np.asarray(pallas_paged(*jargs, jks, jvs, page_size=4, interpret=True))
    np.testing.assert_allclose(got, pallas, atol=ATOL, rtol=0)
    assert not got[3].any() and not want[3].any() and not pallas[3].any()
    plain = paged_ops.paged_attention(*targs, page_size=4, k_scales=tks, v_scales=tvs,
                                      use_kernel=False).numpy()
    np.testing.assert_array_equal(plain, got)
    assert paged_attention_kernel.launches == launches
    # the folds matter: without the V scale (or with the K scale of the
    # neighbouring page) the output is another function
    for bad in ((tks, torch.ones_like(tvs)), (tks.roll(1, 0), tvs)):
        wrong = paged_ops.paged_attention(*targs, page_size=4, k_scales=bad[0],
                                          v_scales=bad[1]).numpy()
        assert np.abs(wrong - want).max() > 100 * ATOL
    # int8 pools need their scale pools
    with pytest.raises(ValueError):
        paged_attention_kernel(*targs, k_scales=tks, page_size=4)


def test_int8_masked_attention_matches_reference():
    """Scaled masked attention: the CPU route folds the scales exactly,
    as the reference's; the kernel route (K, V dequantized to q's dtype,
    then the flash kernel) matches the reference's Pallas route."""
    rng = np.random.default_rng(3)
    b, hq, hkv, sq, skv, d = 2, 4, 2, 8, 24, 16
    q = rng.standard_normal((b, hq, sq, d)).astype(np.float32)
    kq, vq = (rng.integers(-127, 128, (b, hkv, skv, d)).astype(np.float32) for _ in range(2))
    ks, vs = (rng.uniform(1e-3, 5e-2, (b, hkv, skv)).astype(np.float32) for _ in range(2))
    st = np.asarray([0, 5], np.int32)
    jargs = tuple(map(jnp.asarray, (q, kq, vq)))
    kw = dict(start=jnp.asarray(st), q_offset=skv - sq)
    want = np.asarray(ref_masked(*jargs, k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs),
                                 **kw))
    targs = tuple(map(_t, (q, kq, vq)))
    tkw = dict(start=_t(st), q_offset=skv - sq, k_scale=_t(ks), v_scale=_t(vs))
    got = attn_ops.masked_attention(*targs, **tkw).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    plain = attn_ops.masked_attention(*targs, **tkw, use_kernel=False, chunk=8).numpy()
    np.testing.assert_allclose(plain, want, atol=ATOL, rtol=0)
    # the kernel route, as the card runs it
    kdeq = attn_ops.dequantize(_t(kq), _t(ks), torch.float32)
    vdeq = attn_ops.dequantize(_t(vq), _t(vs), torch.float32)
    routed = flash_attention_masked(_t(q), kdeq, vdeq, _t(st), q_offset=skv - sq).numpy()
    pallas = np.asarray(ref_attn_ops.masked_attention(
        *jargs, k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs), use_kernel="interpret",
        block_q=8, block_kv=8, **kw))
    np.testing.assert_allclose(routed, pallas, atol=ATOL, rtol=0)
    np.testing.assert_allclose(routed, want, atol=ATOL, rtol=0)


def test_paged_int8_decode_equals_dense_int8_decode():
    """Model decode through paged int8 pools == dense int8 rows, bit for
    bit (the reference's test_paged_attention.py:241, in the port)."""
    cfg = port_reduced(port_get_config("qwen2.5-3b"))
    model, params = port_serve.build(cfg, quant=PortQuantConfig(enabled=True,
                                                                 ent_encode=False),
                                     kv_quant=True, seed=1, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(5).integers(1, cfg.vocab_size, (2, 6)))
    ld, cd = model.prefill(params, model.init_cache(2, 16, kind="dense"), toks)
    lp, cp = model.prefill(params, model.init_cache(2, 16, kind="paged", page_size=8),
                           toks)
    assert cp["layers"][0].k.dtype == torch.int8 and cd["layers"][0].k_s is not None
    np.testing.assert_array_equal(ld.numpy(), lp.numpy())
    for t in range(4):
        ld, cd = model.decode_step(params, cd, toks[:, t])
        lp, cp = model.decode_step(params, cp, toks[:, t])
        np.testing.assert_array_equal(ld.numpy(), lp.numpy())


SLOTS, MAX_LEN, NEW = 3, 48, 6


def test_int8_serving_streams_equal_reference():
    """Greedy streams of reduced qwen2.5-3b in the plain int8
    configuration (``ent_encode=False`` records, ``kv_quant=True``)
    equal the reference ServeEngine's (``prefix_cache=False``) token for
    token."""
    eng, f32 = _int8_streams_equal_reference("qwen2.5-3b")
    # int8 pools + bf16 scales: (hd + 2) bytes per row and head against
    # 4 * hd for the float32 pools of the reduced config
    hd = eng.model.cfg.head_dim
    assert eng.pool_bytes * 4 * hd == f32.pool_bytes * (hd + 2)


@pytest.mark.parametrize("arch", ["qwen2-72b", "minicpm-2b", "llava-next-34b"])
def test_int8_serving_streams_equal_reference_on_arch(arch):
    """The same on reduced qwen2-72b, minicpm-2b (one q head per kv head)
    and llava-next-34b (fed tokens): their decode reads the int8 pools
    through the paged decode op as qwen2.5-3b's does."""
    _int8_streams_equal_reference(arch)


def _int8_streams_equal_reference(arch):
    cfg = reduced_config(get_config(arch))
    params = ref_quantize(ref_build(cfg).init(jax.random.PRNGKey(1)),
                          QuantConfig(enabled=True, ent_encode=False))
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, cfg.vocab_size, int(n)).tolist()
               for n in (5, 11, 3, 16, 9, 14)]
    ref = RefEngine(ref_build(cfg, kv_quant=True), params, slots=SLOTS, max_len=MAX_LEN,
                    prefix_cache=False)
    for p in prompts:
        ref.submit(p, max_new_tokens=NEW)
    want = ref.run()
    model = Model(port_reduced(port_get_config(arch)), device="cpu", kv_quant=True)
    eng = ServeEngine(model, bridge.params_from_numpy(jax.tree.map(np.asarray, params), "cpu"),
                      slots=SLOTS, max_len=MAX_LEN, prefix_cache=False)
    assert eng.cache["layers"][0].k.dtype == torch.int8
    for p in prompts:
        eng.submit(p, max_new_tokens=NEW)
    got = eng.run()
    assert got == want
    assert all(len(v) == NEW for v in got.values())
    eng.check_leaks()
    f32 = ServeEngine(Model(model.cfg, device="cpu"), eng.params, slots=SLOTS,
                      max_len=MAX_LEN, prefix_cache=False)
    return eng, f32
