"""EN-T encoders, quantized records and the EN-T matmuls (4-plane,
packed, packed fused): the port against the reference, on the same numpy
inputs.  Integer work is compared exactly, and so is every epilogue (the
same float32 roundings of the same integers)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import QuantConfig, get_config, reduced_config  # noqa: E402
from repro.core import multiplier as ref_mult  # noqa: E402
from repro.kernels.ent_matmul import ops as ref_ent_ops  # noqa: E402
from repro.kernels.ent_matmul import ref as ref_ent  # noqa: E402
from repro.kernels.ent_matmul.ent_matmul import (  # noqa: E402
    ent_matmul as pallas_4plane, ent_matmul_packed as pallas_packed,
    ent_matmul_packed_fused as pallas_packed_fused)
from repro.quant import quantize as ref_quant  # noqa: E402
from repro.models.transformer import build_model as ref_build  # noqa: E402
from repro.quant.quantize import quantize_params as ref_quantize_params  # noqa: E402
from repro.quant.quantize import quantize_weight as ref_quantize_weight  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs.base import QuantConfig as PortQuantConfig  # noqa: E402
from repro_torch.core import multiplier as mult  # noqa: E402
from repro_torch.kernels.ent_matmul import ops  # noqa: E402
from repro_torch.kernels.ent_matmul import ref  # noqa: E402
from repro_torch.kernels.ent_matmul.ent_matmul import (  # noqa: E402
    ent_matmul, ent_matmul_packed, ent_matmul_packed_fused)
from repro_torch.kernels.int8_matmul.int8_matmul import int8_matmul  # noqa: E402
from repro_torch.quant import quantize  # noqa: E402

ALL_INT8 = np.arange(-128, 128, dtype=np.int8)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_digit_planes_bit_exact_all_int8():
    want = np.asarray(ref_mult.ent_digit_planes(jnp.asarray(ALL_INT8)))
    got = mult.ent_digit_planes(_t(ALL_INT8)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        mult.planes_to_weight(_t(got)).numpy(), ALL_INT8.astype(np.int32))


def test_packed_planes_bit_exact_all_int8():
    want = np.asarray(ref_mult.ent_packed_planes(jnp.asarray(ALL_INT8)))
    got = mult.ent_packed_planes(_t(ALL_INT8))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.shape[0] == mult.NUM_PACKED_PLANES
    np.testing.assert_array_equal(mult.packed_to_weight(got).numpy(),
                                  ALL_INT8.astype(np.int32))
    np.testing.assert_array_equal(
        mult.unpack_planes(got).numpy(),
        np.asarray(ref_mult.unpack_planes(jnp.asarray(want))))
    assert mult.PACKED_MAX_K == ref_mult.PACKED_MAX_K


@pytest.mark.parametrize("shape,per_channel", [((48, 40), True),
                                               ((3, 33, 17), True),
                                               ((64, 24), False)])
def test_quantize_weight_records_bit_equal(shape, per_channel):
    w = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    ref_fn = lambda a: ref_quantize_weight(a, per_channel=per_channel)  # noqa: E731
    for _ in range(len(shape) - 2):
        ref_fn = jax.vmap(ref_fn, in_axes=0)
    want = ref_fn(jnp.asarray(w))
    got = quantize.quantize_weight(_t(w), per_channel=per_channel)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))


def test_quantize_params_records_bit_equal_on_smoke_model():
    cfg = reduced_config(get_config("qwen2.5-3b"))
    params = ref_build(cfg).init(jax.random.PRNGKey(3))
    want = bridge.params_from_numpy(
        jax.tree.map(np.asarray, ref_quantize_params(params, QuantConfig(enabled=True))),
        "cpu")
    got = quantize.quantize_params(
        bridge.params_from_numpy(jax.tree.map(np.asarray, params), "cpu"),
        PortQuantConfig(enabled=True))
    flat_w = []

    def walk(a, b, path):
        assert type(a) is type(b) or isinstance(a, (list, tuple)), path
        if isinstance(a, dict):
            assert set(a) == set(b), path
            for k in a:
                walk(a[k], b[k], f"{path}/{k}")
        elif isinstance(a, (list, tuple)):
            for i, (x, y) in enumerate(zip(a, b)):
                walk(x, y, f"{path}/{i}")
        else:
            flat_w.append(path)
            assert a.dtype == b.dtype and torch.equal(a, b), path

    walk(want, got, "")
    assert any(p.endswith("planes_packed") for p in flat_w)
    assert "embedding" in str(flat_w) and "lm_head/kernel" in str(flat_w)


@pytest.mark.parametrize("m,k,n", [(1, 64, 32), (8, 130, 77), (37, 256, 96)])
def test_fused_ref_bit_equal_to_reference(m, k, n):
    rng = np.random.default_rng(m * 1000 + k)
    x = (rng.standard_normal((m, k)) * rng.uniform(0.1, 5)).astype(np.float32)
    w8 = rng.integers(-127, 128, (k, n)).astype(np.int8)
    packed = np.asarray(ref_mult.ent_packed_planes(jnp.asarray(w8)))
    sw = rng.uniform(1e-3, 1e-2, (1, n)).astype(np.float32)
    want = np.asarray(ref_ent.ent_packed_fused_ref(jnp.asarray(x), jnp.asarray(packed),
                                                   jnp.asarray(sw)))
    got = ref.ent_packed_fused_ref(_t(x), _t(packed), _t(sw))
    np.testing.assert_array_equal(got.numpy(), want)
    # the dispatching op and the kernel wrapper on CPU: the same bits
    launches = ent_matmul_packed_fused.launches
    np.testing.assert_array_equal(
        ops.ent_quantized_matmul_fused(_t(x), _t(packed), _t(sw)).numpy(), want)
    assert ent_matmul_packed_fused.launches == launches
    # the int32 accumulator equals X @ W exactly
    xq, _ = ref.quantize_rows(_t(x))
    np.testing.assert_array_equal(
        ref.ent_packed_matmul_int32_ref(xq, _t(packed)).numpy(),
        xq.numpy().astype(np.int64) @ w8.astype(np.int64))


@pytest.mark.parametrize("m,k,n,bk", [(16, 256, 128, 128), (8, 512, 256, 256)])
def test_against_pallas_interpret(m, k, n, bk):
    """The int32 path is exact against the Pallas kernel; the Pallas
    prologue quantizes with x * (1/sx), the port (like the oracle) with
    x / sx, so individual Xq may differ by one quantization step — the
    output then equals the port's epilogue over the Pallas Xq exactly."""
    rng = np.random.default_rng(k + n)
    x = (rng.standard_normal((m, k)) * 3).astype(np.float32)
    w8 = rng.integers(-127, 128, (k, n)).astype(np.int8)
    packed = np.asarray(ref_mult.ent_packed_planes(jnp.asarray(w8)))
    sw = rng.uniform(1e-3, 1e-2, (1, n)).astype(np.float32)
    sx = ops.row_scale(_t(x))
    pallas = np.asarray(pallas_packed_fused(
        jnp.asarray(x), jnp.asarray(packed), jnp.asarray(sx.numpy()), jnp.asarray(sw),
        block_m=m, block_n=n, block_k=bk, interpret=True))
    xq_div = ref.quantize_with_scale(_t(x), sx)
    xq_rcp = torch.clamp(torch.round(_t(x) * (1.0 / sx)), -127, 127).to(torch.int8)
    assert (xq_div.to(torch.int32) - xq_rcp.to(torch.int32)).abs().max() <= 1
    np.testing.assert_array_equal(
        ref.ent_packed_matmul_ref(xq_rcp, _t(packed), sx, _t(sw)).numpy(), pallas)
    port = ops.ent_quantized_matmul_fused(_t(x), _t(packed), _t(sw)).numpy()
    step = np.abs(w8.astype(np.float32)).max(0) * sx.numpy() * sw   # one Xq step
    diff_rows = (xq_div != xq_rcp).sum(1).numpy()[:, None]
    assert np.all(np.abs(port - pallas) <= diff_rows * step * (1 + 1e-5) + 1e-6)


def _int8_case(rng, m, k, n):
    xq = rng.integers(-127, 128, (m, k)).astype(np.int8)
    w8 = rng.integers(-127, 128, (k, n)).astype(np.int8)
    sx = rng.uniform(1e-3, 1e-1, (m, 1)).astype(np.float32)
    sw = rng.uniform(1e-3, 1e-2, (1, n)).astype(np.float32)
    return xq, w8, sx, sw


def test_weight_encoders_bit_equal():
    w8 = np.random.default_rng(2).integers(-128, 128, (40, 24)).astype(np.int8)
    np.testing.assert_array_equal(ops.encode_weights(_t(w8)).numpy(),
                                  np.asarray(ref_ent_ops.encode_weights(jnp.asarray(w8))))
    np.testing.assert_array_equal(
        ops.encode_weights_packed(_t(w8)).numpy(),
        np.asarray(ref_ent_ops.encode_weights_packed(jnp.asarray(w8))))


@pytest.mark.parametrize("m,k,n", [(1, 64, 32), (8, 130, 77), (37, 256, 96)])
def test_4plane_and_packed_refs_bit_equal_to_reference(m, k, n):
    rng = np.random.default_rng(m + 2 * k + n)
    xq, w8, sx, sw = _int8_case(rng, m, k, n)
    planes = np.asarray(ref_mult.ent_digit_planes(jnp.asarray(w8)))
    packed = np.asarray(ref_mult.ent_packed_planes(jnp.asarray(w8)))
    j = lambda *a: tuple(map(jnp.asarray, a))   # noqa: E731
    t = lambda *a: tuple(map(_t, a))            # noqa: E731
    np.testing.assert_array_equal(ref.ent_matmul_int32_ref(*t(xq, planes)).numpy(),
                                  np.asarray(ref_ent.ent_matmul_int32_ref(*j(xq, planes))))
    want4 = np.asarray(ref_ent.ent_matmul_ref(*j(xq, planes, sx, sw)))
    wantp = np.asarray(ref_ent.ent_packed_matmul_ref(*j(xq, packed, sx, sw)))
    np.testing.assert_array_equal(ref.ent_matmul_ref(*t(xq, planes, sx, sw)).numpy(), want4)
    # the ops and the kernel wrappers on CPU: the same bits, no launch
    launches = (ent_matmul.launches, ent_matmul_packed.launches)
    np.testing.assert_array_equal(
        ops.ent_quantized_matmul(*t(xq, planes, sx, sw)).numpy(), want4)
    np.testing.assert_array_equal(
        ops.ent_quantized_matmul_packed(*t(xq, packed, sx, sw)).numpy(), wantp)
    np.testing.assert_array_equal(
        ops.ent_quantized_matmul_packed(*t(xq, packed, sx, sw), use_kernel=False).numpy(),
        np.asarray(ref_ent_ops.ent_quantized_matmul_packed(*j(xq, packed, sx, sw))))
    assert (ent_matmul.launches, ent_matmul_packed.launches) == launches
    # EN-T identity: the encoded products equal the plain int8 product
    np.testing.assert_array_equal(want4, wantp)


@pytest.mark.parametrize("m,k,n,bk", [(16, 256, 128, 128), (8, 512, 256, 256)])
def test_4plane_and_packed_against_pallas_interpret(m, k, n, bk):
    rng = np.random.default_rng(3 * k + n)
    xq, w8, sx, sw = _int8_case(rng, m, k, n)
    planes = np.asarray(ref_mult.ent_digit_planes(jnp.asarray(w8)))
    packed = np.asarray(ref_mult.ent_packed_planes(jnp.asarray(w8)))
    blocks = dict(block_m=m, block_n=n, block_k=bk, interpret=True)
    for pallas, port, p in ((pallas_4plane, ent_matmul, planes),
                            (pallas_packed, ent_matmul_packed, packed)):
        want = np.asarray(pallas(*map(jnp.asarray, (xq, p, sx, sw)), **blocks))
        np.testing.assert_array_equal(port(*map(_t, (xq, p, sx, sw))).numpy(), want)
        # unit scales: the Pallas f32 output is its int32 accumulator
        one = (np.ones((m, 1), np.float32), np.ones((1, n), np.float32))
        acc = np.asarray(pallas(*map(jnp.asarray, (xq, p, *one)), **blocks))
        np.testing.assert_array_equal(
            port(*map(_t, (xq, p, *one)), torch.int32).numpy(), acc.astype(np.int32))


@pytest.mark.parametrize("m,k,n", [(5, 70, 9), (16, 2048 + 3, 40)])
def test_four_variant_int32_identity(m, k, n):
    """The int32 results of int8_matmul(Xq, q), ent_matmul(Xq, planes4),
    ent_matmul_packed(Xq, packed) and ent_matmul_packed_fused(X, packed)
    at the same Xq (the fused one quantizes X with the sx of
    quantize_rows) are all X @ W."""
    rng = np.random.default_rng(m + k)
    x = _t((rng.standard_normal((m, k)) * 3).astype(np.float32))
    w8 = _t(rng.integers(-127, 128, (k, n)).astype(np.int8))
    sw = _t(rng.uniform(1e-3, 1e-2, (1, n)).astype(np.float32))
    xq, sx = ref.quantize_rows(x)
    want = xq.numpy().astype(np.int64) @ w8.numpy().astype(np.int64)
    planes, packed = ops.encode_weights(w8), ops.encode_weights_packed(w8)
    got = [int8_matmul(xq, w8, sx, sw, torch.int32),
           ent_matmul(xq, planes, sx, sw, torch.int32),
           ent_matmul_packed(xq, packed, sx, sw, torch.int32),
           ent_matmul_packed_fused(x, packed, sx, sw, torch.int32)]
    for g in got:
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), want)
    # and the dequantized outputs agree bit for bit as well
    outs = [int8_matmul(xq, w8, sx, sw, torch.float32), ent_matmul(xq, planes, sx, sw),
            ent_matmul_packed(xq, packed, sx, sw), ent_matmul_packed_fused(x, packed, sx, sw)]
    for o in outs[1:]:
        assert torch.equal(o, outs[0])


def test_legacy_records_raise():
    """Legacy 4-plane ``planes`` records and plane-less ``q`` records are
    served, bit-equal to the reference's ``qdense_apply``; a record whose
    planes do not match the activations is refused."""
    rng = np.random.default_rng(6)
    w = rng.standard_normal((48, 40)).astype(np.float32)
    rec = ref_quantize_weight(jnp.asarray(w), ent_encode=False)
    legacy = dict(rec, planes=ref_ent_ops.encode_weights(rec["q"]),
                  bias=jnp.asarray(rng.standard_normal(40).astype(np.float32)))
    x = (rng.standard_normal((3, 4, 48)) * 2).astype(np.float32)
    launches = (ent_matmul.launches, int8_matmul.launches)
    for r in (rec, legacy):
        want = np.asarray(ref_quant.qdense_apply(r, jnp.asarray(x), out_dtype=jnp.float32))
        port_rec = {key: _t(v) for key, v in r.items()}
        got = quantize.qdense_apply(port_rec, _t(x), out_dtype=torch.float32)
        np.testing.assert_array_equal(got.numpy(), want)
        plain = quantize.qdense_apply(port_rec, _t(x), out_dtype=torch.float32,
                                      use_kernel=False)
        np.testing.assert_array_equal(plain.numpy(), want)
    assert (ent_matmul.launches, int8_matmul.launches) == launches
    with pytest.raises(ValueError):
        quantize.qdense_apply(dict(port_rec, planes=port_rec["planes"][:3]), _t(x))
    with pytest.raises(ValueError):
        quantize.qdense_apply({key: v for key, v in port_rec.items() if key != "planes"},
                              _t(x[..., :40]))
