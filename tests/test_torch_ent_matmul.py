"""EN-T encoders, quantized records and the packed fused matmul: the port
against the reference, on the same numpy inputs."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import QuantConfig, get_config, reduced_config  # noqa: E402
from repro.core import multiplier as ref_mult  # noqa: E402
from repro.kernels.ent_matmul import ref as ref_ent  # noqa: E402
from repro.kernels.ent_matmul.ent_matmul import (  # noqa: E402
    ent_matmul_packed_fused as pallas_packed_fused)
from repro.models.transformer import build_model as ref_build  # noqa: E402
from repro.quant.quantize import quantize_params as ref_quantize_params  # noqa: E402
from repro.quant.quantize import quantize_weight as ref_quantize_weight  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs.base import QuantConfig as PortQuantConfig  # noqa: E402
from repro_torch.core import multiplier as mult  # noqa: E402
from repro_torch.kernels.ent_matmul import ops  # noqa: E402
from repro_torch.kernels.ent_matmul import ref  # noqa: E402
from repro_torch.kernels.ent_matmul.ent_matmul import ent_matmul_packed_fused  # noqa: E402
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


def test_legacy_records_raise():
    rec = {"q": torch.zeros((4, 3), dtype=torch.int8), "scale": torch.ones((1, 3))}
    with pytest.raises(NotImplementedError):
        quantize.qdense_apply(rec, torch.zeros((2, 4)))
    with pytest.raises(NotImplementedError):
        quantize.qdense_apply(dict(rec, planes=torch.zeros((4, 4, 3), dtype=torch.int8)),
                              torch.zeros((2, 4)))
