"""The w8a8 int8 matmul and the plain int8 serving records: the port
against the reference, on the same numpy inputs.

Everything here is integer work or a fixed sequence of float32
roundings of the same integers, so every comparison is exact
(``assert_array_equal``): the int32 accumulator, the ``(acc * sx) * sw``
epilogue in float32 and bf16, ``quantize_acts``, the records of
``quantize_params(ent_encode=False)`` and ``qdense_apply`` over them.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import QuantConfig, get_config, reduced_config  # noqa: E402
from repro.kernels.int8_matmul.int8_matmul import int8_matmul as pallas_int8  # noqa: E402
from repro.kernels.int8_matmul.ref import int8_matmul_ref as jax_ref  # noqa: E402
from repro.models.transformer import build_model as ref_build  # noqa: E402
from repro.quant import quantize as ref_quant  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs.base import QuantConfig as PortQuantConfig  # noqa: E402
from repro_torch.kernels.int8_matmul import ops  # noqa: E402
from repro_torch.kernels.int8_matmul.int8_matmul import int8_matmul  # noqa: E402
from repro_torch.kernels.int8_matmul.ref import int8_matmul_int32_ref, int8_matmul_ref  # noqa: E402
from repro_torch.quant import quantize  # noqa: E402


def _t(a):
    return torch.from_numpy(np.array(a))


def _case(rng, m, k, n):
    x = rng.integers(-127, 128, (m, k)).astype(np.int8)
    w = rng.integers(-127, 128, (k, n)).astype(np.int8)
    sx = rng.uniform(1e-3, 1e-1, (m, 1)).astype(np.float32)
    sw = rng.uniform(1e-3, 1e-2, (1, n)).astype(np.float32)
    return x, w, sx, sw


@pytest.mark.parametrize("m,k,n", [(1, 64, 32), (8, 130, 77), (37, 256, 96)])
def test_plain_version_bit_equal_to_reference(m, k, n):
    rng = np.random.default_rng(m + k + n)
    x, w, sx, sw = _case(rng, m, k, n)
    args = tuple(map(_t, (x, w, sx, sw)))
    jargs = tuple(map(jnp.asarray, (x, w, sx, sw)))
    # the int32 accumulator equals X @ W exactly
    np.testing.assert_array_equal(int8_matmul_int32_ref(*args[:2]).numpy(),
                                  x.astype(np.int64) @ w.astype(np.int64))
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        want = np.asarray(jax_ref(*jargs, out_dtype=jdt).astype(jnp.float32))
        np.testing.assert_array_equal(int8_matmul_ref(*args, dt).float().numpy(), want)
        got = ops.quantized_matmul(*args, out_dtype=dt)
        assert got.dtype == dt
        np.testing.assert_array_equal(got.float().numpy(), want)
    # bf16 is the default output, as in the reference
    assert ops.quantized_matmul(*args).dtype == torch.bfloat16
    assert int8_matmul(*args).dtype == torch.bfloat16


@pytest.mark.parametrize("m,k,n,bk", [(16, 256, 128, 128), (8, 512, 256, 256)])
def test_against_pallas_interpret(m, k, n, bk):
    rng = np.random.default_rng(k + n)
    x, w, sx, sw = _case(rng, m, k, n)
    args = tuple(map(_t, (x, w, sx, sw)))
    launches = int8_matmul.launches
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        pallas = np.asarray(pallas_int8(
            *map(jnp.asarray, (x, w, sx, sw)), block_m=m, block_n=n, block_k=bk,
            out_dtype=jdt, interpret=True).astype(jnp.float32))
        np.testing.assert_array_equal(int8_matmul(*args, dt).float().numpy(), pallas)
    # unit scales: the Pallas kernel's f32 output is its int32 accumulator
    ones = (_t(np.ones((m, 1), np.float32)), _t(np.ones((1, n), np.float32)))
    acc = np.asarray(pallas_int8(jnp.asarray(x), jnp.asarray(w), *map(jnp.asarray, ones),
                                 block_m=m, block_n=n, block_k=bk,
                                 out_dtype=jnp.float32, interpret=True))
    np.testing.assert_array_equal(
        int8_matmul(args[0], args[1], *ones, torch.int32).numpy(), acc.astype(np.int32))
    assert int8_matmul.launches == launches       # CPU tensors launch nothing


def test_quantize_acts_bit_equal():
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((3, 5, 70)) * rng.uniform(0.1, 9, (3, 5, 1))).astype(np.float32)
    x[0, 0] = 0.0                                  # an all-zero row: the 1e-12 floor
    x[1, 1] = 0.25
    x[1, 1, :4] = [127.0, 63.5, -0.5, 1.5]         # scale 1: ties round half to even
    want_q, want_s = ref_quant.quantize_acts(jnp.asarray(x))
    got_q, got_s = quantize.quantize_acts(_t(x))
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32


@pytest.fixture(scope="module")
def int8_records():
    """Reference and port records of the reduced qwen2.5-3b with
    ``ent_encode=False``, bridged to the port's layout."""
    cfg = reduced_config(get_config("qwen2.5-3b"))
    params = ref_build(cfg).init(jax.random.PRNGKey(3))
    want = ref_quant.quantize_params(params, QuantConfig(enabled=True, ent_encode=False))
    got = quantize.quantize_params(
        bridge.params_from_numpy(jax.tree.map(np.asarray, params), "cpu"),
        PortQuantConfig(enabled=True, ent_encode=False))
    return want, got


def test_quantize_params_int8_records_bit_equal(int8_records):
    want, got = int8_records
    want = bridge.params_from_numpy(jax.tree.map(np.asarray, want), "cpu")
    records = []

    def walk(a, b, path):
        if isinstance(a, dict):
            assert set(a) == set(b), path
            if "q" in a:
                assert "planes_packed" not in a and "planes" not in a, path
                records.append(path)
            for k in a:
                walk(a[k], b[k], f"{path}/{k}")
        elif isinstance(a, (list, tuple)):
            for i, (x, y) in enumerate(zip(a, b)):
                walk(x, y, f"{path}/{i}")
        else:
            assert a.dtype == b.dtype and torch.equal(a, b), path

    walk(want, got, "")
    assert len(records) == 7 * len(got["layers"])   # q, k, v, o, gate, up, down


def test_qdense_apply_int8_records_bit_equal(int8_records):
    want_tree, got = int8_records
    rng = np.random.default_rng(9)
    layer = got["layers"][0]
    for path in (("mixer", "wq"), ("mixer", "wo"), ("ffn", "wi_gate"), ("ffn", "wo")):
        jrec = want_tree["groups"][0]
        rec = layer
        for key in path:
            jrec, rec = jrec[key], rec[key]
        jrec = jax.tree.map(lambda a: a[0], jrec)          # group 0
        x = (rng.standard_normal((2, 5, rec["q"].shape[0])) * 2).astype(np.float32)
        for jdt, dt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
            want = np.asarray(ref_quant.qdense_apply(jrec, jnp.asarray(x).astype(jdt),
                                                     out_dtype=jdt).astype(jnp.float32))
            y = quantize.qdense_apply(rec, _t(x).to(dt), out_dtype=dt)
            np.testing.assert_array_equal(y.float().numpy(), want)
    # dequantize_weight is the reference's too
    np.testing.assert_array_equal(
        quantize.dequantize_weight(layer["mixer"]["wq"]).numpy(),
        np.asarray(ref_quant.dequantize_weight(
            jax.tree.map(lambda a: a[0], want_tree["groups"][0]["mixer"]["wq"]))))


def test_wrapper_refuses_bad_operands():
    x = torch.zeros((4, 8), dtype=torch.int8)
    one = (torch.ones((4, 1)), torch.ones((1, 3)))
    with pytest.raises(ValueError):
        int8_matmul(x, torch.zeros((7, 3), dtype=torch.int8), *one)
    with pytest.raises(TypeError):
        int8_matmul(x.float(), torch.zeros((8, 3), dtype=torch.int8), *one)
    with pytest.raises(TypeError):
        int8_matmul(x, torch.zeros((8, 3), dtype=torch.int8), *one, torch.float16)
    with pytest.raises(ValueError):
        int8_matmul(x, torch.zeros((8, 3), dtype=torch.int8), one[0], torch.ones((1, 4)))
