"""The port's encoders and multiplier models (``repro_torch/core/encoding.py``
and ``core/multiplier.py``) against the reference's, bit for bit: every
function over all int8 and uint8 values and a hypothesis sample of
16-bit ones (64 values a draw: one shape, one trace of each reference
function); the partial-product multipliers over all 65,536 int8 pairs;
the digit-plane and packed matmuls and the numpy oracles; the route of
``ent_plane_matmul`` / ``ent_packed_matmul`` to kernels 5 and 4 on a
non-CPU tensor (meta tensors and a recorder); and ``chip_smoke.py``'s
encoder checks with the planted fault "carry into the next digit
ignored"."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
from _hypothesis_compat import given, settings, st  # noqa: E402

from repro.core import encoding as ref_enc  # noqa: E402
from repro.core import multiplier as ref_mul  # noqa: E402
from repro_torch.core import encoding as enc  # noqa: E402
from repro_torch.core import multiplier as mul  # noqa: E402
from repro_torch.kernels.ent_matmul import ent_matmul as kmod  # noqa: E402

INT8 = np.arange(-128, 128, dtype=np.int32)
UINT8 = np.arange(256, dtype=np.int32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def _equal(port, ref):
    """Outputs (tensors, arrays or tuples of them) equal in values and
    int32-ness."""
    port = port if isinstance(port, tuple) else (port,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    assert len(port) == len(ref)
    for p, r in zip(port, ref):
        p, r = _np(p), _np(r)
        assert p.shape == r.shape
        assert p.dtype == r.dtype, (p.dtype, r.dtype)
        np.testing.assert_array_equal(p, r)


def _both(name, x, *rest):
    """``encoding.<name>`` of the port and of the reference on ``x``."""
    return (getattr(enc, name)(torch.from_numpy(np.asarray(x)), *rest),
            getattr(ref_enc, name)(jnp.asarray(x), *rest))


UNSIGNED_FNS = ("radix4_digits", "ent_encode_unsigned", "ent_encode_bitlevel")
SIGNED_FNS = ("ent_encode_signed", "mbe_encode", "mbe_control_lines")


@pytest.mark.parametrize("name", UNSIGNED_FNS)
@pytest.mark.parametrize("values,n_bits", [(UINT8, 8), (UINT8[:16], 4), (INT8 + 128, 10)],
                         ids=["uint8", "uint4", "10-bit"])
def test_unsigned_encoders_equal_reference(name, values, n_bits):
    _equal(*_both(name, values, n_bits))


@pytest.mark.parametrize("name", SIGNED_FNS)
@pytest.mark.parametrize("n_bits", [8, 10])
def test_signed_encoders_equal_reference(name, n_bits):
    _equal(*_both(name, INT8, n_bits))


@settings(max_examples=200, deadline=None)
@given(st.lists(st.integers(0, 2**16 - 1), min_size=64, max_size=64))
def test_16_bit_unsigned_sample(values):
    x = np.asarray(values, np.int32)
    for name in UNSIGNED_FNS:
        _equal(*_both(name, x, 16))
    w, carry = enc.ent_encode_unsigned(torch.from_numpy(x), 16)
    np.testing.assert_array_equal(enc.ent_decode_unsigned(w, carry), x)
    np.testing.assert_array_equal(enc.ent_decode_unsigned(w, carry),
                                  ref_enc.ent_decode_unsigned(*ref_enc.ent_encode_unsigned(
                                      jnp.asarray(x), 16)))


@settings(max_examples=200, deadline=None)
@given(st.lists(st.integers(-(2**15), 2**15 - 1), min_size=64, max_size=64))
def test_16_bit_signed_sample(values):
    x = np.asarray(values, np.int32)
    for name in SIGNED_FNS:
        _equal(*_both(name, x, 16))
    np.testing.assert_array_equal(enc.ent_decode_signed(*enc.ent_encode_signed(
        torch.from_numpy(x), 16)), x)
    np.testing.assert_array_equal(enc.mbe_decode(enc.mbe_encode(torch.from_numpy(x), 16)), x)


def test_decoders_equal_reference():
    for values, n_bits in ((UINT8, 8), (INT8 + 128, 10)):
        port, ref = _both("ent_encode_unsigned", values, n_bits)
        _equal(enc.ent_decode_unsigned(*port), ref_enc.ent_decode_unsigned(*ref))
        _equal(enc.ent_decode_unsigned(*port), values.astype(np.int64))
    port, ref = _both("ent_encode_signed", INT8, 8)
    _equal(enc.ent_decode_signed(*port), ref_enc.ent_decode_signed(*ref))
    port, ref = _both("mbe_encode", INT8, 8)
    _equal(enc.mbe_decode(port), ref_enc.mbe_decode(ref))
    _equal(enc.mbe_decode(port), INT8.astype(np.int64))


def test_digit_codes_and_bit_counts_equal_reference():
    _equal(*_both("pack_ent_digits", np.array([-1, 0, 1, 2, 2, -1], np.int32)))
    _equal(*_both("unpack_ent_digits", np.array([0, 1, 2, 3, 3, 0], np.int32)))
    for n_bits in range(2, 34, 2):
        for name in ("ent_encoded_bits", "mbe_encoded_bits", "ent_num_encoders",
                     "mbe_num_encoders"):
            assert getattr(enc, name)(n_bits) == getattr(ref_enc, name)(n_bits)
    with pytest.raises(ValueError):
        enc.radix4_digits(torch.tensor([1]), 7)
    assert enc.__all__ == ref_enc.__all__
    w, c = enc.np_ent_encode_unsigned(UINT8, 8)
    rw, rc = ref_enc.np_ent_encode_unsigned(UINT8, 8)
    _equal((w, c), (rw, rc))


def test_encoders_keep_the_device_and_take_python_ints():
    sign, w, carry = enc.ent_encode_signed(78, 8)
    assert int(sign) == 0 and w.tolist() == [2, -1, 1, 1] and int(carry) == 0
    x = torch.arange(4, dtype=torch.int8, device="meta")
    assert enc.ent_encode_unsigned(x, 8)[0].device.type == "meta"


# .. multiplier ..

PAIRS = np.meshgrid(INT8, INT8, indexing="ij")


@pytest.mark.parametrize("name", ["mbe_partial_products", "ent_partial_products",
                                  "mbe_multiply", "ent_multiply"])
def test_multipliers_equal_reference_on_all_int8_pairs(name):
    a, b = PAIRS
    port = getattr(mul, name)(torch.from_numpy(a), torch.from_numpy(b), 8)
    ref = getattr(ref_mul, name)(jnp.asarray(a), jnp.asarray(b), 8)
    _equal(port, ref)
    if name.endswith("multiply"):
        np.testing.assert_array_equal(port.numpy(), a * b)


@settings(max_examples=100, deadline=None)
@given(st.lists(st.tuples(st.integers(-(2**15), 2**15 - 1),
                          st.integers(-(2**15), 2**15 - 1)), min_size=32, max_size=32))
def test_16_bit_multipliers_sample(pairs):
    a = np.asarray([p[0] for p in pairs], np.int32)
    b = np.asarray([p[1] for p in pairs], np.int32)
    for name in ("mbe_partial_products", "ent_partial_products", "mbe_multiply",
                 "ent_multiply"):
        port = getattr(mul, name)(torch.from_numpy(a), torch.from_numpy(b), 16)
        _equal(port, getattr(ref_mul, name)(jnp.asarray(a), jnp.asarray(b), 16))


def test_planes_equal_reference_on_all_int8_values():
    w8 = INT8.astype(np.int8).reshape(16, 16)
    planes = mul.ent_digit_planes(torch.from_numpy(w8))
    _equal(planes, ref_mul.ent_digit_planes(jnp.asarray(w8)))
    assert planes.is_contiguous()
    _equal(mul.planes_to_weight(planes), ref_mul.planes_to_weight(jnp.asarray(planes.numpy())))
    packed = mul.pack_planes(planes)
    _equal(packed, ref_mul.pack_planes(jnp.asarray(planes.numpy())))
    _equal(mul.unpack_planes(packed), ref_mul.unpack_planes(jnp.asarray(packed.numpy())))
    _equal(mul.packed_to_weight(packed), ref_mul.packed_to_weight(jnp.asarray(packed.numpy())))
    _equal(mul.ent_packed_planes(torch.from_numpy(w8)),
           ref_mul.ent_packed_planes(jnp.asarray(w8)))
    _equal(mul.np_pack_planes(planes.numpy()), ref_mul.np_pack_planes(planes.numpy()))
    for name in ("NUM_INT8_PLANES", "NUM_PACKED_PLANES", "PACKED_RADIX", "PACKED_MAX_K"):
        assert getattr(mul, name) == getattr(ref_mul, name)
    assert mul.__all__ == ref_mul.__all__


@pytest.mark.parametrize("m,k,n", [(8, 64, 32), (3, 300, 17), (33, 1024, 65)])
def test_plane_matmuls_equal_reference(m, k, n):
    rng = np.random.default_rng(m * k + n)
    x = rng.integers(-128, 128, (m, k), dtype=np.int8)
    w = rng.integers(-128, 128, (k, n), dtype=np.int8)
    want = x.astype(np.int32) @ w.astype(np.int32)
    planes = mul.ent_digit_planes(torch.from_numpy(w))
    got = mul.ent_plane_matmul(torch.from_numpy(x), planes)
    _equal(got, ref_mul.ent_plane_matmul(jnp.asarray(x), jnp.asarray(planes.numpy())))
    _equal(got, want)
    got = mul.ent_packed_matmul(torch.from_numpy(x), mul.pack_planes(planes))
    _equal(got, ref_mul.ent_packed_matmul(jnp.asarray(x),
                                          jnp.asarray(mul.pack_planes(planes).numpy())))
    _equal(got, want)
    _equal(mul.np_ent_plane_matmul(x, w), ref_mul.np_ent_plane_matmul(x, w))
    _equal(mul.np_ent_packed_matmul(x, w), ref_mul.np_ent_packed_matmul(x, w))


@pytest.mark.parametrize("name,launcher,planes", [("ent_plane_matmul", "_launch_planes", 4),
                                                  ("ent_packed_matmul", "_launch_packed", 2)])
def test_card_route_launches_kernel_with_int32_output(monkeypatch, name, launcher, planes):
    """Off the CPU the matmul hands its operands to kernel 5 (four planes)
    or 4 (packed) with unit scales and an int32 output, on the route of
    the wrapper's own cut."""
    calls = []

    def record(x, w, sx, sw, out_dtype, route):
        calls.append((tuple(x.shape), tuple(w.shape), sx, sw, out_dtype, route))
        return torch.empty((x.shape[0], w.shape[-1]), dtype=out_dtype, device=x.device)

    monkeypatch.setattr(kmod, launcher, record)
    for m in (8, 512):
        x = torch.empty((m, 64), dtype=torch.int8, device="meta")
        w = torch.empty((planes, 64, 32), dtype=torch.int8, device="meta")
        out = getattr(mul, name)(x, w)
        assert out.dtype == torch.int32 and out.shape == (m, 32)
    cut = kmod.M_STREAM_PLANES if planes == 4 else kmod.M_STREAM_PACKED
    assert [c[5] for c in calls] == [kmod.route_of(8, cut), kmod.route_of(512, cut)]
    for shape_x, shape_w, sx, sw, out_dtype, _ in calls:
        assert out_dtype == torch.int32 and sx.shape == (shape_x[0], 1)
        assert sw.shape == (1, 32) and sx.dtype == sw.dtype == torch.float32


# .. chip_smoke.py's encoder checks, on the CPU ..

@pytest.fixture(scope="module")
def cs():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_encoders", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.DEV = "cpu"
    return mod


SMALL = ((8, 64, 32), (5, 256, 48))


def test_chip_smoke_encoder_checks_pass(cs):
    assert cs.encoder_functions(torch, "cpu") == []
    bad = cs.encoder_products(torch, "cpu", SMALL)
    assert bad and not any(bad.values()), bad


def test_planted_carry_fault_is_caught(cs):
    """The fault changes every value with a radix-4 digit 3: every EN-T
    product a * b (b != 0) with such an |a| (148 of the 256 int8 values),
    no MBE product, the 16-bit round trip and both matmuls."""
    with cs.planted(enc, "ent_encode_unsigned", cs.carry_dropped):
        bad = cs.encoder_products(torch, "cpu", SMALL)
    assert bad["ent_multiply"] == 148 * 255
    assert bad["mbe_multiply"] == 0
    digit3 = sum(any((v >> (2 * j)) & 3 == 3 for j in range(8)) for v in range(2**16))
    assert bad["ent decode(encode(x)), 16-bit"] == digit3
    assert all(v > 0 for k, v in bad.items() if "matmul" in k)
    assert enc.ent_encode_unsigned is not None and cs.encoder_products(torch, "cpu", SMALL[:1])[
        "ent_multiply"] == 0   # the fault is gone after the block
