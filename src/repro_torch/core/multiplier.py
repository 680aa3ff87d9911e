"""Bit-exact multiplier models built from the paper's encodings (§3.1),
and EN-T digit planes and packed planes, in PyTorch (port of
``repro/core/multiplier.py``).

A hardware multiplier is encode -> partial products -> compress -> add.
:func:`mbe_multiply` and :func:`ent_multiply` reproduce that pipeline
arithmetically, so the EN-T encoding is shown to compute exact products
and the partial-product rows can be counted for the silicon cost model.

An int8 weight is pre-encoded once (the paper's hoisted edge encoder)
into four signed radix-4 digit planes p_i in {-2..2} with
``W = sum_i p_i 4^i``; adjacent pairs pack into two int8 planes
``packed_j = p_2j + 4 p_2j+1`` in [-10, 10], so ``W = packed_0 +
16 packed_1`` and ``X @ W == (X @ packed_0) + ((X @ packed_1) << 4)``
bit-exactly in int32 for any K <= PACKED_MAX_K.

All arithmetic is int32 on the tensor's own device.  PyTorch has no int32
matmul on CUDA, so on the card :func:`ent_plane_matmul` runs kernel 5
(``ent_matmul``, four planes) and :func:`ent_packed_matmul` kernel 4
(``ent_matmul_packed``), each with unit scales and its int32 accumulator
as the output; on CPU tensors those wrappers run their plain int32
versions.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import encoding as enc

__all__ = [
    "mbe_partial_products",
    "ent_partial_products",
    "mbe_multiply",
    "ent_multiply",
    "ent_digit_planes",
    "planes_to_weight",
    "ent_plane_matmul",
    "pack_planes",
    "unpack_planes",
    "packed_to_weight",
    "ent_packed_planes",
    "ent_packed_matmul",
    "np_pack_planes",
    "np_ent_packed_matmul",
    "NUM_INT8_PLANES",
    "NUM_PACKED_PLANES",
    "PACKED_RADIX",
    "PACKED_MAX_K",
]

# int8 magnitude <= 128 < 192 => EN-T carry-out is always 0, so an int8
# weight needs exactly 4 signed digit planes
NUM_INT8_PLANES = 4

# adjacent plane pairs fused: an int8 weight needs 2 packed planes
NUM_PACKED_PLANES = 2
PACKED_RADIX = 4  # weight of the odd plane inside a packed pair

# int32-overflow-safe contraction bound for the packed matmul: the
# accumulator sums K products |x*packed_0| + |x*packed_1*16|
# <= 128 * 10 * (1 + 16) = 21760
PACKED_MAX_K = (2**31 - 1) // (128 * 10 * 17)


def _weights(n: int, device) -> torch.Tensor:
    return torch.tensor([4**i for i in range(n)], dtype=torch.int32, device=device)


def _b(b, like: torch.Tensor) -> torch.Tensor:
    if isinstance(b, torch.Tensor):
        return b.to(torch.int32)
    return torch.as_tensor(np.asarray(b), dtype=torch.int32, device=like.device)


def mbe_partial_products(a, b, n_bits: int):
    """Partial-product rows of a*b via MBE: rows[i] = m_i * b * 4^i.

    Returns int32 [..., N]; sum over the last axis == a * b exactly.
    Each row is a shift/negate of b (m_i in {-2,...,2}), which is what the
    Booth selector mux produces in hardware.
    """
    m = enc.mbe_encode(a, n_bits)
    return m * _b(b, m)[..., None] * _weights(m.shape[-1], m.device)


def ent_partial_products(a, b, n_bits: int):
    """Partial-product rows of a*b via the EN-T encoding.

    Encodes |a| into digits w_i plus carry, applies the sign of a to b
    (the hardware -B mux of §3.3.1).  Returns int32 [..., N+1] rows
    (last row is the carry row, identically 0 for int8); sum == a * b.
    """
    sign, w, carry = enc.ent_encode_signed(a, n_bits)
    b = _b(b, w)
    bsel = torch.where(sign == 1, -b, b)[..., None]
    n = w.shape[-1]
    rows = w * bsel * _weights(n, w.device)
    carry_row = carry[..., None] * bsel * (4**n)
    return torch.cat([rows, carry_row], dim=-1)


def mbe_multiply(a, b, n_bits: int):
    """a*b via MBE partial products (bit-exact)."""
    return torch.sum(mbe_partial_products(a, b, n_bits), dim=-1).to(torch.int32)


def ent_multiply(a, b, n_bits: int):
    """a*b via EN-T partial products (bit-exact)."""
    return torch.sum(ent_partial_products(a, b, n_bits), dim=-1).to(torch.int32)


# ----------------------------------------------------------------------------
# Digit planes: the "encode once at the edge, reuse across the array" form.
# ----------------------------------------------------------------------------

def ent_digit_planes(w_int8):
    """int8 weights -> int8 [4, *w.shape] signed digit planes in {-2..2}
    with ``w == sum_i planes[i] * 4**i`` exactly."""
    if w_int8.dtype != torch.int8:
        raise TypeError(f"expected int8 weights, got {w_int8.dtype}")
    sign, w, _ = enc.ent_encode_signed(w_int8, 8)   # carry: always 0 for int8
    signed = torch.where(sign[..., None] == 1, -w, w)   # [..., 4]
    return torch.movedim(signed, -1, 0).to(torch.int8).contiguous()


def planes_to_weight(planes):
    """Inverse of :func:`ent_digit_planes` (int32 result)."""
    out = torch.zeros(planes.shape[1:], dtype=torch.int32,
                      device=planes.device)
    for i in range(planes.shape[0]):
        out += planes[i].to(torch.int32) << (2 * i)
    return out


def _unit_scales(x, n):
    return (torch.ones((x.shape[0], 1), dtype=torch.float32, device=x.device),
            torch.ones((1, n), dtype=torch.float32, device=x.device))


def ent_plane_matmul(x_int8, planes):
    """X @ W computed from pre-encoded digit planes, bit-exact in int32.

    x_int8: [m, k] int8 activations; planes: [4, k, n] int8 digit planes,
    k <= PACKED_MAX_K.  Returns int32 [m, n] == x.int32 @
    planes_to_weight(planes): kernel 5 with unit scales and its int32
    accumulator as the output (its wrapper's plain version on the CPU).
    """
    from repro_torch.kernels.ent_matmul.ent_matmul import ent_matmul
    x, planes = x_int8.contiguous(), planes.contiguous()
    return ent_matmul(x, planes, *_unit_scales(x, planes.shape[-1]), torch.int32)


def pack_planes(planes):
    """4 digit planes [4, ...] -> 2 packed planes [2, ...] int8:
    ``packed[j] = planes[2j] + 4 * planes[2j+1]``."""
    if planes.shape[0] % 2:
        raise ValueError(f"need an even number of planes, got {planes.shape[0]}")
    lo = planes[0::2].to(torch.int32)
    hi = planes[1::2].to(torch.int32)
    return (lo + hi * 4).to(torch.int8)


def unpack_planes(packed):
    """Packed planes [P, ...] -> canonical digit planes [2P, ...]:
    ``hi = clip(floor((p + 2) / 4), -2, 2)``, ``lo = p - 4 hi``."""
    p = packed.to(torch.int32)
    hi = torch.clamp((p + 2) >> 2, -2, 2)
    lo = p - hi * 4
    out = torch.stack([lo, hi], dim=1)            # [P, 2, ...]
    return out.reshape((2 * p.shape[0],) + tuple(p.shape[1:])).to(torch.int8)


def packed_to_weight(packed):
    """``sum_j packed[j] * 16**j`` (int32)."""
    out = torch.zeros(packed.shape[1:], dtype=torch.int32,
                      device=packed.device)
    for j in range(packed.shape[0]):
        out += packed[j].to(torch.int32) << (4 * j)
    return out


def ent_packed_planes(w_int8):
    """Hoisted edge encoder, packed form: int8 weights -> [2, ...] int8."""
    return pack_planes(ent_digit_planes(w_int8))


def ent_packed_matmul(x_int8, packed):
    """X @ W from packed planes: 2 int8 matmuls + 1 shift-add, bit-exact.

    x_int8: [m, k] int8; packed: [2, k, n] int8 packed planes, k <=
    PACKED_MAX_K.  Returns int32 [m, n] == x.int32 @
    packed_to_weight(packed): kernel 4 with unit scales and its int32
    accumulator as the output (its wrapper's plain version on the CPU).
    """
    from repro_torch.kernels.ent_matmul.ent_matmul import ent_matmul_packed
    x, packed = x_int8.contiguous(), packed.contiguous()
    return ent_matmul_packed(x, packed, *_unit_scales(x, packed.shape[-1]), torch.int32)


# Pure-numpy oracle (independent of the torch implementation) ----------------

def np_ent_plane_matmul(x: np.ndarray, w: np.ndarray) -> np.ndarray:
    """Oracle: decompose w with the numpy encoder, matmul in int64."""
    sign = w < 0
    mag = np.abs(w.astype(np.int64))
    digits, carry = enc.np_ent_encode_unsigned(mag, 8)
    assert np.all(carry == 0)
    planes = np.where(sign[None, ...], -np.moveaxis(digits, -1, 0), np.moveaxis(digits, -1, 0))
    out = np.zeros((x.shape[0], w.shape[1]), np.int64)
    for i in range(4):
        out += (x.astype(np.int64) @ planes[i]) << (2 * i)
    return out


def np_pack_planes(planes: np.ndarray) -> np.ndarray:
    """Numpy oracle of :func:`pack_planes` (int64 internally)."""
    planes = np.asarray(planes, np.int64)
    assert planes.shape[0] % 2 == 0
    return (planes[0::2] + 4 * planes[1::2]).astype(np.int8)


def np_ent_packed_matmul(x: np.ndarray, w: np.ndarray) -> np.ndarray:
    """Oracle: encode w with the numpy encoder, pack, matmul in int64."""
    sign = w < 0
    mag = np.abs(w.astype(np.int64))
    digits, carry = enc.np_ent_encode_unsigned(mag, 8)
    assert np.all(carry == 0)
    planes = np.where(sign[None, ...], -np.moveaxis(digits, -1, 0),
                      np.moveaxis(digits, -1, 0))
    packed = np_pack_planes(planes).astype(np.int64)
    out = x.astype(np.int64) @ packed[0]
    out += (x.astype(np.int64) @ packed[1]) << 4
    return out
