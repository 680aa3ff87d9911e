"""EN-T digit planes and packed planes in PyTorch (port of
``repro/core/multiplier.py:50-59, 107-221``).

An int8 weight is pre-encoded once (the paper's hoisted edge encoder)
into four signed radix-4 digit planes p_i in {-2..2} with
``W = sum_i p_i 4^i``; adjacent pairs pack into two int8 planes
``packed_j = p_2j + 4 p_2j+1`` in [-10, 10], so ``W = packed_0 +
16 packed_1`` and ``X @ W == (X @ packed_0) + ((X @ packed_1) << 4)``
bit-exactly in int32 for any K <= PACKED_MAX_K.

All arithmetic is int32 on the tensor's own device; every function is
bit-exact with the reference for all 256 int8 values.
"""

from __future__ import annotations

import torch

__all__ = ["ent_digit_planes", "planes_to_weight", "pack_planes",
           "unpack_planes", "packed_to_weight", "ent_packed_planes",
           "NUM_PACKED_PLANES", "PACKED_MAX_K"]

# adjacent plane pairs fused: an int8 weight needs 2 packed planes
NUM_PACKED_PLANES = 2

# int32-overflow-safe contraction bound for the packed matmul: the
# accumulator sums K products |x*packed_0| + |x*packed_1*16|
# <= 128 * 10 * (1 + 16) = 21760
PACKED_MAX_K = (2**31 - 1) // (128 * 10 * 17)


def _ent_encode_unsigned(x, n_bits: int):
    """EN-T carry-chain digit-set conversion of unsigned ``x``: radix-4
    digits a_i in {0..3} become w_i in {-1..2} plus a final carry."""
    ws = []
    cin = torch.zeros_like(x)
    for i in range(n_bits // 2):
        ap = ((x >> (2 * i)) & 3) + cin
        hi = ap >= 3
        ws.append(torch.where(hi, ap - 4, ap))
        cin = hi.to(torch.int32)
    return torch.stack(ws, dim=0), cin


def ent_digit_planes(w_int8):
    """int8 weights -> int8 [4, *w.shape] signed digit planes in {-2..2}
    with ``w == sum_i planes[i] * 4**i`` exactly."""
    if w_int8.dtype != torch.int8:
        raise TypeError(f"expected int8 weights, got {w_int8.dtype}")
    x = w_int8.to(torch.int32)
    # int8 magnitude <= 128 < 192, so the carry-out is always 0
    w, _ = _ent_encode_unsigned(x.abs(), 8)
    return torch.where(x < 0, -w, w).to(torch.int8)


def planes_to_weight(planes):
    """Inverse of :func:`ent_digit_planes` (int32 result)."""
    out = torch.zeros(planes.shape[1:], dtype=torch.int32,
                      device=planes.device)
    for i in range(planes.shape[0]):
        out += planes[i].to(torch.int32) << (2 * i)
    return out


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
