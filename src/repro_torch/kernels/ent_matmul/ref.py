"""Plain PyTorch versions of the EN-T digit-plane matmuls, 4-plane and
packed (port of ``repro/kernels/ent_matmul/ref.py``).

The int32 products run as float64 matmuls: every partial sum is an
integer below 2**53 (|acc| <= K * 21760 for K <= PACKED_MAX_K), so the
result is exact and equal to the reference's int32 accumulator, on the
CPU and on the card alike (CUDA has no integer matmul).
"""

from __future__ import annotations

import torch

from repro_torch.core.multiplier import planes_to_weight


def quantize_rows(x):
    """Per-row symmetric int8 activation quant: (q int8, scale f32
    [.., 1]).  Keeps the reference's ``x / scale`` and round half to
    even (``torch.round`` rounds half to even like ``jnp.round``)."""
    x32 = x.to(torch.float32)
    amax = x32.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp_min(amax, 1e-12) / 127.0
    return quantize_with_scale(x32, scale), scale


def quantize_with_scale(x, scale):
    """``clip(round(x / scale), -127, 127)`` as int8."""
    q = torch.round(x.to(torch.float32) / scale)
    return torch.clamp(q, -127, 127).to(torch.int8)


def _int_matmul(a, b):
    """Exact integer matmul via float64 (see module docstring) -> int32."""
    return torch.matmul(a.to(torch.float64), b.to(torch.float64)).to(torch.int32)


def ent_matmul_int32_ref(x, planes):
    """Bit-exactness oracle of the 4-plane kernel (no scales): int32."""
    return _int_matmul(x, planes_to_weight(planes))


def ent_matmul_ref(x, planes, scale_x, scale_w, out_dtype=torch.float32):
    """4-plane matmul: reconstruct W from the planes, matmul exactly,
    dequant in the reference's order ``(float(acc) * sx) * sw``."""
    acc = ent_matmul_int32_ref(x, planes)
    return (acc.to(torch.float32) * scale_x * scale_w).to(out_dtype)


def ent_packed_matmul_int32_ref(x, packed):
    """Bit-exactness oracle for the packed kernel (no scales): int32."""
    return _int_matmul(x, packed[0]) + _int_matmul(x, packed[1]) * 16


def ent_packed_matmul_ref(x, packed, scale_x, scale_w, out_dtype=torch.float32):
    """Packed 2-plane matmul over int8 activations with fused dequant in
    the reference's order: ``(float(acc) * sx) * sw``."""
    acc = ent_packed_matmul_int32_ref(x, packed)
    return (acc.to(torch.float32) * scale_x * scale_w).to(out_dtype)


def ent_packed_fused_ref(x_float, packed, scale_w, out_dtype=torch.float32):
    """Fused-quant packed matmul: quantize rows, then packed matmul with
    fused dequant — the plain version of kernel ``ent_matmul_packed_fused``."""
    xq, sx = quantize_rows(x_float)
    return ent_packed_matmul_ref(xq, packed, sx, scale_w, out_dtype)
