"""Wrapper of the CUDA kernel ``csrc/ent_matmul.cu``: the packed fused
EN-T matmul (replaces the Pallas ``ent_matmul_packed_fused``,
``repro/kernels/ent_matmul/ent_matmul.py:227``).

On a CUDA tensor the wrapper launches the kernel or raises; only CPU
tensors take the plain PyTorch version.  ``ent_matmul_packed_fused.launches``
counts kernel launches.
"""

from __future__ import annotations

import torch

from repro_torch.core.multiplier import NUM_PACKED_PLANES, PACKED_MAX_K
from repro_torch.kernels import _build
from repro_torch.kernels.ent_matmul.ref import (ent_packed_matmul_ref,
                                                quantize_with_scale)



def _check(x, packed, scale_x, scale_w):
    m, k = x.shape
    if packed.dim() != 3 or packed.shape[0] != NUM_PACKED_PLANES or packed.shape[1] != k:
        raise ValueError(f"packed planes {tuple(packed.shape)} do not match X {tuple(x.shape)}")
    n = packed.shape[2]
    if k > PACKED_MAX_K:
        raise ValueError(f"K={k} exceeds PACKED_MAX_K={PACKED_MAX_K} (int32 overflow bound)")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"X must be float32 or bfloat16, got {x.dtype}")
    if packed.dtype != torch.int8:
        raise TypeError(f"packed planes must be int8, got {packed.dtype}")
    if scale_x.shape != (m, 1) or scale_w.shape != (1, n):
        raise ValueError(f"scales {tuple(scale_x.shape)}, {tuple(scale_w.shape)} "
                         f"do not match M={m}, N={n}")
    if scale_x.dtype != torch.float32 or scale_w.dtype != torch.float32:
        raise TypeError("scales must be float32")
    for t in (x, packed, scale_x, scale_w):
        if t.device != x.device:
            raise ValueError("all operands must be on one device")
        if not t.is_contiguous():
            raise ValueError("operands must be contiguous")
    return m, n, k


def ent_matmul_packed_fused(x, packed, scale_x, scale_w):
    """X [M, K] f32/bf16, packed planes int8 [2, K, N], per-row scale
    sx f32 [M, 1] (amax/127, computed by the caller), per-channel sw f32
    [1, N] -> f32 [M, N]: ``(float(Xq @ P0 + (Xq @ P1 << 4)) * sx) * sw``
    with ``Xq = clip(rint(X / sx), -127, 127)``."""
    m, n, k = _check(x, packed, scale_x, scale_w)
    if x.device.type == "cpu":
        return ent_packed_matmul_ref(quantize_with_scale(x, scale_x), packed,
                                     scale_x, scale_w)
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return out
    fn = _build.entry("ent_matmul")
    rc = fn(x.data_ptr(), int(x.dtype == torch.bfloat16), packed.data_ptr(),
            scale_x.data_ptr(), scale_w.data_ptr(), out.data_ptr(), m, n, k,
            _build.stream_of(x))
    _build.check(rc, "ent_matmul_packed_fused")
    ent_matmul_packed_fused.launches += 1
    return out


ent_matmul_packed_fused.launches = 0
