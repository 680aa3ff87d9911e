"""Wrappers of the CUDA kernels in ``csrc/ent_matmul.cu``, the EN-T
digit-plane matmuls (replacing the Pallas kernels of
``repro/kernels/ent_matmul/ent_matmul.py``):

* ``ent_matmul_packed_fused`` (``:227``): packed planes, X quantized in
  the kernel's prologue;
* ``ent_matmul_packed`` (``:205``): packed planes, pre-quantized int8 X;
* ``ent_matmul`` (``:75``): the legacy 4-plane form, int8 X.

On a CUDA tensor a wrapper launches its kernel or raises; only CPU
tensors take the plain PyTorch version.  Each wrapper's ``launches``
counts its kernel launches.  ``out_dtype`` is float32 (the default, as
in the reference), bfloat16, or int32 for the int32 accumulator itself
(no epilogue: the quantity the ``*_int32_ref`` oracles return).
"""

from __future__ import annotations

import torch

from repro_torch.core.multiplier import NUM_PACKED_PLANES, PACKED_MAX_K
from repro_torch.kernels import _build
from repro_torch.kernels.ent_matmul.ref import (ent_matmul_int32_ref, ent_matmul_ref,
                                                ent_packed_matmul_int32_ref,
                                                ent_packed_matmul_ref,
                                                quantize_with_scale)

NUM_PLANES = 4
# the kernels' output kinds (csrc/int8_tile.cuh, OutKind)
OUT_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}


def check_operands(x, w, scale_x, scale_w, out_dtype, *, x_dtypes, planes,
                   max_k):
    """Validate ``x [M, K]``, weight planes ``w [planes, K, N]`` (or
    ``[K, N]`` with ``planes=None``) and the scales; returns (M, N, K)."""
    m, k = x.shape
    if planes is None:
        ok = w.dim() == 2 and w.shape[0] == k
    else:
        ok = w.dim() == 3 and w.shape[0] == planes and w.shape[1] == k
    if not ok:
        raise ValueError(f"weight {tuple(w.shape)} does not match X {tuple(x.shape)}"
                         f" ({planes or 'no'} planes)")
    n = w.shape[-1]
    if k > max_k:
        raise ValueError(f"K={k} exceeds {max_k} (int32 overflow bound)")
    if x.dtype not in x_dtypes:
        raise TypeError(f"X must be one of {x_dtypes}, got {x.dtype}")
    if w.dtype != torch.int8:
        raise TypeError(f"weights must be int8, got {w.dtype}")
    if scale_x.shape != (m, 1) or scale_w.shape != (1, n):
        raise ValueError(f"scales {tuple(scale_x.shape)}, {tuple(scale_w.shape)} "
                         f"do not match M={m}, N={n}")
    if scale_x.dtype != torch.float32 or scale_w.dtype != torch.float32:
        raise TypeError("scales must be float32")
    if out_dtype not in OUT_KINDS:
        raise TypeError(f"out_dtype must be one of {tuple(OUT_KINDS)}, got {out_dtype}")
    for t in (x, w, scale_x, scale_w):
        if t.device != x.device:
            raise ValueError("all operands must be on one device")
        if not t.is_contiguous():
            raise ValueError("operands must be contiguous")
    return m, n, k


def ent_matmul_packed_fused(x, packed, scale_x, scale_w, out_dtype=torch.float32):
    """X [M, K] f32/bf16, packed planes int8 [2, K, N], per-row scale
    sx f32 [M, 1] (amax/127, computed by the caller), per-channel sw f32
    [1, N] -> [M, N]: ``(float(Xq @ P0 + (Xq @ P1 << 4)) * sx) * sw``
    with ``Xq = clip(rint(X / sx), -127, 127)``."""
    m, n, k = check_operands(x, packed, scale_x, scale_w, out_dtype,
                             x_dtypes=(torch.float32, torch.bfloat16),
                             planes=NUM_PACKED_PLANES, max_k=PACKED_MAX_K)
    if x.device.type == "cpu":
        xq = quantize_with_scale(x, scale_x)
        if out_dtype == torch.int32:
            return ent_packed_matmul_int32_ref(xq, packed)
        return ent_packed_matmul_ref(xq, packed, scale_x, scale_w, out_dtype)
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m == 0 or n == 0:
        return out
    fn = _build.entry("ent_matmul", "ent_matmul_packed_fused")
    rc = fn(x.data_ptr(), int(x.dtype == torch.bfloat16), packed.data_ptr(),
            scale_x.data_ptr(), scale_w.data_ptr(), out.data_ptr(),
            OUT_KINDS[out_dtype], m, n, k, _build.stream_of(x))
    _build.check(rc, "ent_matmul_packed_fused")
    ent_matmul_packed_fused.launches += 1
    return out


def _planes_call(wrapper, x, planes, scale_x, scale_w, out_dtype, nplanes,
                 int32_ref, ref):
    m, n, k = check_operands(x, planes, scale_x, scale_w, out_dtype,
                             x_dtypes=(torch.int8,), planes=nplanes,
                             max_k=PACKED_MAX_K)
    if x.device.type == "cpu":
        if out_dtype == torch.int32:
            return int32_ref(x, planes)
        return ref(x, planes, scale_x, scale_w, out_dtype)
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m == 0 or n == 0:
        return out
    fn = _build.entry("ent_matmul", "ent_matmul_planes")
    rc = fn(x.data_ptr(), planes.data_ptr(), nplanes, scale_x.data_ptr(),
            scale_w.data_ptr(), out.data_ptr(), OUT_KINDS[out_dtype], m, n, k,
            _build.stream_of(x))
    _build.check(rc, wrapper.__name__)
    wrapper.launches += 1
    return out


def ent_matmul_packed(x, packed, scale_x, scale_w, out_dtype=torch.float32):
    """int8 X [M, K], packed planes int8 [2, K, N], sx f32 [M, 1], sw f32
    [1, N] -> [M, N]: ``(float(X @ P0 + (X @ P1 << 4)) * sx) * sw``."""
    return _planes_call(ent_matmul_packed, x, packed, scale_x, scale_w, out_dtype,
                        NUM_PACKED_PLANES, ent_packed_matmul_int32_ref,
                        ent_packed_matmul_ref)


def ent_matmul(x, planes, scale_x, scale_w, out_dtype=torch.float32):
    """int8 X [M, K], digit planes int8 [4, K, N] in {-2..2}, sx f32
    [M, 1], sw f32 [1, N] -> [M, N]:
    ``(float(sum_i (X @ P_i) << 2i) * sx) * sw``."""
    return _planes_call(ent_matmul, x, planes, scale_x, scale_w, out_dtype,
                        NUM_PLANES, ent_matmul_int32_ref, ent_matmul_ref)


ent_matmul_packed_fused.launches = 0
ent_matmul_packed.launches = 0
ent_matmul.launches = 0
