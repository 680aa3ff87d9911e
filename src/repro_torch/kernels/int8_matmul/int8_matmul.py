"""Wrapper of the CUDA kernel ``csrc/int8_matmul.cu``: the w8a8 int8
matmul with fused dequant scales (replaces the Pallas ``int8_matmul``,
``repro/kernels/int8_matmul/int8_matmul.py:47``).

On a CUDA tensor the wrapper launches the kernel or raises; only CPU
tensors take the plain PyTorch version.  ``int8_matmul.launches`` counts
kernel launches.  ``out_dtype`` is bfloat16 (the default, as in the
reference), float32, or int32 for the int32 accumulator itself.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ent_matmul.ent_matmul import OUT_KINDS, check_operands
from repro_torch.kernels.int8_matmul.ref import int8_matmul_int32_ref, int8_matmul_ref

# int32-overflow-safe contraction bound: |x * w| <= 128 * 128
INT8_MAX_K = (2**31 - 1) // (128 * 128)


def int8_matmul(x, w, scale_x, scale_w, out_dtype=torch.bfloat16):
    """int8 X [M, K], int8 W [K, N], per-row sx f32 [M, 1], per-channel
    sw f32 [1, N] -> [M, N]: ``(float(X @ W) * sx) * sw``."""
    m, n, k = check_operands(x, w, scale_x, scale_w, out_dtype,
                             x_dtypes=(torch.int8,), planes=None,
                             max_k=INT8_MAX_K)
    if x.device.type == "cpu":
        if out_dtype == torch.int32:
            return int8_matmul_int32_ref(x, w)
        return int8_matmul_ref(x, w, scale_x, scale_w, out_dtype)
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m == 0 or n == 0:
        return out
    fn = _build.entry("int8_matmul")
    rc = fn(x.data_ptr(), w.data_ptr(), scale_x.data_ptr(), scale_w.data_ptr(),
            out.data_ptr(), OUT_KINDS[out_dtype], m, n, k, _build.stream_of(x))
    _build.check(rc, "int8_matmul")
    int8_matmul.launches += 1
    return out


int8_matmul.launches = 0
