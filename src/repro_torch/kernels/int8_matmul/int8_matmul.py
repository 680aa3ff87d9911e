"""Wrapper of the CUDA kernel ``csrc/int8_matmul.cu``: the w8a8 int8
matmul with fused dequant scales (replaces the Pallas ``int8_matmul``,
``repro/kernels/int8_matmul/int8_matmul.py:47``).

On a CUDA tensor the wrapper launches the kernel or raises; only CPU
tensors take the plain PyTorch version.  Like kernel 1's wrapper it
routes by M, with its own cut: up to ``M_STREAM`` rows (the decode shape)
the split-K weight stream (``csrc/int8_stream.cuh``, one plane), counted
in ``int8_matmul.stream_launches``; above, the int8 tensor-core loop
(``csrc/int8_tc.cuh``), counted in ``int8_matmul.tc_launches``; both among
``int8_matmul.launches``.  Both routes share kernel 1's plans and split-K
workspace.  ``out_dtype`` is bfloat16 (the default, as in the reference),
float32, or int32 for the int32 accumulator itself.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ent_matmul.ent_matmul import (OUT_KINDS, check_operands, count_launch,
                                                       launch_route, route_of)
from repro_torch.kernels.int8_matmul.ref import int8_matmul_int32_ref, int8_matmul_ref

# int32-overflow-safe contraction bound: |x * w| <= 128 * 128
INT8_MAX_K = (2**31 - 1) // (128 * 128)
# Kernel 6 takes the split-K weight stream up to M_STREAM rows, the
# tensor-core loop above: the largest M of chip_smoke.py's check_cut table
# for kernel 6 up to which the stream takes less time over a layer's seven
# qwen2.5-3b projections (PERF.md)
M_STREAM = 16

_ENTRIES = {"stream": "int8_matmul_stream", "tc": "int8_matmul_tc", "tile": "int8_matmul"}


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
    return _launch(x, w, scale_x, scale_w, out_dtype, route_of(m, M_STREAM))


def _launch(x, w, scale_x, scale_w, out_dtype, route: str):
    """Launch kernel 6 on checked card operands through ``route``
    ("stream", "tc" or "tile"); the wrapper chooses by M, chip_smoke.py
    calls this to time the three loops at one M."""
    m, k = x.shape
    n = w.shape[-1]
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m == 0 or n == 0:
        return out
    lead = (x.data_ptr(), w.data_ptr(), scale_x.data_ptr(), scale_w.data_ptr(),
            out.data_ptr(), OUT_KINDS[out_dtype])
    rc = launch_route("int8_matmul", _ENTRIES, lead, x, m, n, k, route)
    _build.check(rc, "int8_matmul")
    count_launch(int8_matmul, route)
    return out


int8_matmul.launches = 0
int8_matmul.stream_launches = 0
int8_matmul.tc_launches = 0
