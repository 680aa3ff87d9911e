"""Plain PyTorch version of the w8a8 matmul kernel (port of
``repro/kernels/int8_matmul/ref.py``).

The int32 product runs as a float64 matmul, exact for every partial sum
below 2**53 (|acc| <= K * 128 * 127), on the CPU and on the card alike.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.ent_matmul.ref import _int_matmul


def int8_matmul_int32_ref(x, w):
    """int8 X [M, K] @ int8 W [K, N] -> the int32 accumulator."""
    return _int_matmul(x, w)


def int8_matmul_ref(x, w, scale_x, scale_w, out_dtype=torch.bfloat16):
    """``(float(X @ W) * sx) * sw`` in ``out_dtype``."""
    acc = int8_matmul_int32_ref(x, w)
    return (acc.to(torch.float32) * scale_x * scale_w).to(out_dtype)
