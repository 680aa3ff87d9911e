"""Public op: EN-T packed matmul from unquantized activations (port of
``repro/kernels/ent_matmul/ops.py``).

``ent_quantized_matmul_fused`` computes the per-row quant scale with a
cheap [M] amax reduction (as the reference does, ``ops.py:94-95``) and
hands X, the packed planes and both scales to the fused kernel, which
quantizes X inside the kernel.  ``use_kernel=False`` asks for the plain
PyTorch version explicitly (a kernel-vs-plain comparison); it is counted
in ``ent_quantized_matmul_fused.plain_launches`` when it runs on the card.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.ent_matmul.ent_matmul import ent_matmul_packed_fused
from repro_torch.kernels.ent_matmul.ref import ent_packed_fused_ref

__all__ = ["ent_quantized_matmul_fused", "row_scale"]


def row_scale(x):
    """Per-row activation quant scale ``max(amax, 1e-12) / 127`` f32 [M, 1]."""
    amax = x.to(torch.float32).abs().amax(dim=-1, keepdim=True)
    return torch.clamp_min(amax, 1e-12) / 127.0


def ent_quantized_matmul_fused(x, packed, scale_w, *, out_dtype=torch.float32,
                               use_kernel: bool = True):
    """x [M, K] f32/bf16, packed [2, K, N] int8, scale_w [1, N] f32."""
    if not use_kernel:
        if x.is_cuda:
            ent_quantized_matmul_fused.plain_launches += 1
        return ent_packed_fused_ref(x, packed, scale_w, out_dtype)
    x = x.contiguous()
    y = ent_matmul_packed_fused(x, packed, row_scale(x), scale_w)
    return y.to(out_dtype)


ent_quantized_matmul_fused.plain_launches = 0
