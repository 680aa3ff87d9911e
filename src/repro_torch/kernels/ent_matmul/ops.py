"""Public ops: EN-T encoded matmuls and the weight encoders (port of
``repro/kernels/ent_matmul/ops.py``).

Three matmuls, slowest to fastest serving path, each over its kernel:

* ``ent_quantized_matmul``        — the legacy 4-plane form, int8 X;
* ``ent_quantized_matmul_packed`` — packed 2-plane form, int8 X;
* ``ent_quantized_matmul_fused``  — packed planes from f32/bf16 X: it
  computes the per-row quant scale with a cheap [M] amax reduction (as
  the reference does, ``ops.py:94-95``) and the kernel quantizes X in
  its prologue.

``use_kernel=False`` asks for the plain PyTorch version explicitly (a
kernel-vs-plain comparison); each op counts it in its ``plain_launches``
when it runs on the card.
"""

from __future__ import annotations

import torch

from repro_torch.core.multiplier import ent_digit_planes, ent_packed_planes
from repro_torch.kernels import cost as C
from repro_torch.kernels.ent_matmul.ent_matmul import (ent_matmul, ent_matmul_packed,
                                                       ent_matmul_packed_fused)
from repro_torch.kernels.ent_matmul.ref import (ent_matmul_ref, ent_packed_fused_ref,
                                                ent_packed_matmul_ref)

__all__ = ["encode_weights", "encode_weights_packed", "ent_quantized_matmul",
           "ent_quantized_matmul_packed", "ent_quantized_matmul_fused",
           "row_scale"]


def encode_weights(w_int8):
    """Hoisted edge encoder: int8 weights [K, N] -> [4, K, N] digit
    planes, once per weight."""
    return ent_digit_planes(w_int8)


def encode_weights_packed(w_int8):
    """Edge encoder, packed form: int8 weights [K, N] -> [2, K, N]
    packed planes (half the bytes and half the products of the 4-plane
    form)."""
    return ent_packed_planes(w_int8)


def row_scale(x):
    """Per-row activation quant scale ``max(amax, 1e-12) / 127`` f32 [M, 1]."""
    amax = x.to(torch.float32).abs().amax(dim=-1, keepdim=True)
    return torch.clamp_min(amax, 1e-12) / 127.0


def _plain(op, x):
    if x.is_cuda:
        op.plain_launches += 1


def ent_quantized_matmul(x, planes, scale_x, scale_w, *, out_dtype=torch.float32,
                         use_kernel: bool = True):
    """x [M, K] int8, planes [4, K, N] int8, sx [M, 1], sw [1, N] f32."""
    if not use_kernel:
        _plain(ent_quantized_matmul, x)
        return ent_matmul_ref(x, planes, scale_x, scale_w, out_dtype)
    return ent_matmul(x.contiguous(), planes, scale_x.contiguous(), scale_w,
                      out_dtype)


def ent_quantized_matmul_packed(x, packed, scale_x, scale_w, *,
                                out_dtype=torch.float32, use_kernel: bool = True):
    """Packed 2-plane matmul over pre-quantized int8 activations."""
    if not use_kernel:
        _plain(ent_quantized_matmul_packed, x)
        return ent_packed_matmul_ref(x, packed, scale_x, scale_w, out_dtype)
    return ent_matmul_packed(x.contiguous(), packed, scale_x.contiguous(), scale_w,
                             out_dtype)


def ent_quantized_matmul_fused(x, packed, scale_w, *, out_dtype=torch.float32,
                               use_kernel: bool = True):
    """x [M, K] f32/bf16, packed [2, K, N] int8, scale_w [1, N] f32."""
    if not use_kernel:
        _plain(ent_quantized_matmul_fused, x)
        return ent_packed_fused_ref(x, packed, scale_w, out_dtype)
    x = x.contiguous()
    return ent_matmul_packed_fused(x, packed, row_scale(x), scale_w, out_dtype)


ent_quantized_matmul.plain_launches = 0
ent_quantized_matmul_packed.plain_launches = 0
ent_quantized_matmul_fused.plain_launches = 0


# --- what a call costs (``kernels/cost.py``) ------------------------------------

_PLANES = {"ent_matmul_packed_fused": 2, "ent_matmul_packed": 2, "ent_matmul": 4}
COSTED = tuple(_PLANES)


def cost(name, x, w, scale_x, scale_w, out_dtype=torch.float32):
    """The launch wrapper ``name`` (of ``COSTED``) makes on these
    arguments: [(kernel, {operand type: FLOPs}, bytes)]."""
    return [C.plane_matmul(name, _PLANES[name], x, w, scale_x, scale_w, out_dtype)]
