"""Wrapper of the CUDA kernel ``csrc/flash_attention.cu``: masked flash
prefill (replaces the Pallas ``flash_attention_masked``,
``repro/kernels/flash_attention/flash_attention.py:145``).

On a CUDA tensor the wrapper launches the kernel or raises; only CPU
tensors take the plain PyTorch version.  ``flash_attention_masked.launches``
counts kernel launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import masked_attention_ref

HEAD_DIMS = (64, 128)


def flash_attention_masked(q, k, v, start, *, q_offset: int = 0,
                           causal: bool = True, window: int | None = None,
                           scale: float | None = None):
    """q [B, Hq, Sq, D], k/v [B, Hkv, Skv, D] (f32 or bf16, one dtype),
    start int32 [B] -> [B, Hq, Sq, D] in q's dtype (as the Pallas kernel;
    softmax and accumulation in f32)."""
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if hq % hkv:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={hkv}")
    if start.shape != (b,) or start.dtype != torch.int32:
        raise ValueError("start must be int32 [B]")
    if scale is None:
        scale = d**-0.5
    if q.device.type == "cpu":
        return masked_attention_ref(q, k, v, start=start, q_offset=q_offset,
                                    causal=causal, window=window,
                                    scale=scale).to(q.dtype)
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must share float32 or bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not supported by the kernel (supported: {HEAD_DIMS})")
    for t in (q, k, v, start):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("operands must be contiguous and on one device")
    out = torch.empty((b, hq, sq, d), dtype=q.dtype, device=q.device)
    if b * hq * sq == 0:
        return out
    fn = _build.entry("flash_attention")
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), start.data_ptr(),
            out.data_ptr(), int(q.dtype == torch.bfloat16), b, hq, hkv, sq,
            skv, d, int(q_offset), int(causal),
            0 if window is None else int(window), float(scale),
            _build.stream_of(q))
    _build.check(rc, "flash_attention_masked")
    flash_attention_masked.launches += 1
    return out


flash_attention_masked.launches = 0
