"""Wrapper of the CUDA kernel ``csrc/paged_attention.cu``: in-place paged
decode attention (replaces the Pallas ``paged_attention_kernel``,
``repro/kernels/paged_attention/paged_attention.py:109``).

On a CUDA tensor the wrapper launches the kernel or raises; only CPU
tensors take the plain PyTorch version.  Pools are float32/bf16 in q's
dtype, or int8 with bf16 ``[P, page, Hkv, 1]`` scale pools (the int8-KV
branch, ``paged_attention.py:49-56, 77-78, 92-94``), which the kernel
dequantizes as it reads each page.  ``paged_attention_kernel.launches``
counts kernel launches, and ``.int8_kv_launches`` those of the int8-KV
branch among them.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.paged_attention.ref import paged_attention_ref

HEAD_DIMS = (64, 128)
MAX_GROUP = 16       # q heads per kv head the kernel holds
MAX_PAGE = 32        # one lane per page column


def paged_attention_kernel(q, k_pages, v_pages, block_table, pos, start,
                           k_scales=None, v_scales=None, *, page_size: int,
                           scale: float | None = None):
    """q [B, Hq, 1, D]; pools [P, page, Hkv, D] (page 0 = null);
    block_table int32 [B, pages_per_slot]; pos/start int32 [B] ->
    f32 [B, Hq, 1, D]."""
    b, hq, sq, d = q.shape
    npool, page, hkv, d2 = k_pages.shape
    if sq != 1 or d2 != d or v_pages.shape != k_pages.shape:
        raise ValueError(f"q {tuple(q.shape)}, pools {tuple(k_pages.shape)}, "
                         f"{tuple(v_pages.shape)}")
    if page != page_size or hq % hkv:
        raise ValueError(f"page {page} vs page_size {page_size}, Hq={hq}, Hkv={hkv}")
    if block_table.dim() != 2 or block_table.shape[0] != b:
        raise ValueError(f"block_table {tuple(block_table.shape)} for B={b}")
    for t in (block_table, pos, start):
        if t.dtype != torch.int32:
            raise TypeError("block_table, pos and start must be int32")
    if pos.shape != (b,) or start.shape != (b,):
        raise ValueError("pos and start must be [B]")
    int8_kv = k_pages.dtype == torch.int8
    if not int8_kv and (k_scales is not None or v_scales is not None):
        raise NotImplementedError("scale pools dequantize int8 pools; float "
                                  "pools with scales have no kernel branch")
    if int8_kv:
        sshape = tuple(k_pages.shape[:3]) + (1,)
        for t in (k_scales, v_scales):
            if t is None or tuple(t.shape) != sshape or t.dtype != torch.bfloat16:
                raise ValueError(f"int8 pools need bf16 scale pools {sshape}")
    if scale is None:
        scale = d**-0.5
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pages, v_pages, block_table, pos,
                                   start, page_size=page_size, k_scales=k_scales,
                                   v_scales=v_scales, scale=scale)
    pool_dtype = torch.int8 if int8_kv else q.dtype
    if q.dtype not in (torch.float32, torch.bfloat16) or k_pages.dtype != pool_dtype \
            or v_pages.dtype != pool_dtype:
        raise TypeError(f"q must be float32 or bfloat16 and the pools int8 or "
                        f"q's dtype, got {q.dtype}, {k_pages.dtype}, {v_pages.dtype}")
    group = hq // hkv
    if d not in HEAD_DIMS or group > MAX_GROUP or page > MAX_PAGE:
        raise ValueError(f"kernel supports head_dim in {HEAD_DIMS}, <= {MAX_GROUP} "
                         f"q heads per kv head and pages <= {MAX_PAGE}; got "
                         f"D={d}, G={group}, page={page}")
    operands = [q, k_pages, v_pages, block_table, pos, start]
    if int8_kv:
        operands += [k_scales, v_scales]
    for t in operands:
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("operands must be contiguous and on one device")
    out = torch.empty((b, hq, 1, d), dtype=torch.float32, device=q.device)
    if b == 0:
        return out
    fn = _build.entry("paged_attention")
    rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            k_scales.data_ptr() if int8_kv else None,
            v_scales.data_ptr() if int8_kv else None,
            block_table.data_ptr(), pos.data_ptr(), start.data_ptr(),
            out.data_ptr(), int(q.dtype == torch.bfloat16), int(int8_kv), b, hq,
            hkv, block_table.shape[1], page, d, float(scale), _build.stream_of(q))
    _build.check(rc, "paged_attention_kernel")
    paged_attention_kernel.launches += 1
    paged_attention_kernel.int8_kv_launches += int8_kv
    return out


paged_attention_kernel.launches = 0
paged_attention_kernel.int8_kv_launches = 0
