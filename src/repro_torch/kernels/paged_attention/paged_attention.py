"""Wrapper of the CUDA kernel ``csrc/paged_attention.cu``: in-place paged
decode attention (replaces the Pallas ``paged_attention_kernel``,
``repro/kernels/paged_attention/paged_attention.py:109``).

On a CUDA tensor the wrapper launches the kernel or raises; only CPU
tensors take the plain PyTorch version.  ``paged_attention_kernel.launches``
counts kernel launches.  The int8-KV scale pools are not ported yet.
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
    if k_scales is not None or v_scales is not None:
        raise NotImplementedError(
            "int8-KV paged attention (per-page scale pools) waits for a "
            "later slice (ROADMAP: int8-KV paged/flash)")
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
    if scale is None:
        scale = d**-0.5
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pages, v_pages, block_table, pos,
                                   start, page_size=page_size, scale=scale)
    if q.dtype not in (torch.float32, torch.bfloat16) or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise TypeError(f"q and pools must share float32 or bfloat16, got "
                        f"{q.dtype}, {k_pages.dtype}, {v_pages.dtype}")
    group = hq // hkv
    if d not in HEAD_DIMS or group > MAX_GROUP or page > MAX_PAGE:
        raise ValueError(f"kernel supports head_dim in {HEAD_DIMS}, <= {MAX_GROUP} "
                         f"q heads per kv head and pages <= {MAX_PAGE}; got "
                         f"D={d}, G={group}, page={page}")
    for t in (q, k_pages, v_pages, block_table, pos, start):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("operands must be contiguous and on one device")
    out = torch.empty((b, hq, 1, d), dtype=torch.float32, device=q.device)
    if b == 0:
        return out
    fn = _build.entry("paged_attention")
    rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_table.data_ptr(), pos.data_ptr(), start.data_ptr(),
            out.data_ptr(), int(q.dtype == torch.bfloat16), b, hq, hkv,
            block_table.shape[1], page, d, float(scale), _build.stream_of(q))
    _build.check(rc, "paged_attention_kernel")
    paged_attention_kernel.launches += 1
    return out


paged_attention_kernel.launches = 0
