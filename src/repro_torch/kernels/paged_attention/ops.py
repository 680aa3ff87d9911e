"""Public op: in-place paged decode attention (port of
``repro/kernels/paged_attention/ops.py``).

``paged_attention`` takes the page pools and block table as stored — no
gathered [B, max_len] KV view — and hands them to the paged decode
kernel, whose wrapper takes the plain version only for CPU tensors.
int8 pools come with their bf16 scale pools (``k_scales``/``v_scales``),
which the kernel folds as it reads the pages: no dequantized copy of the
pool is made.  ``use_kernel=False`` asks for the plain version
explicitly (counted in ``paged_attention.plain_launches`` on the card).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.paged_attention.paged_attention import (
    paged_attention_kernel)
from repro_torch.kernels.paged_attention.ref import paged_attention_ref


def paged_attention(q, k_pages, v_pages, block_table, pos, start=None, *,
                    page_size: int, k_scales=None, v_scales=None, scale=None,
                    use_kernel: bool = True):
    """q [B, Hq, 1, D]; pools [P, page, Hkv, D]; block_table [B, pps]
    int32; pos/start [B] int32.  Returns [B, Hq, 1, D] float32."""
    if start is None:
        start = torch.zeros((q.shape[0],), dtype=torch.int32, device=q.device)
    pos, start = pos.to(torch.int32), start.to(torch.int32)
    if not use_kernel:
        if q.is_cuda:
            paged_attention.plain_launches += 1
        return paged_attention_ref(q, k_pages, v_pages, block_table, pos,
                                   start, page_size=page_size, k_scales=k_scales,
                                   v_scales=v_scales, scale=scale)
    return paged_attention_kernel(
        q.contiguous(), k_pages, v_pages, block_table.contiguous(),
        pos.contiguous(), start.contiguous(), k_scales, v_scales,
        page_size=page_size, scale=scale)


paged_attention.plain_launches = 0
