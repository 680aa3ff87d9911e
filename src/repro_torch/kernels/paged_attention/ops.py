"""Public op: in-place paged decode attention (port of
``repro/kernels/paged_attention/ops.py``).

``paged_attention`` takes the page pools and block table as stored — no
gathered [B, max_len] KV view — and hands them to the paged decode
kernel, whose wrapper takes the plain version only for CPU tensors.
int8 pools come with their bf16 scale pools (``k_scales``/``v_scales``),
which the kernel folds as it reads the pages: no dequantized copy of the
pool is made.  ``use_kernel=False`` asks for the plain version
explicitly (counted in ``paged_attention.plain_launches`` on the card).

``ring_attention`` is the same for a sliding-window ring: its pools as
``RingCache`` stores them (``[B, W, Hkv, D]``, int8 with their scale
pools), no transposed, gathered or dequantized copy, through the paged
kernel's ring form; ``use_kernel=False`` runs its plain version
(``ring_attention.plain_launches`` on the card).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import cost as C
from repro_torch.kernels.flash_attention.ref import ring_valid
from repro_torch.kernels.paged_attention.paged_attention import (
    paged_attention_kernel, ring_decode_kernel)
from repro_torch.kernels.paged_attention.ref import paged_attention_ref, ring_decode_ref


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


def ring_attention(q, k_ring, v_ring, pos, start, *, window, k_scales=None,
                   v_scales=None, scale=None, use_kernel: bool = True):
    """q [B, Hq, 1, D]; ring pools [B, W, Hkv, D]; pos/start [B] int32;
    ``window`` the ring's attention window.  Returns [B, Hq, 1, D]
    float32."""
    pos, start = pos.to(torch.int32), start.to(torch.int32)
    if not use_kernel:
        if q.is_cuda:
            ring_attention.plain_launches += 1
        return ring_decode_ref(q, k_ring, v_ring, pos, start, k_scales, v_scales,
                               window=window, scale=scale)
    return ring_decode_kernel(q.contiguous(), k_ring, v_ring, pos.contiguous(),
                              start.contiguous(), k_scales, v_scales, window=window,
                              scale=scale)


ring_attention.plain_launches = 0


# --- what a call costs (``kernels/cost.py``) ------------------------------------

def _decode_cost(kernel, q, k, live, k_scales, index_bytes):
    """q (bf16) and the f32 output once, the ``live`` K and V rows (int8:
    with their bf16 row scales) once, the index tensors; the score and
    value products of the live rows."""
    b, hq, _, d = q.shape
    hkv = k.shape[2]
    row = hkv * d * k.element_size() + (hkv * k_scales.element_size()
                                        if k_scales is not None else 0)
    return [(kernel, {"bf16": 4 * live * hq * d},
             C.nbytes(q) + 4 * b * hq * d + 2 * live * row + index_bytes)]


def _paged_cost(q, k_pages, v_pages, block_table, pos, start, k_scales=None, v_scales=None,
                *, page_size, scale=None, fault=0):
    """Kernels 3 / 3b: the valid columns (mapped, start <= j <= pos); on
    ``meta`` every column of the table."""
    b, pps = block_table.shape
    if C.known(block_table, pos, start):
        cols = torch.arange(pps * page_size, device=q.device)[None, :]
        mapped = torch.repeat_interleave(block_table != 0, page_size, dim=1)
        live = int((mapped & (cols <= pos[:, None]) & (cols >= start[:, None])).sum())
    else:
        live = b * pps * page_size
    return _decode_cost("paged_attention_kernel", q, k_pages, live, k_scales,
                        C.nbytes(block_table, pos, start))


def _ring_cost(q, k_ring, v_ring, pos, start, k_scales=None, v_scales=None, *, window,
               scale=None, fault=0):
    """The ring decode: the ring rows a slot attends; on ``meta`` all W."""
    b, w = k_ring.shape[:2]
    live = (int(ring_valid(pos, start, w, window).sum()) if C.known(pos, start) else b * w)
    return _decode_cost("ring_decode_attention", q, k_ring, live, k_scales,
                        C.nbytes(pos, start))


_COSTS = {"paged_attention_kernel": _paged_cost, "ring_decode_kernel": _ring_cost}
COSTED = tuple(_COSTS)


def cost(name, *args, **kwargs):
    """The launches wrapper ``name`` (of ``COSTED``) makes on these
    arguments: [(kernel, {operand type: FLOPs}, bytes)]."""
    return _COSTS[name](*args, **kwargs)
