"""Wrapper of the CUDA kernel ``csrc/paged_attention.cu``: in-place paged
decode attention (replaces the Pallas ``paged_attention_kernel``,
``repro/kernels/paged_attention/paged_attention.py:109``).

On a CUDA tensor the wrapper launches the kernel or raises; only CPU
tensors take the plain PyTorch version.  Pools are float32/bf16 in q's
dtype, or int8 with bf16 ``[P, page, Hkv, 1]`` scale pools (the int8-KV
branch, ``paged_attention.py:49-56, 77-78, 92-94``), which the kernel
dequantizes as it reads each page.  The kernel is a split-KV
flash-decode in one launch: ``split_plan`` cuts each table row into
runs of pages, one block per (run, kv head, slot), and the last block of
each (slot, kv head) combines the runs' partials in a fixed order
through the workspace that ``_build.stream_workspace`` keeps per
(device, CUDA stream).  ``paged_attention_kernel.launches`` counts kernel
launches (one a call), and ``.int8_kv_launches`` those of the int8-KV
branch among them.  ``fault`` (0 on every path of the port) plants a
kernel fault for ``chip_smoke.py``'s checks (see the source); the plain
version has none.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.paged_attention.ref import paged_attention_ref

HEAD_DIMS = (64, 128)
MAX_GROUP = 16       # q heads per kv head the kernel holds
MAX_PAGE = 32        # one lane per page column (the float32 route)
# pages a split at most: a block holds its run's table entries and (int8
# pools) its rows' K / V scales in shared memory, 8.25 KB at 32-token pages
MAX_RUN_PAGES = 64


def split_plan(b: int, hkv: int, pps: int, sms: int):
    """The kernel's split of ``b`` slots' table rows of ``pps`` pages, for
    ``hkv`` kv heads on a card of ``sms`` SMs: (pages a split, splits).
    Split ``i`` covers table pages ``[i * pages, (i + 1) * pages)`` (the
    last may be shorter), so every column lies in exactly one; ``b * hkv *
    splits >= 2 * sms`` blocks wherever ``pps`` allows, and no split holds
    more than ``MAX_RUN_PAGES`` pages.  Shapes only: nothing of pos, start
    or the table is read."""
    need = -(-2 * sms // max(1, b * hkv))
    pages = max(1, min(pps // need, MAX_RUN_PAGES))
    return pages, max(1, -(-pps // pages))


def paged_attention_kernel(q, k_pages, v_pages, block_table, pos, start,
                           k_scales=None, v_scales=None, *, page_size: int,
                           scale: float | None = None, fault: int = 0):
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
    if fault not in (0, 1):
        raise ValueError(f"fault must be 0 or 1, got {fault}")
    if scale is None:
        scale = d**-0.5
    if q.device.type == "cpu":
        if fault:
            raise ValueError("fault plants a kernel fault; the plain version has none")
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
    pps = block_table.shape[1]
    stream = _build.stream_of(q)
    pages, splits = split_plan(b, hkv, pps, _build.sm_count(q.device))
    ws = tk = None
    if splits > 1:   # f32 partials [B, Hkv, splits, G, D + 2], a ticket a (slot, kv head)
        ws, tk = _build.stream_workspace((q.device, stream, "paged"),
                                         b * hkv * splits * group * (d + 2), b * hkv)
    fn = _build.entry("paged_attention", "paged_attention")
    rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            k_scales.data_ptr() if int8_kv else None,
            v_scales.data_ptr() if int8_kv else None,
            block_table.data_ptr(), pos.data_ptr(), start.data_ptr(),
            out.data_ptr(), None if ws is None else ws.data_ptr(),
            0 if ws is None else ws.numel(), None if tk is None else tk.data_ptr(),
            0 if tk is None else tk.numel(), int(q.dtype == torch.bfloat16),
            int(int8_kv), b, hq, hkv, pps, page, d, pages, splits, float(scale),
            int(fault), stream)
    _build.check(rc, "paged_attention_kernel")
    paged_attention_kernel.launches += 1
    paged_attention_kernel.int8_kv_launches += int8_kv
    return out


paged_attention_kernel.launches = 0
paged_attention_kernel.int8_kv_launches = 0
