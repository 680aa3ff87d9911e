"""Plain PyTorch version of in-place paged decode attention (port of
``paged_attention_ref``, ``repro/kernels/paged_attention/ref.py:55``).

One-token attention straight off the page pool + block table: column
``j`` (table order * page_size + offset — table order is position
order) attends iff ``start[b] <= j <= pos[b]`` and its table entry is
mapped (page 0 is the reserved null page).  The softmax runs over the
whole [B, Hkv, G, W] score tensor and the value side is one
position-ordered float32 contraction of probabilities cast to the value
dtype — the reduction order of the dense backend's single-block
``masked_attention_ref``, which keeps paged decode equal to dense
decode.  int8 pools are cast to q's dtype, and their per-row scale pools
([P, page, Hkv, 1]) fold exactly where the reference folds them: K
after the q.k dot, V into the probabilities after they are summed into
the denominator.  A fully masked slot returns exact zeros.  Returns
[B, Hq, 1, D] float32.  As the dense decode read does, each slot's
gathered columns are rotated so that its first attended column comes
first (``rotate_to_first``): left padding then leaves a slot's result
bit for bit unchanged.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.ref import rotate_to_first

_NEG_INF = -1e30


def _take_pages(pool, table):
    """[P, page, H, D] pool + [B, n] ids -> [B, H, n*page, D]."""
    g = pool[table]                                   # [B, n, page, H, D]
    g = g.reshape((g.shape[0], -1) + tuple(pool.shape[2:]))
    return g.permute(0, 2, 1, 3)


def _operand(pool, table, dtype):
    """Pages as a [B, H, C, D] operand, int8 codes cast to ``dtype``."""
    g = _take_pages(pool, table)
    return g.to(dtype) if g.dtype == torch.int8 else g


def _scale_cols(pool, table):
    """[P, page, H, 1] scale pool -> [B, H, C] f32 fold operand."""
    return _take_pages(pool, table)[..., 0].to(torch.float32)


def paged_attention_ref(q, k_pages, v_pages, block_table, pos, start=None,
                        *, page_size: int, k_scales=None, v_scales=None,
                        scale=None):
    b, hq, sq, d = q.shape
    if sq != 1:
        raise ValueError("paged_attention is a decode (Sq=1) op")
    _, page, hkv, _ = k_pages.shape
    if page != page_size:
        raise ValueError(f"pool page {page} != page_size {page_size}")
    group = hq // hkv
    w = block_table.shape[-1] * page_size
    if scale is None:
        scale = d**-0.5
    if start is None:
        start = torch.zeros((b,), dtype=torch.int32, device=q.device)
    qg = q.reshape(b, hkv, group, sq, d).to(torch.float32)
    cols = torch.arange(w, dtype=torch.int32, device=q.device)[None, :]
    mapped = torch.repeat_interleave(block_table != 0, page_size, dim=-1)
    valid = (cols <= pos[:, None]) & (cols >= start[:, None]) & mapped
    ks, vs = (None if t is None else _scale_cols(t, block_table)
              for t in (k_scales, v_scales))
    valid, kb, vb, ks, vs = rotate_to_first(
        valid, _operand(k_pages, block_table, q.dtype).to(torch.float32),
        _operand(v_pages, block_table, q.dtype), ks, vs)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, kb) * scale
    if ks is not None:   # K dequant scale, folded after the dot
        s = s * ks[:, :, None, None, :]
    mask = valid[:, None, None, None, :]
    s = torch.where(mask, s, _NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    p = torch.where(mask, p, 0.0)                     # fully masked rows: 0
    l = p.sum(-1, keepdim=True)
    if vs is not None:   # V dequant scale, folded into the probs
        p = p * vs[:, :, None, None, :]
    acc = torch.einsum("bhgqk,bhkd->bhgqd", p.to(vb.dtype).to(torch.float32),
                       vb.to(torch.float32))
    out = acc / torch.clamp_min(l, 1e-30)
    return out.reshape(b, hq, sq, d)
