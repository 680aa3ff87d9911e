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

``paged_attention_split_ref`` emulates the CUDA kernel's split-KV form
(``csrc/paged_attention.cu``) for the CPU tests: each run of pages forms
its own partial, its probabilities rounded to q's dtype against its own
max, and the partials combine in split order.
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


def paged_attention_split_ref(q, k_pages, v_pages, block_table, pos, start, *,
                              page_size: int, pages_per_split: int, k_scales=None,
                              v_scales=None, scale=None, fault: int = 0):
    """The kernel's split-KV flash-decode in plain PyTorch: split ``s``
    covers table pages ``[s * pages_per_split, (s + 1) * pages_per_split)``
    and forms ``m_s`` (its max score), ``l_s`` (the sum of its f32
    probabilities ``e^(s - m_s)``) and ``acc_s`` (their V-scaled values
    rounded to q's dtype, times V); the partials with ``l_s > 0`` then
    combine in split order, ``sum_s e^(m_s - M) acc_s / sum_s e^(m_s - M)
    l_s``.  ``fault = 1`` drops each row's last live split, as the kernel's
    planted fault does.  Returns [B, Hq, 1, D] float32."""
    b, hq, _, d = q.shape
    _, page, hkv, _ = k_pages.shape
    if page != page_size:
        raise ValueError(f"pool page {page} != page_size {page_size}")
    group = hq // hkv
    pps = block_table.shape[-1]
    if scale is None:
        scale = d**-0.5
    qg = q.reshape(b, hkv, group, d).to(torch.float32)
    cols = torch.arange(pps * page, dtype=torch.int32)[None, :]
    mapped = torch.repeat_interleave(block_table != 0, page, dim=-1)
    valid = ((cols <= pos[:, None]) & (cols >= start[:, None]) & mapped)[:, None, None, :]
    kb = _operand(k_pages, block_table, q.dtype).to(torch.float32)
    vb = _operand(v_pages, block_table, q.dtype).to(torch.float32)
    s = torch.einsum("bhgd,bhkd->bhgk", qg, kb) * scale
    vs = None
    if k_scales is not None:
        s = s * _scale_cols(k_scales, block_table)[:, :, None, :]
        vs = _scale_cols(v_scales, block_table)[:, :, None, :]
    s = torch.where(valid, s, _NEG_INF)
    parts = []
    width = pages_per_split * page
    for lo in range(0, pps * page, width):
        sl, ok = s[..., lo:lo + width], valid[..., lo:lo + width]
        m = sl.amax(-1, keepdim=True)
        p = torch.where(ok, torch.exp(sl - m), 0.0)
        l = p.sum(-1, keepdim=True)
        if vs is not None:
            p = p * vs[..., lo:lo + width]
        p = p.to(q.dtype).to(torch.float32)
        parts.append((m, l, torch.einsum("bhgk,bhkd->bhgd", p, vb[:, :, lo:lo + width])))
    m = torch.stack([t[0] for t in parts])            # [S, B, Hkv, G, 1]
    l = torch.stack([t[1] for t in parts])
    live = l > 0
    big = torch.where(live, m, _NEG_INF).amax(0)
    if fault == 1:   # each row's last live split
        order = torch.arange(len(parts)).reshape(-1, 1, 1, 1, 1)
        last = torch.where(live, order, -1).amax(0)
        live = live & (order != last)
    elif fault:
        raise ValueError(f"fault must be 0 or 1, got {fault}")
    acc = torch.zeros_like(parts[0][2])
    den = torch.zeros_like(parts[0][1])
    for i, (ms, ls, a) in enumerate(parts):          # split order
        w = torch.where(live[i], torch.exp(ms - big), 0.0)
        den = den + w * ls
        acc = acc + w * a
    return (acc / torch.clamp_min(den, 1e-30)).reshape(b, hq, 1, d)
