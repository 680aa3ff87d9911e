"""Plain PyTorch version of masked (serving) attention (port of
``masked_attention_ref``, ``repro/kernels/flash_attention/ref.py:102``).

Blocked online-softmax attention with ragged/serving masking, per kv
column j and query row t (q row t sits at position ``q_offset + t``):

  * causal:  j <= q_offset + t
  * window:  j >  q_offset + t - window
  * start:   j >= start[b]        (left-pad slots, masked forever)
  * valid:   [B, Sq, Skv] bool — overrides the positional masks

Scores are q.k dots accumulated in float32; the probabilities are cast
to the value dtype before the value contraction, as the reference does.
``k_scale``/``v_scale`` ([B, Hkv, Skv] f32) are int8-KV dequant scales,
folded exactly as the reference folds them: K after the q.k dot, V into
the probabilities after they are summed into the denominator.  Fully
masked query rows return exact zeros.  Returns [B, Hq, Sq, D] f32.
"""

from __future__ import annotations

import torch

_NEG_INF = -1e30


def masked_attention_ref(q, k, v, *, start=None, q_offset=0, causal=True,
                         window=None, scale=None, k_scale=None, v_scale=None,
                         valid=None, chunk=None):
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    group = hq // hkv
    if scale is None:
        scale = d**-0.5
    chunk = skv if chunk is None else min(chunk, skv)
    if skv % chunk:
        raise ValueError(f"chunk {chunk} does not divide Skv={skv}")
    dev = q.device
    qg = q.reshape(b, hkv, group, sq, d).to(torch.float32)
    q_pos = q_offset + torch.arange(sq, device=dev)[:, None]            # [Sq, 1]
    m = torch.full((b, hkv, group, sq, 1), _NEG_INF, device=dev)
    l = torch.zeros((b, hkv, group, sq, 1), device=dev)
    acc = torch.zeros((b, hkv, group, sq, d), device=dev)
    for lo in range(0, skv, chunk):
        ki = k[:, :, lo:lo + chunk].to(torch.float32)
        vi = v[:, :, lo:lo + chunk]
        s = torch.einsum("bhgqd,bhkd->bhgqk", qg, ki) * scale
        if k_scale is not None:   # K dequant scale, folded after the dot
            s = s * k_scale[:, :, None, None, lo:lo + chunk]
        kv_pos = lo + torch.arange(chunk, device=dev)[None, :]         # [1, C]
        if valid is not None:
            mask = valid[:, None, None, :, lo:lo + chunk]               # [B,1,1,Sq,C]
        else:
            mask = torch.ones((sq, chunk), dtype=torch.bool, device=dev)
            if causal:
                mask = mask & (kv_pos <= q_pos)
            if window is not None:
                mask = mask & (kv_pos > q_pos - window)
            if start is not None:
                mask = mask[None] & (kv_pos[None] >= start[:, None, None])
                mask = mask[:, None, None]
            else:
                mask = mask[None, None, None]
        s = torch.where(mask, s, _NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        p = torch.where(mask, p, 0.0)                                    # masked rows: 0
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(-1, keepdim=True)
        if v_scale is not None:   # V dequant scale, folded into the probs
            p = p * v_scale[:, :, None, None, lo:lo + chunk]
        acc = acc * alpha + torch.einsum(
            "bhgqk,bhkd->bhgqd", p.to(v.dtype).to(torch.float32),
            vi.to(torch.float32))
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)
    return out.reshape(b, hq, sq, d)
