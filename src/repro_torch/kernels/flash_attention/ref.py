"""Plain PyTorch versions of the flash attention kernels (port of
``repro/kernels/flash_attention/ref.py``).

``attention_ref`` (reference :25) materializes the [Sq, Skv] scores;
``attention_blockwise`` (:50) is the same math with an online softmax
over kv chunks.  Both keep the probabilities in float32 and cast the
output to q's dtype.  ``flash_attention_ref`` is ``attention_ref`` that
also returns each row's log-sum-exp (the plain version of the training
forward kernel), and ``flash_attention_bwd_ref`` its backward from the
saved lse with the flash-attention-2 formulas (the plain version of the
two backward kernels; the reference has no backward kernel and
differentiates ``attention_ref``).  Query row t sits at kv position
``q_offset + t`` with ``q_offset = Skv - Sq`` unless given.

``masked_attention_ref`` (reference :102) is the serving core: blocked
online-softmax attention with ragged/serving masking, per kv
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
A decode read (``valid`` with one query row) first rotates each
sequence's kv columns so that its first attended column comes first
(:func:`rotate_to_first`).
"""

from __future__ import annotations

import torch

_NEG_INF = -1e30


def _band(sq, skv, q_offset, causal, window, device):
    """[Sq, Skv] bool: kv column j attends to query row t (position
    ``q_offset + t``)."""
    q_pos = torch.arange(sq, device=device)[:, None] + q_offset
    kv_pos = torch.arange(skv, device=device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        mask = mask & (kv_pos <= q_pos)
    if window is not None:
        mask = mask & (kv_pos > q_pos - window)
    return mask


def rotate_to_first(valid, *cols):
    """Rotate each sequence's kv columns so that its first attended column
    comes first.  valid [B, W] bool (one query row per sequence); ``cols``
    are tensors with the W columns on dim 2 ([B, H, W, ...]), or None.
    Returns (valid, *cols) rotated.  A permutation of a softmax row's
    columns changes nothing in exact arithmetic.  In float it does:
    torch's CPU sums group their terms by column offset, so the same
    attended keys at columns 4..9 and at 0..5 round differently.  Rotated,
    a row's attended run starts at column 0 wherever it sits in the cache,
    and left padding leaves a decode read bit for bit unchanged (a fully
    masked row stays as it is)."""
    b, w = valid.shape
    first = valid.to(torch.int32).argmax(-1)          # the first True, else 0
    idx = (torch.arange(w, device=valid.device)[None, :] + first[:, None]) % w

    def rot(t):
        if t is None:
            return None
        ix = idx.view(b, 1, w, *([1] * (t.dim() - 3)))
        return t.gather(2, ix.expand(b, t.shape[1], w, *t.shape[3:]))

    return (valid.gather(1, idx), *map(rot, cols))


def _repeat_kv(q, k, v):
    group = q.shape[1] // k.shape[1]
    return k.repeat_interleave(group, dim=1), v.repeat_interleave(group, dim=1)


def flash_attention_ref(q, k, v, *, causal=True, window=None, scale=None,
                        q_offset=None):
    """q [B, Hq, Sq, D], k/v [B, Hkv, Skv, D] -> (out [B, Hq, Sq, D] in q's
    dtype, lse float32 [B, Hq, Sq]); lse is +inf on a fully masked row."""
    sq, d = q.shape[2], q.shape[3]
    skv = k.shape[2]
    if scale is None:
        scale = d**-0.5
    if q_offset is None:
        q_offset = skv - sq
    kr, vr = _repeat_kv(q, k, v)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32), kr.to(torch.float32))
    s = s * scale
    mask = _band(sq, skv, q_offset, causal, window, q.device)
    s = torch.where(mask, s, _NEG_INF)
    mx = s.amax(-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - mx), 0.0)
    den = p.sum(-1, keepdim=True)
    p = p / torch.clamp_min(den, 1e-30)
    out = torch.einsum("bhqk,bhkd->bhqd", p, vr.to(torch.float32))
    lse = torch.where(den > 0, mx + torch.log(den), float("inf"))[..., 0]
    return out.to(q.dtype), lse


def attention_ref(q, k, v, *, causal=True, window=None, scale=None):
    return flash_attention_ref(q, k, v, causal=causal, window=window,
                               scale=scale)[0]


def attention_blockwise(q, k, v, *, causal=True, window=None, scale=None,
                        chunk=1024):
    """Online-softmax attention over kv chunks of ``chunk`` columns:
    O(Sq x chunk) scores at a time (reference :50)."""
    b, hq, sq, d = q.shape
    skv = k.shape[2]
    if scale is None:
        scale = d**-0.5
    chunk = min(chunk, skv)
    if skv % chunk:
        raise ValueError(f"chunk {chunk} does not divide Skv={skv}")
    kr, vr = _repeat_kv(q, k, v)
    qf = q.to(torch.float32) * scale
    dev = q.device
    m = torch.full((b, hq, sq, 1), _NEG_INF, device=dev)
    l = torch.zeros((b, hq, sq, 1), device=dev)
    acc = torch.zeros((b, hq, sq, d), device=dev)
    for lo in range(0, skv, chunk):
        s = torch.einsum("bhqd,bhkd->bhqk", qf,
                         kr[:, :, lo:lo + chunk].to(torch.float32))
        mask = _band(sq, skv, skv - sq, causal, window, dev)[:, lo:lo + chunk]
        s = torch.where(mask, s, _NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.where(mask, torch.exp(s - m_new), 0.0)
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum(
            "bhqk,bhkd->bhqd", p, vr[:, :, lo:lo + chunk].to(torch.float32))
        m = m_new
    return (acc / torch.clamp_min(l, 1e-30)).to(q.dtype)


def flash_attention_bwd_ref(q, k, v, o, lse, do, *, causal=True, window=None,
                            scale=None, q_offset=None, delta=None):
    """Backward of :func:`flash_attention_ref` from its output ``o`` and
    ``lse``: with S the scaled scores on the band, P = exp(S - lse),
    D = rowsum(dO * O) (or ``delta``, float32 [B, Hq, Sq], when given),
    dP = dO V^T and dS = P * (dP - D): dQ = scale dS K, dK = scale dS^T Q,
    dV = P^T dO, dK and dV summed over each kv head's group of q heads in
    float32.  Returns (dq, dk, dv) in q's / k's / v's dtypes."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if scale is None:
        scale = d**-0.5
    if q_offset is None:
        q_offset = skv - sq
    f32 = torch.float32
    kr, vr = _repeat_kv(q, k, v)
    qf, kf, vf, dof = q.to(f32), kr.to(f32), vr.to(f32), do.to(f32)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    mask = _band(sq, skv, q_offset, causal, window, q.device)
    p = torch.exp(torch.where(mask, s - lse[..., None], -float("inf")))
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    dd = ((dof * o.to(f32)).sum(-1) if delta is None else delta.to(f32))[..., None]
    ds = p * (dp - dd)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    dk = dk.reshape(b, hkv, hq // hkv, skv, d).sum(2)
    dv = dv.reshape(b, hkv, hq // hkv, skv, d).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


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
    if valid is not None and sq == 1:   # a decode read
        v1, k, v, k_scale, v_scale = rotate_to_first(valid[:, 0], k, v, k_scale, v_scale)
        valid = v1[:, None, :]
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
