"""GQA attention layer with RoPE and KV-cache serving paths (port of
``repro/models/attention.py``).

``prefill_step`` writes the prompt chunk's rotated K/V through the cache
and attends through the masked flash kernel; ``decode_step`` writes one
row and, for the paged backend, reads the pool in place through the
paged decode kernel; dense rows (the dense engine backend, a
speculative drafter) go through the masked flash kernel at Sq = 1 with
per-sequence offsets ``q_offsets = pos_b``, and a sliding-window ring
through the paged kernel's ring form, its pools in place, never gathered
into position order, transposed or dequantized.  ``verify_step`` is
speculative decoding's burst: S rows per sequence written at ``pos_b ..
pos_b+S-1`` and attended through the same kernel over the cache's
position-ordered view with ``q_offsets = pos_b``.

On the plain path (CPU tensors, or ``use_kernel=False``) the two share
one reduction order, so that batched prefill ≡ sequential decode bit for
bit: the projections multiply row by row (``layers.row_matmul``), and
prefill and the verify burst attend each query row exactly as
``decode_step`` attends at that position (``_token_attention``: the
cache view's full width, decode's mask, one row per sequence), after
writing the whole chunk.
Masked columns give exact zeros wherever they sit, so the later rows
that prefill has already written change nothing.  On the ring a chunk
that wraps overwrites rows its earlier queries attend to, so the plain
path interleaves instead: it writes a row, then attends that row, which
is sequential decode step for step; the kernel path reads the retained
context (``RingCache.context``, a copy) before the chunk's write.

With an int8 KV cache the stored codes are cast to the compute dtype
and the bf16 per-row scales fold into the attention (K after the q.k
dot, V into the probabilities): the paged kernel (and its ring form)
dequantizes in the kernel, and the flash route takes operands
dequantized to q's dtype.  The full-sequence ``apply`` (training)
attends through the flash kernel and its hand-written backward.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import ops as attn_ops
from repro_torch.kernels.paged_attention import ops as paged_ops
from repro_torch.models import kv_cache
from repro_torch.models import layers as L


def init(generator, cfg: ModelConfig, device=None):
    hd, h, hkv, d = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads, cfg.d_model
    return {
        "wq": L.dense_init(generator, cfg, d, h * hd, bias=cfg.qkv_bias, device=device),
        "wk": L.dense_init(generator, cfg, d, hkv * hd, bias=cfg.qkv_bias, device=device),
        "wv": L.dense_init(generator, cfg, d, hkv * hd, bias=cfg.qkv_bias, device=device),
        "wo": L.dense_init(generator, cfg, h * hd, d, scale=(h * hd) ** -0.5, device=device),
    }


def plain_path(x, use_kernel: bool) -> bool:
    """Whether serving runs the plain versions: CPU tensors, or an
    explicit ``use_kernel=False``."""
    return not use_kernel or x.device.type == "cpu"


def _project(cfg: ModelConfig, p, x, positions, use_kernel: bool = True,
             rows: bool = False):
    b, s, _ = x.shape
    hd = cfg.head_dim
    dt = L.cdtype(cfg)

    def dense(w, heads):
        return L.dense_apply(p[w], x, dt, use_kernel, rows).reshape(b, s, heads, hd)

    q = dense("wq", cfg.num_heads)
    k = dense("wk", cfg.num_kv_heads)
    v = dense("wv", cfg.num_kv_heads)
    q = L.rope(q, positions, cfg.rope_theta)
    k = L.rope(k, positions, cfg.rope_theta)
    return q, k, v


def apply(cfg: ModelConfig, p, x, positions=None, use_kernel: bool = True):
    """Full-sequence (training) forward.  x: [B, S, D] -> [B, S, D];
    ``positions`` default to ``arange(S)`` for every row."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    q, k, v = _project(cfg, p, x, positions, use_kernel)
    out = attn_ops.attention(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2), causal=True,
                             window=cfg.sliding_window, use_kernel=use_kernel)
    return _finish(cfg, p, out, use_kernel)


def cache_len(cfg: ModelConfig, max_len: int) -> int:
    """Rows a sequence's cache holds: the sliding window bounds the ring."""
    return min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len


def resolve_cache_kind(cfg: ModelConfig, kind: str | None) -> str:
    """"auto" (or None) -> the ring for sliding-window models, dense rows
    otherwise."""
    if kind in (None, "auto"):
        return "ring" if cfg.sliding_window else "dense"
    return kind


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype, *,
               quantized: bool = False, kind: str = "auto",
               page_size: int | None = None, pages: int | None = None,
               mapped: bool = True, device=None):
    """One attention layer's KV cache: ``"paged"``, ``"dense"``, ``"ring"``
    (W = ``cache_len`` rows a sequence, slot = pos mod W) or ``"auto"``
    (:func:`resolve_cache_kind`); ``quantized`` stores int8 KV with bf16
    per-(row, head) scales.  The reference's refusals: paged and dense
    carry no window mask, so a windowed model serves on the ring, and the
    ring needs a window."""
    kind = resolve_cache_kind(cfg, kind)
    if kind == "paged":
        if cfg.sliding_window:
            raise ValueError("PagedCache carries no sliding-window mask; windowed "
                             "models serve through the ring backend (kind='ring')")
        return kv_cache.paged_init(
            batch, max_len, cfg.num_kv_heads, cfg.head_dim, dtype,
            quantized=quantized,
            page_size=page_size or kv_cache.DEFAULT_PAGE_SIZE, pages=pages,
            mapped=mapped, device=device)
    if kind == "ring" and not cfg.sliding_window:
        raise ValueError("RingCache requires cfg.sliding_window")
    if kind == "dense" and cfg.sliding_window:
        raise ValueError("sliding-window models must use the ring cache: the dense "
                         "backend carries no window mask")
    if kind == "ring":
        return kv_cache.ring_init(batch, cache_len(cfg, max_len), cfg.num_kv_heads,
                                  cfg.head_dim, dtype, window=cfg.sliding_window,
                                  quantized=quantized, device=device)
    if kind == "dense":
        return kv_cache.dense_init(batch, max_len, cfg.num_kv_heads,
                                   cfg.head_dim, dtype, quantized=quantized,
                                   device=device)
    raise ValueError(f"unknown cache kind {kind!r}")


def _scale_op(s):
    """[B, S, Hkv, 1] stored scale -> [B, Hkv, S] f32 fold operand."""
    return None if s is None else s[..., 0].transpose(1, 2).to(torch.float32)


def _finish(cfg: ModelConfig, p, out, use_kernel: bool = True, rows: bool = False):
    """[B, Hq, S, hd] attention (f32, or the compute dtype from the
    flash kernel) -> output projection."""
    b, _, s, _ = out.shape
    out = out.transpose(1, 2).reshape(b, s, cfg.num_heads * cfg.head_dim)
    return L.dense_apply(p["wo"], out.to(L.cdtype(cfg)), L.cdtype(cfg), use_kernel,
                         rows)


def _token_attention(cfg: ModelConfig, q, cache, pos_b, start_b, use_kernel: bool):
    """One query row per sequence (q [B, Hq, 1, hd]) at positions ``pos_b``
    over what ``cache.token_view`` gives: the paged pool in place through
    the paged decode op, or the dense rows through the masked op (the
    kernel with ``(start_b, q_offsets=pos_b)``, the plain path with the
    view's [B, W] mask).  On the kernel path a ring's pools go as stored
    (no transposed, contiguous or dequantized copy) to the paged kernel's
    ring form (``paged_ops.ring_attention``), which masks them itself."""
    plain = plain_path(q, use_kernel)
    if isinstance(cache, kv_cache.RingCache) and not plain:
        return paged_ops.ring_attention(
            q, cache.k, cache.v, pos_b, start_b, window=cache.window, k_scales=cache.k_s,
            v_scales=cache.v_s, use_kernel=use_kernel)
    view = cache.token_view(pos_b, start_b)
    if isinstance(view, kv_cache.PagedView):
        return paged_ops.paged_attention(
            q, view.k, view.v, view.block_table, pos_b, start_b,
            page_size=view.page_size, k_scales=view.k_s, v_scales=view.v_s,
            use_kernel=use_kernel)
    kop, vop, ks, vs, valid = view
    mask = (dict(valid=valid[:, None, :]) if plain
            else dict(start=start_b, q_offsets=pos_b))
    dt = L.cdtype(cfg)
    if kop.dtype == torch.int8:
        kop, vop = kop.to(dt), vop.to(dt)
    return attn_ops.masked_attention(
        q, kop.transpose(1, 2), vop.transpose(1, 2), k_scale=_scale_op(ks),
        v_scale=_scale_op(vs), use_kernel=use_kernel, **mask)


def _starts(start, b, device):
    return (torch.zeros((b,), dtype=torch.int32, device=device) if start is None else
            torch.as_tensor(start, dtype=torch.int32, device=device).expand(b))


def decode_step(cfg: ModelConfig, p, x, cache, pos, start=None,
                use_kernel: bool = True):
    """One-token decode.  x: [B, 1, D]; pos: [B] int32 (or a scalar).
    Returns (y [B, 1, D], cache written in place)."""
    b = x.shape[0]
    rows = plain_path(x, use_kernel)
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
    per_seq = pos.dim() > 0
    pos_b = pos.expand(b)
    start_b = _starts(start, b, x.device)
    positions = (pos_b - start_b)[:, None]
    q, k, v = _project(cfg, p, x, positions, use_kernel, rows)   # q: [B,1,H,hd]
    new = cache.write_token(k, v, pos, per_seq)
    out = _token_attention(cfg, q.transpose(1, 2), new, pos_b, start_b, use_kernel)
    return _finish(cfg, p, out, use_kernel, rows), new


def verify_step(cfg: ModelConfig, p, x, cache, pos, start=None, use_kernel: bool = True):
    """Speculative verify burst: S tokens per sequence at per-sequence
    positions, the multi-token twin of ``decode_step``.  x: [B, S, D];
    pos: [B] int32.  Rows are projected at ``(pos_b - start_b) + t`` and
    written at ``pos_b + t`` (``write_tokens``); query t then attends what
    decode at ``pos_b + t`` would: on the kernel path through the masked
    flash kernel over ``verify_view`` with ``(start_b, q_offsets=pos_b)``;
    on the plain path row by row through ``_token_attention``, so that the
    burst is bit for bit S decode steps.  Returns (y [B, S, D], cache
    written in place).  Rollback is the caller's ``pos`` reset."""
    b, s, _ = x.shape
    rows = plain_path(x, use_kernel)
    pos_b = torch.as_tensor(pos, dtype=torch.int32, device=x.device).expand(b)
    start_b = _starts(start, b, x.device)
    if isinstance(cache, kv_cache.RingCache):
        cache.verify_view(pos_b, start_b, s)     # raises: no burst over a ring
    positions = ((pos_b - start_b)[:, None]
                 + torch.arange(s, dtype=torch.int32, device=x.device)[None, :])
    q, k, v = _project(cfg, p, x, positions, use_kernel, rows)
    q = q.transpose(1, 2)
    new = cache.write_tokens(k, v, pos_b)
    if rows:
        out = torch.cat([_token_attention(cfg, q[:, :, t:t + 1], new, pos_b + t, start_b,
                                          use_kernel) for t in range(s)], dim=2)
        return _finish(cfg, p, out, use_kernel, rows), new
    kop, vop, ks, vs, _ = new.verify_view(pos_b, start_b, s)
    dt = L.cdtype(cfg)
    if kop.dtype == torch.int8:
        kop, vop = kop.to(dt), vop.to(dt)
    out = attn_ops.masked_attention(
        q, kop.transpose(1, 2), vop.transpose(1, 2), start=start_b, q_offsets=pos_b,
        k_scale=_scale_op(ks), v_scale=_scale_op(vs), use_kernel=use_kernel)
    return _finish(cfg, p, out, use_kernel), new


def prefill_step(cfg: ModelConfig, p, x, cache, start=None, pos0: int = 0,
                 use_kernel: bool = True, write: bool = True):
    """Prompt-chunk forward with KV write-through at positions
    ``pos0 .. pos0+S-1``.  x: [B, S, D] -> (y [B, S, D], cache).  The
    queries attend over the retained context (``cache.context(pos0)``:
    ``[0, pos0)``, on the ring its last W rows, taken before the chunk's
    write, which on the ring may evict them) plus the chunk itself: through the masked flash kernel with the cache's window,
    or on the plain path one row at a time as ``decode_step`` attends (on
    the ring each row written just before it is attended).

    ``write=False`` runs the same math read-only (the prefix-cache peek
    of a fully cached prompt): the cache's pools are never written.  The
    kernel path attends the context as it stands plus the chunk's rows in
    storage form (``cache.stored``); the plain path writes the chunk into
    a detached copy of the view's pages (``cache.detached``) and attends
    there row by row, so both give what a writing forward gives."""
    b, s, _ = x.shape
    pos0 = int(pos0)
    rows = plain_path(x, use_kernel)
    cols = pos0 + torch.arange(s, dtype=torch.int32, device=x.device)
    start_b = _starts(start, b, x.device)
    positions = cols[None, :] - start_b[:, None]             # [B, S] relative
    q, k, v = _project(cfg, p, x, positions, use_kernel, rows)
    q = q.transpose(1, 2)

    if rows and isinstance(cache, kv_cache.RingCache):
        new = cache if write else cache.clone()
        outs = []
        for t in range(s):   # decode's write, then decode's read, row by row
            new.write_token(k[:, t:t + 1], v[:, t:t + 1], pos0 + t, per_seq=False)
            outs.append(_token_attention(cfg, q[:, :, t:t + 1], new, cols[t].expand(b),
                                         start_b, use_kernel))
        return _finish(cfg, p, torch.cat(outs, dim=2), use_kernel, rows), (
            new if write else cache)
    if rows:
        new = (cache if write else cache.detached()).write_prompt(k, v, pos0)[0]
        out = torch.cat([_token_attention(cfg, q[:, :, t:t + 1], new, cols[t].expand(b),
                                          start_b, use_kernel) for t in range(s)], dim=2)
        return _finish(cfg, p, out, use_kernel, rows), (new if write else cache)
    kc, vc, ksc, vsc, ctx = cache.context(pos0)
    if write:
        new, kf, vf, ksf, vsf = cache.write_prompt(k, v, pos0)
    else:
        new, (kf, vf, ksf, vsf) = cache, cache.stored(k, v)

    def cat(prev, fresh):
        return fresh if prev is None else torch.cat([prev, fresh.to(prev.dtype)], dim=1)

    kop, vop = cat(kc, kf), cat(vc, vf)
    ks = vs = None
    if new.quantized:
        ks, vs = cat(ksc, ksf), cat(vsc, vsf)
    dt = L.cdtype(cfg)
    if kop.dtype == torch.int8:
        kop, vop = kop.to(dt), vop.to(dt)
    # kv column j holds position pos0 - ctx + j; q row t sits at ctx + t
    start_local = torch.clamp_min(start_b - (pos0 - ctx), 0)
    out = attn_ops.masked_attention(
        q, kop.transpose(1, 2), vop.transpose(1, 2),
        start=start_local, q_offset=ctx, window=new.window, k_scale=_scale_op(ks),
        v_scale=_scale_op(vs), use_kernel=use_kernel)
    return _finish(cfg, p, out, use_kernel), new
