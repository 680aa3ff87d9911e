"""GQA attention layer with RoPE and KV-cache serving paths (port of
``repro/models/attention.py``).

``prefill_step`` writes the prompt chunk's rotated K/V through the cache
and attends through the masked flash kernel; ``decode_step`` writes one
row and, for the paged backend, reads the pool in place through the
paged decode kernel (dense rows go through the plain masked version,
for the paged ≡ dense test).

On the plain path (CPU tensors, or ``use_kernel=False``) the two share
one reduction order, so that batched prefill ≡ sequential decode bit for
bit: the projections multiply row by row (``layers.row_matmul``), and
prefill attends each query row exactly as ``decode_step`` attends at
that position (``_token_attention``: the cache view's full width,
decode's mask, one row per sequence), after writing the whole chunk.
Masked columns give exact zeros wherever they sit, so the later rows
that prefill has already written change nothing.

With an int8 KV cache the stored codes are cast to the compute dtype
and the bf16 per-row scales fold into the attention (K after the q.k
dot, V into the probabilities): the paged kernel dequantizes in the
kernel, and the flash route takes operands dequantized to q's dtype.  The full-sequence ``apply`` (training)
attends through the flash kernel and its hand-written backward.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import ops as attn_ops
from repro_torch.kernels.paged_attention import ops as paged_ops
from repro_torch.models import kv_cache
from repro_torch.models import layers as L


def init(generator, cfg: ModelConfig):
    hd, h, hkv, d = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads, cfg.d_model
    return {
        "wq": L.dense_init(generator, cfg, d, h * hd, bias=cfg.qkv_bias),
        "wk": L.dense_init(generator, cfg, d, hkv * hd, bias=cfg.qkv_bias),
        "wv": L.dense_init(generator, cfg, d, hkv * hd, bias=cfg.qkv_bias),
        "wo": L.dense_init(generator, cfg, h * hd, d, scale=(h * hd) ** -0.5),
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


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype, *,
               quantized: bool = False, kind: str = "paged",
               page_size: int | None = None, pages: int | None = None,
               mapped: bool = True, device=None):
    """One attention layer's KV cache: ``"paged"`` or ``"dense"``;
    ``quantized`` stores int8 KV with bf16 per-(row, head) scales."""
    if cfg.sliding_window:
        raise NotImplementedError(
            "sliding-window models serve through the ring cache, which "
            "this slice has not ported")
    if kind == "paged":
        return kv_cache.paged_init(
            batch, max_len, cfg.num_kv_heads, cfg.head_dim, dtype,
            quantized=quantized,
            page_size=page_size or kv_cache.DEFAULT_PAGE_SIZE, pages=pages,
            mapped=mapped, device=device)
    if kind == "dense":
        return kv_cache.dense_init(batch, max_len, cfg.num_kv_heads,
                                   cfg.head_dim, dtype, quantized=quantized,
                                   device=device)
    raise NotImplementedError(f"cache kind {kind!r} is not ported "
                              "(ported: 'paged', 'dense')")


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
    the paged decode op, or the dense rows with their [B, W] mask through
    the masked op."""
    view = cache.token_view(pos_b, start_b)
    if isinstance(view, kv_cache.PagedView):
        return paged_ops.paged_attention(
            q, view.k, view.v, view.block_table, pos_b, start_b,
            page_size=view.page_size, k_scales=view.k_s, v_scales=view.v_s,
            use_kernel=use_kernel)
    kop, vop, ks, vs, valid = view
    dt = L.cdtype(cfg)
    if kop.dtype == torch.int8:
        kop, vop = kop.to(dt), vop.to(dt)
    return attn_ops.masked_attention(
        q, kop.transpose(1, 2), vop.transpose(1, 2), valid=valid[:, None, :],
        k_scale=_scale_op(ks), v_scale=_scale_op(vs), use_kernel=use_kernel)


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


def prefill_step(cfg: ModelConfig, p, x, cache, start=None, pos0: int = 0,
                 use_kernel: bool = True):
    """Prompt-chunk forward with KV write-through at positions
    ``pos0 .. pos0+S-1``.  x: [B, S, D] -> (y [B, S, D], cache).  The
    queries attend over the retained context ``[0, pos0)`` read after
    the write (the chunk's positions are disjoint from it) plus the
    chunk itself: through the masked flash kernel, or on the plain path
    one row at a time as ``decode_step`` attends."""
    b, s, _ = x.shape
    pos0 = int(pos0)
    rows = plain_path(x, use_kernel)
    cols = pos0 + torch.arange(s, dtype=torch.int32, device=x.device)
    start_b = _starts(start, b, x.device)
    positions = cols[None, :] - start_b[:, None]             # [B, S] relative
    q, k, v = _project(cfg, p, x, positions, use_kernel, rows)
    q = q.transpose(1, 2)

    new, kf, vf, ksf, vsf = cache.write_prompt(k, v, pos0)
    if rows:
        out = torch.cat([_token_attention(cfg, q[:, :, t:t + 1], new, cols[t].expand(b),
                                          start_b, use_kernel) for t in range(s)], dim=2)
        return _finish(cfg, p, out, use_kernel, rows), new
    kc, vc, ksc, vsc, ctx = new.context(pos0)

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
        start=start_local, q_offset=ctx, k_scale=_scale_op(ks),
        v_scale=_scale_op(vs), use_kernel=use_kernel)
    return _finish(cfg, p, out, use_kernel), new
