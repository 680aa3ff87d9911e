"""Mamba-2 (SSD) mixer layer (port of ``repro/models/ssm.py``): in_proj
-> depthwise causal conv -> SSD scan -> gated, normed out_proj.

A single input projection gives [z | x | B | C | dt]; x, B and C pass
through a depthwise causal conv of width W (the sum of the W shifted
slices times ``conv[w]`` in float32, without the reference's [B, S,
conv_dim, W] window stack, and without ``F.conv1d``, which cuDNN may run
in TF32 on the card); the SSD scan evolves the [P, N] state per head
(the scan kernel and its backward on the card, ``kernels.ssd_scan``);
the output is RMS-norm-gated by z and projected back.  The casts follow
the reference's order: the conv output in the compute dtype before the
split, x, B and C back to float32 for the scan, the ``d_skip`` term in
float32, ``silu(z)`` in float32 cast to y's dtype before the product.

``dt`` goes through ``torch.nn.functional.softplus``, which returns its
input above 20; ``jax.nn.softplus`` is ``logaddexp(x, 0)``.  The two
differ by log1p(exp(-x)) < 2.1e-9 there.

Serving carries an :class:`SSMCache` a layer (conv window [B, W-1, C],
SSD state [B, H, P, N] f32): ``decode_step`` is the one-token update
(``ssd_decode_step_ref``, on both devices, as the reference); a pad
token (``token_mask`` False) has its conv input zeroed and leaves the SSD
state as it was.  ``prefill_step`` is its batched twin.  On the plain
path (CPU tensors, or ``use_kernel=False``) it runs the reference's
per-step scan of that same update (``_scan_core``), so that batched
prefill ≡ sequential decode bit for bit; on the card it computes the
conv of all S positions at once (``causal_conv`` over the cache's window
and the chunk) and runs the recurrence through kernel 8's prefill form
(row 8p, ``ssd_ops.ssd_prefill``), entered from the cache's state, whose
leaving state becomes the new one.  ``verify_step`` (a speculative
burst) needs every per-step state, so it keeps the per-step scan on
both devices; ``select_state`` picks the state after the accepted
tokens.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models import layers as L
from repro_torch.models.attention import plain_path
from repro_torch.models.kv_cache import SSMCache


def dims(cfg: ModelConfig):
    """(d_inner, heads, conv_dim)."""
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    nheads = d_inner // s.head_dim
    conv_dim = d_inner + 2 * s.ngroups * s.state_dim
    return d_inner, nheads, conv_dim


def init(generator, cfg: ModelConfig):
    s = cfg.ssm
    d_inner, nheads, conv_dim = dims(cfg)
    pd, dev = L.pdtype(cfg), generator.device
    d_in_proj = 2 * d_inner + 2 * s.ngroups * s.state_dim + nheads
    in_proj = L.dense_init(generator, cfg, cfg.d_model, d_in_proj)
    conv = torch.randn((s.conv_width, conv_dim), generator=generator,
                       device=dev) * s.conv_width**-0.5
    lo, hi = math.log(s.dt_min), math.log(s.dt_max)
    dt = torch.exp(torch.rand((nheads,), generator=generator, device=dev)
                   * (hi - lo) + lo)
    dt_bias = dt + torch.log(-torch.expm1(-dt))   # inverse softplus
    return {
        "in_proj": in_proj,
        "conv": conv.to(pd),
        "conv_bias": torch.zeros((conv_dim,), dtype=pd, device=dev),
        "a_log": torch.log(torch.arange(1, nheads + 1, dtype=torch.float32, device=dev)),
        "dt_bias": dt_bias.to(pd),
        "d_skip": torch.ones((nheads,), dtype=pd, device=dev),
        "gate_norm": {"scale": torch.ones((d_inner,), dtype=pd, device=dev)},
        "out_proj": L.dense_init(generator, cfg, d_inner, cfg.d_model,
                                 scale=d_inner**-0.5),
    }


def _split(cfg: ModelConfig, zxbcdt):
    s = cfg.ssm
    d_inner, nheads, _ = dims(cfg)
    gn = s.ngroups * s.state_dim
    return torch.split(zxbcdt, [d_inner, d_inner, gn, gn, nheads], dim=-1)


def _gated_out(cfg: ModelConfig, p, y_flat, z, use_kernel: bool = True, rows: bool = False):
    # RMSNorm(y * silu(z)) gating, Mamba-2 convention
    g = y_flat * F.silu(z.to(torch.float32)).to(y_flat.dtype)
    g32 = g.to(torch.float32)
    ms = g32.square().mean(-1, keepdim=True)
    g = (g32 * torch.rsqrt(ms + cfg.norm_eps)
         * p["gate_norm"]["scale"].to(torch.float32)).to(L.cdtype(cfg))
    return L.dense_apply(p["out_proj"], g, L.cdtype(cfg), use_kernel, rows)


def causal_conv(xbc, conv):
    """Depthwise causal conv in float32: out[s] = sum_w xbc[s - (W-1-w)]
    conv[w] (zero before the sequence).  xbc [B, S, C], conv [W, C]."""
    xf, wf = xbc.to(torch.float32), conv.to(torch.float32)
    width, slen = wf.shape[0], xf.shape[1]
    out = xf * wf[width - 1]
    for shift in range(1, min(width, slen + 1)):
        out[:, shift:] += xf[:, :slen - shift] * wf[width - 1 - shift]
    return out


def apply(cfg: ModelConfig, p, x, use_kernel: bool = True):
    """Full-sequence forward.  x: [B, S, D] -> [B, S, D]."""
    s = cfg.ssm
    b, slen, _ = x.shape
    d_inner, nheads, _ = dims(cfg)
    dtype = L.cdtype(cfg)

    zxbcdt = L.dense_apply(p["in_proj"], x, dtype, use_kernel)
    z, xin, bmat, cmat, dtt = _split(cfg, zxbcdt)
    xbc = causal_conv(torch.cat([xin, bmat, cmat], -1), p["conv"])
    xbc = F.silu(xbc + p["conv_bias"].to(torch.float32)).to(dtype)
    gn = s.ngroups * s.state_dim
    xin, bmat, cmat = torch.split(xbc, [d_inner, gn, gn], dim=-1)

    xh = xin.reshape(b, slen, nheads, s.head_dim)
    bm = bmat.reshape(b, slen, s.ngroups, s.state_dim)
    cm = cmat.reshape(b, slen, s.ngroups, s.state_dim)
    dt_soft = F.softplus(dtt.to(torch.float32) + p["dt_bias"].to(torch.float32))
    a = -torch.exp(p["a_log"].to(torch.float32))

    y = ssd_ops.ssd(xh.to(torch.float32), dt_soft, a, bm.to(torch.float32),
                    cm.to(torch.float32), use_kernel=use_kernel)
    y = y + xh.to(torch.float32) * p["d_skip"].to(torch.float32)[None, None, :, None]
    y_flat = y.reshape(b, slen, d_inner).to(dtype)
    return _gated_out(cfg, p, y_flat, z, use_kernel)


# --- Serving ------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, dtype, device=None) -> SSMCache:
    """Zeroed state: conv [batch, W-1, conv_dim] in ``dtype``, ssd [batch, H,
    P, N] float32."""
    s = cfg.ssm
    _, nheads, conv_dim = dims(cfg)
    return SSMCache(
        torch.zeros((batch, s.conv_width - 1, conv_dim), dtype=dtype, device=device),
        torch.zeros((batch, nheads, s.head_dim, s.state_dim), dtype=torch.float32,
                    device=device))


def _conv_window(window, conv):
    """One conv output per sequence: window [B, W, C] -> sum_w window[:, w]
    conv[w], [B, C] float32.  Decode and the plain prefill scan share it
    (on contiguous windows of one shape), so they sum in one order."""
    return (window.to(torch.float32) * conv.to(torch.float32)).sum(1)


def _conv_split(cfg: ModelConfig, p, conv_out):
    """silu(conv + bias) in the compute dtype, split into x, B, C."""
    s = cfg.ssm
    d_inner, _, _ = dims(cfg)
    gn = s.ngroups * s.state_dim
    xbc = F.silu(conv_out + p["conv_bias"].to(torch.float32)).to(L.cdtype(cfg))
    return torch.split(xbc, [d_inner, gn, gn], dim=-1)


def _scan_step(cfg: ModelConfig, p, window, dtt, a, h, mt=None):
    """One token's update from its conv window [B, W, C] and dt input [B,
    H]: (new state [B, H, P, N], y [B, H, P] f32 with the d_skip term).
    ``mt`` [B] bool False keeps the state (a pad)."""
    s = cfg.ssm
    b = window.shape[0]
    _, nheads, _ = dims(cfg)
    xin, bmat, cmat = _conv_split(cfg, p, _conv_window(window, p["conv"]))
    xh = xin.reshape(b, nheads, s.head_dim).to(torch.float32)
    bm = bmat.reshape(b, s.ngroups, s.state_dim).to(torch.float32)
    cm = cmat.reshape(b, s.ngroups, s.state_dim).to(torch.float32)
    dt_soft = F.softplus(dtt.to(torch.float32) + p["dt_bias"].to(torch.float32))
    h2, y = ssd_ops.ssd_decode_step_ref(h, xh, dt_soft, a, bm, cm)
    if mt is not None:   # pad step: the state carries through unchanged
        h2 = torch.where(mt[:, None, None, None], h2, h)
    return h2, y + xh * p["d_skip"].to(torch.float32)[None, :, None]


def decode_step(cfg: ModelConfig, p, x, cache: SSMCache, pos=None, token_mask=None,
                use_kernel: bool = True):
    """One-token decode.  x: [B, 1, D] -> (y [B, 1, D], cache updated).
    ``token_mask`` ([B] bool): False marks a pad token, whose conv input is
    zeroed and which leaves the SSD state as it was (the SSM is
    position-free, so ``pos`` is unused)."""
    del pos
    b = x.shape[0]
    d_inner, _, _ = dims(cfg)
    dtype = L.cdtype(cfg)
    rows = plain_path(x, use_kernel)
    zxbcdt = L.dense_apply(p["in_proj"], x[:, 0], dtype, use_kernel, rows)
    z, xin, bmat, cmat, dtt = _split(cfg, zxbcdt)
    xbc = torch.cat([xin, bmat, cmat], -1)
    if token_mask is not None:
        xbc = xbc * token_mask[:, None].to(xbc.dtype)
    hist = torch.cat([cache.conv.to(xbc.dtype), xbc[:, None]], 1)      # [B, W, C]
    a = -torch.exp(p["a_log"].to(torch.float32))
    new_ssd, y = _scan_step(cfg, p, hist, dtt, a, cache.ssd, token_mask)
    out = _gated_out(cfg, p, y.reshape(b, 1, d_inner).to(dtype), z[:, None], use_kernel, rows)
    cache.update(hist[:, 1:].to(cache.conv.dtype).contiguous(), new_ssd)
    return out, cache


def prefill_step(cfg: ModelConfig, p, x, cache: SSMCache, mask=None, use_kernel: bool = True):
    """Prompt-chunk forward with cache write-through: the batched twin of
    ``decode_step``.  x: [B, S, D] -> (y [B, S, D], cache updated).
    ``mask`` ([B, S] bool, True = a real token) marks left pads as
    ``token_mask`` does.  The plain path scans decode's own update; the
    card computes the conv at once and the recurrence through row 8p."""
    if plain_path(x, use_kernel):
        out, _, _ = _scan_core(cfg, p, x, cache, mask, False, use_kernel)
        return out, cache
    s = cfg.ssm
    b, slen, _ = x.shape
    d_inner, nheads, _ = dims(cfg)
    dtype = L.cdtype(cfg)
    zxbcdt = L.dense_apply(p["in_proj"], x, dtype, use_kernel)
    z, xin, bmat, cmat, dtt = _split(cfg, zxbcdt)
    xbc = torch.cat([xin, bmat, cmat], -1)
    if mask is not None:
        xbc = xbc * mask[..., None].to(xbc.dtype)
    hist = torch.cat([cache.conv.to(xbc.dtype), xbc], 1)             # [B, W-1+S, C]
    xin, bmat, cmat = _conv_split(cfg, p, causal_conv(hist, p["conv"])[:, s.conv_width - 1:])
    xh = xin.reshape(b, slen, nheads, s.head_dim).to(torch.float32)
    bm = bmat.reshape(b, slen, s.ngroups, s.state_dim).to(torch.float32)
    cm = cmat.reshape(b, slen, s.ngroups, s.state_dim).to(torch.float32)
    dt_soft = F.softplus(dtt.to(torch.float32) + p["dt_bias"].to(torch.float32))
    a = -torch.exp(p["a_log"].to(torch.float32))
    y, h_final = ssd_ops.ssd_prefill(xh, dt_soft, a, bm, cm, cache.ssd, mask=mask)
    y = y + xh * p["d_skip"].to(torch.float32)[None, None, :, None]
    out = _gated_out(cfg, p, y.reshape(b, slen, d_inner).to(dtype), z, use_kernel)
    cache.update(hist[:, slen:].to(cache.conv.dtype).contiguous(), h_final)
    return out, cache


def verify_step(cfg: ModelConfig, p, x, cache: SSMCache, use_kernel: bool = True):
    """Speculative-verify burst: the per-step scan of ``prefill_step``'s
    plain path on both devices, also returning EVERY per-step state.  x:
    [B, S, D] -> (y [B, S, D], cache after all S steps, states: an
    :class:`SSMCache` with [B, S, ...] leaves, ``states`` at step t the
    state after feeding token t; ``select_state`` rolls back to it)."""
    return _scan_core(cfg, p, x, cache, None, True, use_kernel)


def select_state(states: SSMCache, sel) -> SSMCache:
    """Each sequence's state at step ``sel[b]`` of a burst's stacked states
    ([B, S, ...] leaves): the SSM rollback."""
    rows = torch.arange(states.ssd.shape[0], device=states.ssd.device)
    idx = sel.to(device=rows.device, dtype=torch.long)
    return SSMCache(states.conv[rows, idx], states.ssd[rows, idx])


def _scan_core(cfg: ModelConfig, p, x, cache: SSMCache, mask, collect: bool,
               use_kernel: bool = True):
    """The per-step write-through scan: the projections of all S positions
    at once (row by row on the plain path), then decode's own conv window
    and update step by step.  Returns (y, cache updated, states or
    None)."""
    s = cfg.ssm
    b, slen, _ = x.shape
    d_inner, _, _ = dims(cfg)
    dtype = L.cdtype(cfg)
    rows = plain_path(x, use_kernel)
    zxbcdt = L.dense_apply(p["in_proj"], x, dtype, use_kernel, rows)
    z, xin, bmat, cmat, dtt = _split(cfg, zxbcdt)
    xbc = torch.cat([xin, bmat, cmat], -1)
    if mask is not None:
        xbc = xbc * mask[..., None].to(xbc.dtype)
    hist = torch.cat([cache.conv.to(xbc.dtype), xbc], 1)             # [B, W-1+S, C]
    a = -torch.exp(p["a_log"].to(torch.float32))
    h, ys, hs = cache.ssd, [], []
    for t in range(slen):
        h, yt = _scan_step(cfg, p, hist[:, t:t + s.conv_width].contiguous(), dtt[:, t], a, h,
                           None if mask is None else mask[:, t])
        ys.append(yt)
        if collect:
            hs.append(h)
    states = None
    if collect:
        conv_states = torch.stack([hist[:, t + 1:t + s.conv_width] for t in range(slen)],
                                  dim=1).to(cache.conv.dtype)     # [B, S, W-1, C]
        states = SSMCache(conv_states, torch.stack(hs, dim=1))     # [B, S, H, P, N]
    y_flat = torch.stack(ys, dim=1).reshape(b, slen, d_inner).to(dtype)
    out = _gated_out(cfg, p, y_flat, z, use_kernel, rows)
    cache.update(hist[:, slen:].to(cache.conv.dtype).contiguous(), h)
    return out, cache, states
