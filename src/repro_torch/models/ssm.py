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

Only the full-sequence (training) forward is ported: the decode cache
and the serving steps raise (ROADMAP queue 2 item 7).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models import layers as L


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


def _gated_out(cfg: ModelConfig, p, y_flat, z, use_kernel: bool = True):
    # RMSNorm(y * silu(z)) gating, Mamba-2 convention
    g = y_flat * F.silu(z.to(torch.float32)).to(y_flat.dtype)
    g32 = g.to(torch.float32)
    ms = g32.square().mean(-1, keepdim=True)
    g = (g32 * torch.rsqrt(ms + cfg.norm_eps)
         * p["gate_norm"]["scale"].to(torch.float32)).to(L.cdtype(cfg))
    return L.dense_apply(p["out_proj"], g, L.cdtype(cfg), use_kernel)


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


SERVING_UNPORTED = ("SSM serving (the decode cache and the prefill / decode / "
                    "verify steps) is not ported yet: ROADMAP queue 2 item 7")


def _serving(*_a, **_kw):
    raise NotImplementedError(SERVING_UNPORTED)


init_cache = decode_step = prefill_step = verify_step = _serving
