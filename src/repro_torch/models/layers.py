"""Shared model building blocks (port of ``repro/models/layers.py``):
norms, rotary embeddings, dense projections, MLP, embedding, LM head and
the training cross-entropies.

Functions take plain dicts of tensors, as the reference does.  Every
function that reaches a kernel takes ``use_kernel`` (True: the Hopper
kernel on CUDA tensors; False: the plain PyTorch version, asked for
explicitly by a kernel-vs-plain comparison).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def cdtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.compute_dtype]


def pdtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.param_dtype]


# --- Norms -------------------------------------------------------------------

def norm_init(cfg: ModelConfig, dim: int, device):
    p = {"scale": torch.ones((dim,), dtype=pdtype(cfg), device=device)}
    if cfg.norm_type == "layernorm":
        p["bias"] = torch.zeros((dim,), dtype=pdtype(cfg), device=device)
    return p


def norm_apply(cfg: ModelConfig, p, x):
    x32 = x.to(torch.float32)
    if cfg.norm_type == "layernorm":
        mu = x32.mean(-1, keepdim=True)
        var = x32.var(-1, keepdim=True, unbiased=False)
        y = (x32 - mu) * torch.rsqrt(var + cfg.norm_eps)
        y = y * p["scale"].to(torch.float32) + p["bias"].to(torch.float32)
    else:
        ms = x32.square().mean(-1, keepdim=True)
        y = x32 * torch.rsqrt(ms + cfg.norm_eps) * p["scale"].to(torch.float32)
    return y.to(x.dtype)


# --- Rotary embeddings -------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _inv_freq(d: int, theta: float, device: torch.device):
    """RoPE's [d/2] inverse frequencies on ``device``, computed in numpy and
    uploaded once: a pageable copy every call would sync the stream twice a
    layer in each decode tick."""
    return torch.from_numpy(
        1.0 / (theta ** (np.arange(0, d, 2, dtype=np.float32) / d))).to(device)


def rope(x, positions, theta: float):
    """x: [..., S, H, D], positions: [..., S]."""
    inv_freq = _inv_freq(x.shape[-1], theta, x.device)
    angles = positions[..., None].to(torch.float32) * inv_freq   # [..., S, D/2]
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --- Dense projections -------------------------------------------------------

def dense_init(generator, cfg: ModelConfig, d_in: int, d_out: int, *,
               bias=False, scale: float | None = None, device=None):
    """``device``: where the weights are made (default the generator's; a
    CPU generator draws for ``meta`` too, which makes shapes only)."""
    scale = scale if scale is not None else d_in**-0.5
    dev = generator.device if device is None else device
    w = torch.randn((d_in, d_out), generator=generator, device=dev) * scale
    p = {"kernel": w.to(pdtype(cfg))}
    if bias:
        p["bias"] = torch.zeros((d_out,), dtype=pdtype(cfg), device=dev)
    return p


# quantized-record markers (see repro_torch.quant.quantize)
_QUANT_KEYS = ("planes_packed", "planes", "q")


def row_matmul(x, w):
    """x [..., K] @ w [K, N] as a batch of one-row products [1, K] x [K, N]:
    each row's sum then runs in an order that does not depend on how many
    rows the call has, as torch's CPU matmul's does (one order at M = 1,
    another above).  The serving plain path uses it so that a token's row
    is the same in a prompt-wide prefill and in its own decode step."""
    x2 = x.reshape(-1, 1, x.shape[-1])
    y = torch.bmm(x2, w.expand(x2.shape[0], *w.shape))
    return y.reshape(*x.shape[:-1], w.shape[-1])


def dense_apply(p, x, compute_dtype, use_kernel: bool = True, rows: bool = False):
    """``rows``: float weights multiply row by row (:func:`row_matmul`);
    quantized records are integer products, the same for any row count."""
    if any(k in p for k in _QUANT_KEYS):
        from repro_torch.quant.quantize import qdense_apply
        return qdense_apply(p, x, out_dtype=compute_dtype, use_kernel=use_kernel)
    xc, wc = x.to(compute_dtype), p["kernel"].to(compute_dtype)
    y = row_matmul(xc, wc) if rows else xc @ wc
    if "bias" in p:
        y = y + p["bias"].to(compute_dtype)
    return y


# --- MLP (swiglu / gelu) -----------------------------------------------------

def mlp_init(generator, cfg: ModelConfig, d_ff: int | None = None, device=None):
    d_ff = d_ff or cfg.d_ff
    kw = dict(bias=cfg.mlp_bias, device=device)
    if cfg.mlp_type == "swiglu":
        return {
            "wi_gate": dense_init(generator, cfg, cfg.d_model, d_ff, **kw),
            "wi_up": dense_init(generator, cfg, cfg.d_model, d_ff, **kw),
            "wo": dense_init(generator, cfg, d_ff, cfg.d_model, scale=d_ff**-0.5, **kw),
        }
    return {
        "wi": dense_init(generator, cfg, cfg.d_model, d_ff, **kw),
        "wo": dense_init(generator, cfg, d_ff, cfg.d_model, scale=d_ff**-0.5, **kw),
    }


def mlp_apply(cfg: ModelConfig, p, x, use_kernel: bool = True, rows: bool = False):
    dt = cdtype(cfg)
    if cfg.mlp_type == "swiglu":
        g = dense_apply(p["wi_gate"], x, dt, use_kernel, rows)
        u = dense_apply(p["wi_up"], x, dt, use_kernel, rows)
        h = F.silu(g.to(torch.float32)).to(dt) * u
    else:
        h = dense_apply(p["wi"], x, dt, use_kernel, rows)
        h = F.gelu(h.to(torch.float32), approximate="tanh").to(dt)
    return dense_apply(p["wo"], h, dt, use_kernel, rows)


# --- Embeddings / LM head ----------------------------------------------------

def embed_init(generator, cfg: ModelConfig, device=None):
    w = torch.randn((cfg.padded_vocab, cfg.d_model), generator=generator,
                    device=generator.device if device is None else device) * 0.02
    return {"embedding": w.to(pdtype(cfg))}


def embed_apply(cfg: ModelConfig, p, tokens):
    # gather, then cast: the same values as casting the table first
    return p["embedding"][tokens].to(cdtype(cfg))


def lm_head_apply(cfg: ModelConfig, p_head, p_embed, x, rows: bool = False):
    """f32 logits of compute-dtype operands with f32 accumulation (the
    reference's ``preferred_element_type=f32`` dot): both operands are
    rounded to the compute dtype, then multiplied in float32 (row by row
    with ``rows``, as :func:`dense_apply`)."""
    kernel = (p_embed["embedding"].T if cfg.tie_embeddings
              else p_head["kernel"])
    dt = cdtype(cfg)
    xf, wf = x.to(dt).to(torch.float32), kernel.to(dt).to(torch.float32)
    logits = row_matmul(xf, wf) if rows else torch.matmul(xf, wf)
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = c * torch.tanh(logits / c)
    return logits


# --- Cross-entropy -----------------------------------------------------------

def _masked_nll(logits, labels, vocab_size: int):
    """(sum of the nll over labels >= 0, their count): padded vocab
    columns masked to -1e30 before the log-sum-exp."""
    v = logits.shape[-1]
    if v > vocab_size:
        pad = torch.arange(v, device=logits.device) >= vocab_size
        logits = logits.masked_fill(pad, -1e30)
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.clamp_min(0)[..., None].long())[..., 0]
    mask = (labels >= 0).to(torch.float32)
    return ((logz - gold) * mask).sum(), mask.sum()


def cross_entropy(logits, labels, vocab_size: int):
    """Mean CE over labels >= 0 (negative labels = padding).  logits:
    [..., V_padded] f32; labels int."""
    nll, n = _masked_nll(logits, labels, vocab_size)
    return nll / torch.clamp_min(n, 1.0)


def fused_cross_entropy(cfg: ModelConfig, p_head, p_embed, x, labels,
                        chunk: int = 8192):
    """LM head + CE over chunks of ``chunk`` token rows: each chunk's f32
    logits are recomputed in the backward (``torch.utils.checkpoint``), so
    at most one chunk's [chunk, V] logits exist at a time."""
    kernel = (p_embed["embedding"].T if cfg.tie_embeddings
              else p_head["kernel"])
    d = x.shape[-1]
    xt = x.reshape(-1, d)
    lt = labels.reshape(-1)

    def chunk_loss(xi, li, kernel):
        logits = xi.to(torch.float32) @ kernel.to(torch.float32)
        if cfg.logit_softcap:
            c = cfg.logit_softcap
            logits = c * torch.tanh(logits / c)
        return _masked_nll(logits, li, cfg.vocab_size)

    nll = torch.zeros((), dtype=torch.float32, device=x.device)
    n = torch.zeros((), dtype=torch.float32, device=x.device)
    for lo in range(0, xt.shape[0], chunk):
        a, c = checkpoint(chunk_loss, xt[lo:lo + chunk], lt[lo:lo + chunk],
                          kernel, use_reentrant=False)
        nll, n = nll + a, n + c
    return nll / torch.clamp_min(n, 1.0)
