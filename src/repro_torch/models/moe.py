"""Top-k MoE layer with capacity-based dispatch (port of
``repro/models/moe.py``: ``init`` and ``apply``).

Routing: a float router (``skip_patterns`` keeps it out of
quantization), the softmax over its f32 logits, the top-k gates
renormalised (Mixtral's convention).  Dispatch is the reference's exactly:
``capacity = max(int(cf T k / E + 0.5), 1)``; each flattened (token, k)
pair, in token-major order, takes the position of an exclusive cumsum
over the one-hot experts; pairs at or past the capacity are dropped
(their rows scatter zeros into the last slot, ``safe_pos``); the expert
FFN runs batched over the E capacity buffers ([E, C, D]); the combine
gathers each pair's row back, zero where dropped, weights it by its gate
in the compute dtype and sums a token's k rows in slot order, which is
what the reference's ``.at[].add`` over token-major pairs sums and needs
no atomics.  The Switch auxiliary loss ``E sum_e f_e p_e coef`` comes
back beside the output.

The expert products are ``torch.bmm`` calls, as the reference's
``einsum`` calls sit outside any Pallas kernel; the expert stacks [E, in,
out] stay float (the reference's quantization walk matches ``{"kernel":
...}`` records only) and are cast to the compute dtype before each
product, so bf16 storage changes no product of a bf16 model.
``apply_sharded`` and ``rank_major_params`` (the reference's
expert-parallel layout) are not ported: the port serves on one card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L


def init(generator, cfg: ModelConfig):
    e, d, f = cfg.moe.num_experts, cfg.d_model, cfg.d_ff
    pd, dev = L.pdtype(cfg), generator.device

    def ek(din, dout, scale):
        w = torch.randn((e, din, dout), generator=generator, device=dev) * scale
        return w.to(pd)

    p = {"router": L.dense_init(generator, cfg, d, e, scale=d**-0.5)}
    if cfg.mlp_type == "swiglu":
        p["wi_gate"] = ek(d, f, d**-0.5)
        p["wi_up"] = ek(d, f, d**-0.5)
        p["wo"] = ek(f, d, f**-0.5)
    else:
        p["wi"] = ek(d, f, d**-0.5)
        p["wo"] = ek(f, d, f**-0.5)
    return p


def capacity(cfg: ModelConfig, tokens: int) -> int:
    """Slots an expert's buffer holds for ``tokens`` tokens."""
    m = cfg.moe
    return max(int(m.capacity_factor * tokens * m.top_k / m.num_experts + 0.5), 1)


def route(cfg: ModelConfig, p, xt, rows: bool = False):
    """xt [T, D] -> (probs f32 [T, E], renormalised top-k gates f32 [T, k],
    their experts [T, k] int64)."""
    logits = L.dense_apply(p["router"], xt, torch.float32, rows=rows)
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, cfg.moe.top_k, dim=-1)
    return probs, gates / gates.sum(-1, keepdim=True), idx


def dispatch(cfg: ModelConfig, idx):
    """Each flattened (token, k) pair's expert [T k], its position in that
    expert's buffer [T k] (an exclusive cumsum in token-major order) and
    whether it fits the capacity [T k]."""
    e = cfg.moe.num_experts
    flat = idx.reshape(-1)
    onehot = F.one_hot(flat, e).to(torch.int32)
    pos = (torch.cumsum(onehot, dim=0) - onehot).gather(1, flat[:, None])[:, 0]
    return flat, pos, pos < capacity(cfg, idx.shape[0])


def _experts(buf, w, rows: bool):
    """[E, C, i] x [E, i, o] -> [E, C, o]: one ``bmm``, or with ``rows``
    each buffer row its own one-row product (``layers.row_matmul``), whose
    sum does not depend on how many rows the buffer holds."""
    if not rows:
        return torch.bmm(buf, w)
    return torch.stack([L.row_matmul(buf[i], w[i]) for i in range(buf.shape[0])])


def apply(cfg: ModelConfig, p, x, rows: bool = False):
    """x: [B, S, D] -> (y [B, S, D] in the compute dtype, aux_loss f32).
    ``rows`` (the serving plain path): the router and the expert products
    multiply row by row, so that a token's output is the same in a
    prompt-wide prefill as in its own decode step where nothing drops."""
    b, s, d = x.shape
    e, k = cfg.moe.num_experts, cfg.moe.top_k
    t = b * s
    xt = x.reshape(t, d)
    dt = L.cdtype(cfg)
    probs, gates, idx = route(cfg, p, xt, rows)

    # aux load-balance loss (Switch): E sum_e f_e p_e, f_e the top-1 fraction
    f_e = F.one_hot(idx[:, 0], e).to(torch.float32).mean(0)
    aux = e * torch.sum(f_e * probs.mean(0)) * cfg.moe.aux_loss_coef

    cap = capacity(cfg, t)
    flat, pos, keep = dispatch(cfg, idx)
    safe = torch.where(keep, pos, cap - 1)
    zero = torch.zeros((), dtype=dt, device=x.device)
    pairs = torch.where(keep[:, None], xt.to(dt).repeat_interleave(k, dim=0), zero)
    buf = torch.zeros((e, cap, d), dtype=dt, device=x.device)
    buf.index_put_((flat, safe), pairs, accumulate=True)

    # expert FFN, batched over E
    if cfg.mlp_type == "swiglu":
        g = _experts(buf, p["wi_gate"].to(dt), rows)
        u = _experts(buf, p["wi_up"].to(dt), rows)
        h = F.silu(g.to(torch.float32)).to(dt) * u
    else:
        h = _experts(buf, p["wi"].to(dt), rows)
        h = F.gelu(h.to(torch.float32), approximate="tanh").to(dt)
    out = _experts(h, p["wo"].to(dt), rows)                          # [E, C, D]

    # combine: each pair's row, zero where dropped, times its gate; a
    # token's k rows summed in slot order
    gathered = torch.where(keep[:, None], out[flat, safe], zero)
    weighted = (gathered * gates.reshape(-1)[:, None].to(dt)).reshape(t, k, d)
    y = torch.zeros((t, d), dtype=dt, device=x.device)
    for j in range(k):
        y = y + weighted[:, j]
    return y.reshape(b, s, d), aux
