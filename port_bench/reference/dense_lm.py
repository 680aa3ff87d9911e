"""Plain float32 reference of a dense decoder LM served in w8a8 (Qwen2.5's
layer: pre-RMSNorm GQA attention with QKV biases and rotary positions,
pre-RMSNorm SwiGLU MLP, tied or untied LM head).

The weights are the benchmark's (``port_bench.weights``), remade layer by
layer.  Every projection's weight is quantized here, symmetric per output
column to ``levels`` (127: int8), and every input row of a projection to
int8 (symmetric per row, round half to even); the integer products are
exact in float32 at these widths, scaled back by both scales.  Everything
else is float32.  ``levels=7`` (int4 weights) is the control: the step
below int8.
"""

from __future__ import annotations

import torch

from port_bench import weights as W
from port_bench.yardstick import head_dim

ACT_LEVELS = 127


def _f32_products():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def quantize_columns(w, levels: int):
    """(integer-valued f32 [K, N], f32 scale [1, N]) of ``w`` [K, N]."""
    w = w.float()
    scale = w.abs().amax(dim=0, keepdim=True).clamp_min(1e-12) / levels
    return torch.clamp(torch.round(w / scale), -levels, levels), scale


def qlinear(x, rec):
    """x [S, K] f32 through a quantized record (q, scale[, bias])."""
    sx = x.abs().amax(dim=-1, keepdim=True).clamp_min(1e-12) / ACT_LEVELS
    xq = torch.clamp(torch.round(x / sx), -ACT_LEVELS, ACT_LEVELS)
    y = (xq @ rec["q"]) * sx * rec["scale"]
    if "bias" in rec:
        y = y + rec["bias"]
    return y


def rmsnorm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale.float()


def rope(x, theta: float):
    """x [S, H, D] at positions 0 .. S-1, rotate-half convention."""
    s, _, d = x.shape
    inv = 1.0 / theta ** (torch.arange(0, d, 2, device=x.device, dtype=torch.float64) / d)
    ang = (torch.arange(s, device=x.device, dtype=torch.float64)[:, None] * inv).float()
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, block: int = 1024):
    """Causal GQA: q [S, H, D], k / v [S, Hkv, D] -> [S, H * D]; query head
    j reads kv head j // (H / Hkv)."""
    s, h, d = q.shape
    group = h // k.shape[1]
    k = k.repeat_interleave(group, dim=1).transpose(0, 1)       # [H, S, D]
    v = v.repeat_interleave(group, dim=1).transpose(0, 1)
    qt = q.transpose(0, 1) * d ** -0.5
    out = torch.empty((h, s, d), device=q.device, dtype=torch.float32)
    cols = torch.arange(s, device=q.device)
    for lo in range(0, s, block):
        hi = min(lo + block, s)
        sc = qt[:, lo:hi] @ k[:, :hi].transpose(1, 2)               # [H, b, hi]
        mask = cols[None, :hi] > torch.arange(lo, hi, device=q.device)[:, None]
        sc = sc.masked_fill(mask, float("-inf"))
        out[:, lo:hi] = torch.softmax(sc, dim=-1) @ v[:, :hi]
    return out.transpose(0, 1).reshape(s, h * d)


def _quantized(layer: dict, levels: int) -> dict:
    recs = {}
    for part in ("mixer", "ffn"):
        for name, p in layer[part].items():
            q, scale = quantize_columns(p["kernel"], levels)
            rec = {"q": q, "scale": scale}
            if "bias" in p:
                rec["bias"] = p["bias"].float()
            recs[f"{part}.{name}"] = rec
    return recs


def _layer(m: dict, layer: dict, recs: dict, x):
    s = x.shape[0]
    hd, h, hkv, eps = head_dim(m), m["num_heads"], m["num_kv_heads"], m["norm_eps"]
    a = rmsnorm(x, layer["mixer_norm"]["scale"], eps)
    q = rope(qlinear(a, recs["mixer.wq"]).view(s, h, hd), m["rope_theta"])
    k = rope(qlinear(a, recs["mixer.wk"]).view(s, hkv, hd), m["rope_theta"])
    v = qlinear(a, recs["mixer.wv"]).view(s, hkv, hd)
    x = x + qlinear(attention(q, k, v), recs["mixer.wo"])
    f = rmsnorm(x, layer["ffn_norm"]["scale"], eps)
    g = qlinear(f, recs["ffn.wi_gate"])
    u = qlinear(f, recs["ffn.wi_up"])
    return x + qlinear(torch.nn.functional.silu(g) * u, recs["ffn.wo"])


@torch.no_grad()
def logits_at(cfg: dict, seed: int, seqs, device, levels: int = 127):
    """``seqs``: [(tokens, positions)]; for each, the f32 logits [len(positions),
    padded vocab] at those positions of the whole sequence's forward."""
    _f32_products()
    m = cfg["model"]
    top = W.top(cfg, seed, device)
    emb = top["embed"]["embedding"]
    xs = [emb[torch.as_tensor(t, device=device, dtype=torch.long)].float() for t, _ in seqs]
    for i in range(m["num_layers"]):
        layer = W.layer(cfg, seed, i, device)
        recs = _quantized(layer, levels)
        xs = [_layer(m, layer, recs, x) for x in xs]
        del layer, recs
    head = (emb if m.get("tie_embeddings") else top["lm_head"]["kernel"].T).float()
    out = []
    for x, (_, pos) in zip(xs, seqs):
        rows = rmsnorm(x[torch.as_tensor(pos, device=device)],
                       top["final_norm"]["scale"], m["norm_eps"])
        out.append(rows @ head.T)
    return out
