"""Plain float32 reference of Mamba-2 language-model training (arXiv:2405.21060):
pre-RMSNorm Mamba-2 mixers (in_proj -> depthwise causal conv -> SiLU -> SSD
-> D skip -> RMSNorm(y * SiLU(z)) -> out_proj), a final RMSNorm, a tied
LM head, mean cross-entropy over the vocabulary, and AdamW with global
norm clipping, decoupled weight decay on every leaf and a linear warmup
into cosine decay.

The SSD is the chunked algorithm (the paper's ``ssd_minimal``) in float32:
within a chunk the masked decay matrix, across chunks a sequential carry
of the state.  Each layer is recomputed in the backward
(``torch.utils.checkpoint``), so the reference fits beside nothing else.
``cast`` rounds the params at use and the operands of every product (the
control: ``to_fp8``).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from port_bench import weights as W
from port_bench.yardstick import ssm_dims

CHUNK = 128


def to_fp8(t):
    """``t``'s values rounded to float8 e4m3 under one scale for the tensor
    (its absolute maximum at 448), in float32; the gradient passes through
    as float32 (the rounding is the forward operand's only)."""
    scale = t.detach().abs().amax().clamp_min(1e-30) / 448.0
    low = (t.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return t + (low - t.detach())


def _same(t):
    return t


def paths(tree, prefix=""):
    """[(path, tensor)] of a nested dict / list tree, in a fixed order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in paths(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in paths(v, f"{prefix}/{i}")]
    return [(prefix, tree)]


def rmsnorm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def ssd(x, dt, a, b, c, chunk: int = CHUNK):
    """x [B, L, H, P], dt [B, L, H], a [H] (negative), b / c [B, L, G, N]
    -> y [B, L, H, P]: h_t = exp(dt_t a) h_{t-1} + dt_t x_t b_t^T,
    y_t = h_t c_t, from the zero state."""
    bsz, length, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    q = min(chunk, length)
    nc = length // q
    hpg = h // g
    xd = (x * dt[..., None]).view(bsz, nc, q, h, p)
    adt = (dt * a).view(bsz, nc, q, h).permute(0, 3, 1, 2)          # [B, H, C, Q]
    cum = torch.cumsum(adt, dim=-1)
    bc = b.view(bsz, nc, q, g, n).repeat_interleave(hpg, dim=3)       # [B, C, Q, H, N]
    cc = c.view(bsz, nc, q, g, n).repeat_interleave(hpg, dim=3)
    tril = torch.ones(q, q, dtype=torch.bool, device=x.device).tril()
    seg = (cum[..., :, None] - cum[..., None, :]).masked_fill(~tril, float("-inf"))
    cb = torch.einsum("bclhn,bcshn->bhcls", cc, bc)
    y = torch.einsum("bhcls,bcshp->bclhp", cb * torch.exp(seg), xd)
    decay = torch.exp(cum[..., -1:] - cum)                            # [B, H, C, Q]
    own = torch.einsum("bclhn,bclhp->bchpn", bc, xd * decay.permute(0, 2, 3, 1)[..., None])
    total = torch.exp(cum[..., -1])                                   # [B, H, C]
    state = torch.zeros((bsz, h, p, n), device=x.device, dtype=x.dtype)
    entering = []
    for k in range(nc):
        entering.append(state)
        state = state * total[:, :, k, None, None] + own[:, k]
    ent = torch.stack(entering, dim=1)                                # [B, C, H, P, N]
    y = y + torch.einsum("bclhn,bchpn->bclhp", cc, ent) * torch.exp(cum).permute(0, 2, 3, 1)[..., None]
    return y.reshape(bsz, length, h, p)


def mixer(m: dict, p: dict, x, cast):
    s = m["ssm"]
    bsz, length, _ = x.shape
    d_inner, nheads, _ = ssm_dims(m)
    gn = s["ngroups"] * s["state_dim"]
    zxbcdt = cast(x) @ cast(p["in_proj"]["kernel"])
    z, xbc, dtr = torch.split(zxbcdt, [d_inner, d_inner + 2 * gn, nheads], dim=-1)
    conv = cast(p["conv"])
    width = conv.shape[0]
    out = xbc * conv[width - 1]
    for shift in range(1, width):
        out = out + F.pad(xbc[:, :length - shift], (0, 0, shift, 0)) * conv[width - 1 - shift]
    xbc = F.silu(out + cast(p["conv_bias"]))
    xs, bm, cm = torch.split(xbc, [d_inner, gn, gn], dim=-1)
    dt = F.softplus(dtr + cast(p["dt_bias"]))
    a = -torch.exp(cast(p["a_log"]))
    xh = xs.reshape(bsz, length, nheads, s["head_dim"])
    y = ssd(xh, dt, a, bm.reshape(bsz, length, s["ngroups"], s["state_dim"]),
            cm.reshape(bsz, length, s["ngroups"], s["state_dim"]))
    y = (y + xh * cast(p["d_skip"])[None, None, :, None]).reshape(bsz, length, d_inner)
    gated = rmsnorm(y * F.silu(z), cast(p["gate_norm"]["scale"]), m["norm_eps"])
    return cast(gated) @ cast(p["out_proj"]["kernel"])


def loss(cfg: dict, params: dict, tokens, labels, cast=_same):
    """Mean cross-entropy of one microbatch (tokens / labels [B, S] long)."""
    m = cfg["model"]
    emb = cast(params["embed"]["embedding"])
    x = emb[tokens]
    for layer in params["layers"]:
        def block(x, layer=layer):
            h = rmsnorm(x, cast(layer["mixer_norm"]["scale"]), m["norm_eps"])
            return x + mixer(m, layer["mixer"], h, cast)
        x = checkpoint(block, x, use_reentrant=False)
    x = rmsnorm(x, cast(params["final_norm"]["scale"]), m["norm_eps"])
    head = emb if m.get("tie_embeddings") else cast(params["lm_head"]["kernel"]).T
    logits = cast(x) @ head.T
    if logits.shape[-1] > m["vocab_size"]:
        logits = logits.masked_fill(
            torch.arange(logits.shape[-1], device=logits.device) >= m["vocab_size"], -1e30)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]), labels.reshape(-1))


def lr_at(o: dict, step: int) -> float:
    """Linear warmup, then cosine decay to a tenth of the peak."""
    warm = min(step / o["warmup_steps"], 1.0) if o["warmup_steps"] > 0 else 1.0
    t = min(max((step - o["warmup_steps"]) / max(o["total_steps"] - o["warmup_steps"], 1), 0.0), 1.0)
    if o["schedule"] != "cosine":
        raise ValueError(f"the reference follows a cosine schedule, not {o['schedule']!r}")
    return o["lr"] * warm * (0.5 * (1 + math.cos(math.pi * t)) * 0.9 + 0.1)


def train(cfg: dict, seed: int, batches, microbatch: int, device, cast=_same,
          rows=None) -> dict:
    """Steps of AdamW from the benchmark's weights over ``batches`` ([B, S + 1]
    int arrays, one a step).  ``rows`` keeps only those rows of each batch
    (a planted fault).  Returns {"loss": [per step], "grad": {path: norm of
    the first step's clipped gradient}, "change": {path: norm of the change
    after the last step}}."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    o = cfg["train"]["optim"]
    params = W.full(cfg, seed, device)
    leaves = paths(params)
    start = [t.detach().clone() for _, t in leaves]
    for _, t in leaves:
        t.requires_grad_(True)
    mom = [torch.zeros_like(t) for _, t in leaves]
    vel = [torch.zeros_like(t) for _, t in leaves]
    out = {"loss": []}
    for step, batch in enumerate(batches, start=1):
        toks = torch.as_tensor(np.asarray(batch), device=device, dtype=torch.long)
        if rows is not None:
            toks = toks[rows]
        micro = range(0, toks.shape[0], microbatch)
        total = 0.0
        for lo in micro:
            mb = toks[lo:lo + microbatch]
            value = loss(cfg, params, mb[:, :-1], mb[:, 1:], cast)
            (value / len(micro)).backward()
            total += value.item() / len(micro)
        out["loss"].append(total)
        with torch.no_grad():
            grads = [t.grad for _, t in leaves]
            norm = torch.sqrt(sum(g.square().sum() for g in grads))
            clip = min(o["grad_clip"] / max(norm.item(), 1e-12), 1.0) if o["grad_clip"] > 0 else 1.0
            lr = lr_at(o, step)
            bc1, bc2 = 1 - o["beta1"] ** step, 1 - o["beta2"] ** step
            for (_, t), g, mt, vt in zip(leaves, grads, mom, vel):
                g = g * clip
                mt.mul_(o["beta1"]).add_(g, alpha=1 - o["beta1"])
                vt.mul_(o["beta2"]).addcmul_(g, g, value=1 - o["beta2"])
                upd = (mt / bc1) / ((vt / bc2).sqrt() + o["eps"]) + o["weight_decay"] * t
                t.sub_(lr * upd)
                t.grad = None
            if step == 1:
                out["grad"] = {path: float((mt / (1 - o["beta1"])).norm())
                               for (path, _), mt in zip(leaves, mom)}
    with torch.no_grad():
        out["change"] = {path: float((t - t0).norm()) for (path, t), t0 in zip(leaves, start)}
    return out
