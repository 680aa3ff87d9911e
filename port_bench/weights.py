"""The float weights the benchmark makes from ``--seed`` on the device and
hands to both sides: the program takes them in its own param tree (and
derives its quantized records from them), the reference reads the same
tensors.  Each layer has a generator of its own, seeded from (seed,
layer), so any one layer can be made again on its own: the reference
remakes them layer by layer after the program's state is freed.  Each
layer is drawn in one call and cut into its matrices.
"""

from __future__ import annotations

import math

import torch

from port_bench.traffic.generator import derive
from port_bench.yardstick import dense_projections, head_dim, padded_vocab, ssm_dims

_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _gen(device, seed: int, *tags: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(derive(seed, 100, *tags))
    return g


def _draw(g, device, shapes: list[tuple]) -> list[torch.Tensor]:
    """Standard normal f32 tensors of ``shapes`` from one draw."""
    sizes = [math.prod(s) for s in shapes]
    flat = torch.randn(sum(sizes), generator=g, device=device)
    return [t.view(s) for t, s in zip(torch.split(flat, sizes), shapes)]


def top(cfg: dict, seed: int, device) -> dict:
    """The embedding (tied: also the LM head) and the final norm."""
    m, w = cfg["model"], cfg["weights"]
    dt = _DT[m["param_dtype"]]
    d, vocab = m["d_model"], m["vocab_size"]
    g = _gen(device, seed, 0)
    emb, fn = _draw(g, device, [(padded_vocab(m), d), (d,)])
    emb.mul_(w["embed_std"])
    emb[vocab:] = 0.0
    out = {"embed": {"embedding": emb.to(dt)},
           "final_norm": {"scale": (1.0 + w["norm_jitter"] * fn).to(dt)}}
    if not m.get("tie_embeddings"):
        (head,) = _draw(g, device, [(d, padded_vocab(m))])
        out["lm_head"] = {"kernel": (head * d ** -0.5).to(dt)}
    return out


def dense_layer(cfg: dict, seed: int, i: int, device) -> dict:
    """Layer ``i`` of an attention + SwiGLU model, in the program's tree."""
    m, w = cfg["model"], cfg["weights"]
    dt = _DT[m["param_dtype"]]
    d, hd = m["d_model"], head_dim(m)
    h, hkv = m["num_heads"], m["num_kv_heads"]
    shapes = dense_projections(m)
    biases = [(h * hd,), (hkv * hd,), (hkv * hd,)]
    drawn = _draw(_gen(device, seed, 1, i), device, shapes + biases + [(d,), (d,)])
    mats = [(t * k ** -0.5).to(dt) for t, (k, _) in zip(drawn, shapes)]
    bq, bk, bv = ((t * w["bias_std"]).to(dt) for t in drawn[7:10])
    n1, n2 = ((1.0 + w["norm_jitter"] * t).to(dt) for t in drawn[10:12])
    attn = {"wq": {"kernel": mats[0]}, "wk": {"kernel": mats[1]},
            "wv": {"kernel": mats[2]}, "wo": {"kernel": mats[3]}}
    if m.get("qkv_bias"):
        attn["wq"]["bias"], attn["wk"]["bias"], attn["wv"]["bias"] = bq, bk, bv
    return {"mixer_norm": {"scale": n1}, "mixer": attn, "ffn_norm": {"scale": n2},
            "ffn": {"wi_gate": {"kernel": mats[4]}, "wi_up": {"kernel": mats[5]},
                    "wo": {"kernel": mats[6]}}}


def ssm_layer(cfg: dict, seed: int, i: int, device) -> dict:
    """Layer ``i`` of an attention-free Mamba-2 model, in the program's tree."""
    m, w = cfg["model"], cfg["weights"]
    s = m["ssm"]
    dt = _DT[m["param_dtype"]]
    d = m["d_model"]
    d_inner, nheads, conv_dim = ssm_dims(m)
    d_in_proj = 2 * d_inner + 2 * s["ngroups"] * s["state_dim"] + nheads
    g = _gen(device, seed, 2, i)
    inp, conv, cb, out, n1, n2 = _draw(g, device, [
        (d, d_in_proj), (s["conv_width"], conv_dim), (conv_dim,), (d_inner, d),
        (d,), (d_inner,)])
    u = torch.rand(2 * nheads, generator=g, device=device)
    a_lo, a_hi = w["a_init"]
    a = a_lo + (a_hi - a_lo) * u[:nheads]
    lo, hi = math.log(s["dt_min"]), math.log(s["dt_max"])
    dt0 = torch.exp(u[nheads:] * (hi - lo) + lo)
    return {
        "mixer_norm": {"scale": (1.0 + w["norm_jitter"] * n1).to(dt)},
        "mixer": {
            "in_proj": {"kernel": (inp * d ** -0.5).to(dt)},
            "conv": (conv * s["conv_width"] ** -0.5).to(dt),
            "conv_bias": (cb * w["conv_bias_std"]).to(dt),
            "a_log": torch.log(a).to(dt),
            "dt_bias": (dt0 + torch.log(-torch.expm1(-dt0))).to(dt),
            "d_skip": torch.ones((nheads,), dtype=dt, device=device),
            "gate_norm": {"scale": (1.0 + w["norm_jitter"] * n2).to(dt)},
            "out_proj": {"kernel": (out * d_inner ** -0.5).to(dt)},
        },
    }


def layer(cfg: dict, seed: int, i: int, device) -> dict:
    if cfg["model"].get("ssm") and not cfg["model"].get("num_heads"):
        return ssm_layer(cfg, seed, i, device)
    return dense_layer(cfg, seed, i, device)


def full(cfg: dict, seed: int, device) -> dict:
    """The whole tree: ``top`` plus every layer."""
    params = top(cfg, seed, device)
    params["layers"] = [layer(cfg, seed, i, device) for i in range(cfg["model"]["num_layers"])]
    return params
