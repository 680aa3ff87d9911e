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

``apply_sharded`` is the expert-parallel layer over a mesh (the
reference's shard_map EP x TP x DP), on the rank's own rows:

  * tokens stay split over the data axes (each rank routes its own T_loc
    tokens; routing is computed identically on every model rank),
  * experts live on the model axis: rank r serves E_loc = max(E/M, 1)
    experts; when E < M each expert is split over R = M/E ranks along
    d_ff (``rank_major_params`` lays the stacks out [M, i, o/R] once),
  * dispatch is a local capacity gather (C = cf T_loc k / E slots, and a
    spill row for the tokens past it),
  * combine is ONE sum over the model axis in ``cfg.moe.combine_dtype``:
    it sums the R d_ff partials and merges different experts' outputs
    (experts a token did not choose add zeros).

Through autograd the layer is Megatron's region: the routing (softmax,
top-k, the auxiliary loss) runs replicated outside it; the tokens and
gates enter through ``collectives.copy_to`` (their cotangents summed
over the model axis, since each rank's experts saw them) and the
combine leaves through ``collectives.reduce_from`` (its cotangent, the
same on every model rank, passes through once).  The auxiliary loss is
computed per data shard and averaged over the data axes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import collectives
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


# --- expert parallel over a mesh ----------------------------------------------

def _rank_major(w, m: int):
    """[E, i, o] -> [M, i, o/R] rank-major layout when E < M (R = M/E)."""
    e, din, dout = w.shape
    if e % m == 0:
        return w   # pure EP: each rank's block of experts is contiguous
    if m % e:
        raise ValueError(f"{e} experts do not tile a model axis of {m}")
    r = m // e
    return w.reshape(e, din, r, dout // r).transpose(1, 2).reshape(m, din, dout // r)


def _rank_major_out(w, m: int):
    """[E, i, o] -> [M, i/R, o] for the row-parallel wo."""
    e, din, dout = w.shape
    if e % m == 0:
        return w
    return w.reshape(m, din // (m // e), dout)


def rank_major_params(params, m: int):
    """Every MoE expert stack of the port's state in the rank-major layout
    (serving's load-time relayout, once); other leaves pass through."""
    def walk(node, under_ffn=False, name=None):
        if isinstance(node, dict):
            return {k: walk(v, under_ffn or k == "ffn", k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, under_ffn) for v in node)
        if under_ffn and node.dim() == 3:
            if name in ("wi", "wi_gate", "wi_up"):
                return _rank_major(node, m)
            if name == "wo":
                return _rank_major_out(node, m)
        return node
    return walk(params)


def apply_sharded(cfg: ModelConfig, p, x, mesh, data_axes, model_axis="model"):
    """Expert-parallel MoE forward on this rank's rows.  x: [B_loc, S, D],
    the rank's rows by ``sharding.batch_pspec`` (the whole batch on every
    rank when it does not divide the data axes: the ranks then route the
    same tokens and the data mean of their equal auxiliary losses is that
    loss).  ``p``: the layer's full params, the expert stacks [E, i, o] or
    already rank-major [M, i, o/R].  Returns (y [B_loc, S, D] in the
    compute dtype, aux_loss f32)."""
    b, s, d = x.shape
    e, k = cfg.moe.num_experts, cfg.moe.top_k
    m = mesh.shape[model_axis]
    e_loc, r = max(e // m, 1), max(m // e, 1)
    dt = L.cdtype(cfg)
    cdt = L._DTYPES[cfg.moe.combine_dtype]
    t_loc = b * s
    cap = capacity(cfg, t_loc)
    xt = x.reshape(t_loc, d)
    probs, gates, idx = route(cfg, p, xt)

    # Switch aux loss per data shard, averaged over the data axes
    f_e = F.one_hot(idx[:, 0], e).to(torch.float32).mean(0)
    aux = e * torch.sum(f_e * probs.mean(0)) * cfg.moe.aux_loss_coef
    aux = collectives.mean_over(aux, mesh, data_axes)

    rank = mesh.coords[model_axis]

    def block(w, major):
        """This rank's E_loc [i, o] slices of a stack, in the compute dtype
        (``unbind``: the backward stacks their gradients once, where
        indexing each would write a whole stack of zeros an expert)."""
        if w.shape[0] != m:
            w = major(w, m)
        return w[rank * e_loc:(rank + 1) * e_loc].to(dt).unbind(0)

    names = ("wi_gate", "wi_up") if cfg.mlp_type == "swiglu" else ("wi",)
    w_in = [block(p[n], _rank_major) for n in names]
    w_out = block(p["wo"], _rank_major_out)

    xr = collectives.copy_to(xt, mesh, model_axis).to(dt)
    gr = collectives.copy_to(gates, mesh, model_axis)
    e0 = (rank // r) * e_loc
    out = torch.zeros((t_loc, d), dtype=cdt, device=x.device)
    zero, czero = (torch.zeros((), dtype=t, device=x.device) for t in (dt, cdt))
    for j in range(e_loc):
        sel = idx == e0 + j                                      # [T_loc, k]
        gate_e = torch.where(sel, gr, 0.0).sum(-1)
        chose = sel.any(-1)
        pos = torch.cumsum(chose.to(torch.int32), 0) - 1
        keep = chose & (pos < cap)
        slot = torch.where(keep, pos, cap)                       # cap = the spill row
        buf = torch.zeros((cap + 1, d), dtype=dt, device=x.device).index_add(
            0, slot, torch.where(keep[:, None], xr, zero))
        h_in = buf[:cap]
        if cfg.mlp_type == "swiglu":
            g, u = h_in @ w_in[0][j], h_in @ w_in[1][j]
            h = F.silu(g.to(torch.float32)).to(dt) * u
        else:
            h = F.gelu((h_in @ w_in[0][j]).to(torch.float32), approximate="tanh").to(dt)
        o_buf = (h @ w_out[j]).to(cdt)                           # [cap, D]
        gathered = o_buf[pos.clamp(0, cap - 1)]
        out = out + torch.where(keep[:, None], gathered, czero) * gate_e[:, None].to(cdt)
    out = collectives.reduce_from(out, mesh, model_axis)        # experts + d_ff parts
    return out.reshape(b, s, d).to(dt), aux
