"""Plain PyTorch versions of the SSD scan kernels (port of
``repro/kernels/ssd_scan/ref.py``).

Shapes, as the reference: x [B, L, H, P], dt [B, L, H] (post-softplus,
> 0), a [H] (< 0), b / c [B, L, G, N] shared by the H / G heads of each
group; y [B, L, H, P].  Per head the recurrence over a [P, N] state is

    h_t = exp(dt_t a) h_{t-1} + dt_t x_t B_t^T,    y_t = h_t C_t.

* ``ssd_scan_ref`` (reference :9): the per-timestep recurrence.
* ``ssd_decode_step_ref`` (:40): one decode step.
* ``ssd_scan_chunked`` (:56): the chunk algorithm of the Pallas kernel.
  Within a chunk of Q steps, with cum the inclusive cumsum of dt a:
  intra y_i = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j, the
  exponent masked to -inf above the diagonal before ``exp`` (reference
  :97-100); inter y_i += exp(cum_i) h0 C_i; state h = exp(cum_Q) h0 +
  sum_j exp(cum_Q - cum_j) dt_j x_j B_j^T.  The intra terms of all
  chunks are computed at once and only the [B, H, P, N] state update
  runs chunk by chunk: the same sums as the reference's ``lax.scan``
  over chunks, in another order.
* ``ssd_scan_fwd_ref``: ``ssd_scan_chunked`` that also returns each
  chunk's entering state h0s, f32 [B, H, nc, P, N] (h0s[:, :, 0] = 0):
  the plain version of the forward kernel with ``save_states``.
* ``ssd_scan_bwd_state_ref``, ``ssd_scan_bwd_chunk_ref`` and their
  composition ``ssd_scan_bwd_ref``: the backward, written as explicit
  formulas (the plain versions of the two backward kernels; the
  reference has no backward kernel and differentiates its jnp path).
  dhs[:, :, c] is the gradient of the state leaving chunk c
  (dhs[:, :, nc-1] = 0), carried in reverse:
  dhs[c-1] = exp(cum_Q^c) dhs[c] + sum_{i in c} exp(cum_i) dy_i C_i^T.
  Per chunk, with S_ij = C_i . B_j, L_ij = exp(cum_i - cum_j) (j <= i,
  else 0), W_ij = (dy_i . x_j) L_ij, h0 = h0s[c] and dh = dhs[c]:
    dx_j  = dt_j sum_i S_ij L_ij dy_i + dt_j exp(cum_Q - cum_j) dh B_j
    dC_i  = sum_j W_ij dt_j B_j + exp(cum_i) h0^T dy_i
    dB_j  = sum_i W_ij dt_j C_i + dt_j exp(cum_Q - cum_j) dh^T x_j
    ddt_j = sum_i W_ij S_ij + exp(cum_Q - cum_j) x_j . dh B_j  (+ a dda_j)
  and the gradient of cum, dcum_k = sum_j T_kj - sum_i T_ik (T = W S
  dt_j) + exp(cum_k) dy_k . h0 C_k - U_k, with U_j = dt_j exp(cum_Q -
  cum_j) x_j . dh B_j and, at k = Q - 1, + exp(cum_Q) <h0, dh> +
  sum_j U_j.  dcum reverse-cumsummed within the chunk is d(dt a) = dda:
  ddt_j += a dda_j and da += sum_j dt_j dda_j.  dB and dC are summed
  over the heads of each group, da over batch rows and chunks.

``einsum`` (default ``torch.einsum``) takes every chunk product of
``ssd_scan_fwd_ref``, ``ssd_scan_bwd_state_ref`` and
``ssd_scan_bwd_chunk_ref``: ``split_bf16_einsum``
emulates the tensor-core kernels' split-bf16 three-pass products (each
operand a = hi + lo, hi = bf16(a), lo = bf16(a - hi); a b taken as hi hi
+ hi lo + lo hi, accumulated in f32), ``bf16_einsum`` one bf16 pass.  No
path of the port uses them: they are for the tests.

Everything is computed in float32 (float64 for float64 inputs, which
the gradient checks use); ``ssd_scan_ref`` and ``ssd_scan_chunked``
return x's dtype, as the reference.
"""

from __future__ import annotations

import torch


def _check(x, dt, a, b, c, chunk: int | None = None):
    """(B, L, H, P, G, N, chunk clamped to L) after the shape checks."""
    if x.dim() != 4 or dt.shape != x.shape[:3] or a.shape != x.shape[2:3]:
        raise ValueError(f"x {tuple(x.shape)}, dt {tuple(dt.shape)}, a {tuple(a.shape)}")
    bsz, l, h, p = x.shape
    if b.dim() != 4 or b.shape != c.shape or b.shape[:2] != (bsz, l):
        raise ValueError(f"b {tuple(b.shape)} and c {tuple(c.shape)} must be "
                         f"[{bsz}, {l}, G, N]")
    g, n = b.shape[2], b.shape[3]
    if h % g:
        raise ValueError(f"H={h} is not a multiple of G={g}")
    if chunk is not None:
        chunk = min(chunk, l)
        if chunk <= 0 or l % chunk:
            raise ValueError(f"L={l} is not a multiple of chunk={chunk}")
    return bsz, l, h, p, g, n, chunk


def _wide(t):
    """float32, or float64 for float64 input (the gradient checks)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _heads(t, hpg):
    """[B, L, G, N] f32 -> [B, L, H, N]: each group's row for its heads."""
    return _wide(t).repeat_interleave(hpg, dim=2)


def ssd_scan_ref(x, dt, a, b, c):
    """Sequential recurrence: y [B, L, H, P] in x's dtype."""
    bsz, l, h, p, g, n, _ = _check(x, dt, a, b, c)
    bf, cf = _heads(b, h // g), _heads(c, h // g)
    xf, dtf, af = _wide(x), _wide(dt), _wide(a)
    state = torch.zeros((bsz, h, p, n), dtype=xf.dtype, device=x.device)
    ys = []
    for t in range(l):
        decay = torch.exp(dtf[:, t] * af[None, :])
        state = (state * decay[..., None, None]
                 + dtf[:, t, :, None, None] * xf[:, t, :, :, None] * bf[:, t, :, None, :])
        ys.append(torch.einsum("bhpn,bhn->bhp", state, cf[:, t]))
    return torch.stack(ys, dim=1).to(x.dtype)


def ssd_decode_step_ref(h_state, xt, dtt, a, bt, ct):
    """One decode step: (new state [B, H, P, N], y_t [B, H, P]).
    h_state [B, H, P, N]; xt [B, H, P]; dtt [B, H]; a [H]; bt / ct
    [B, G, N] (group-shared)."""
    hpg = h_state.shape[1] // bt.shape[1]
    bt = bt.repeat_interleave(hpg, dim=1)
    ct = ct.repeat_interleave(hpg, dim=1)
    decay = torch.exp(dtt * a[None, :])
    h_state = (h_state * decay[..., None, None]
               + dtt[..., None, None] * xt[..., :, None] * bt[..., None, :])
    return h_state, torch.einsum("bhpn,bhn->bhp", h_state, ct)


def _split_bf16(t):
    """(hi, lo) of float32 ``t`` as float32 tensors holding bf16 values."""
    hi = t.to(torch.bfloat16).to(t.dtype)
    return hi, (t - hi).to(torch.bfloat16).to(t.dtype)


def split_bf16_einsum(eq, a, b):
    """``torch.einsum(eq, a, b)`` as the SSD kernels' tensor cores take it:
    hi hi + hi lo + lo hi of the split operands, each product exact and
    summed in float32."""
    (ah, al), (bh, bl) = _split_bf16(a), _split_bf16(b)
    return torch.einsum(eq, ah, bh) + torch.einsum(eq, ah, bl) + torch.einsum(eq, al, bh)


def bf16_einsum(eq, a, b):
    """One bf16 pass: both operands rounded to bf16, summed in float32."""
    return torch.einsum(eq, _split_bf16(a)[0], _split_bf16(b)[0])


def _chunk_operands(x, dt, a, b, c, chunk):
    """f32 operands split into chunks: x [B, nc, Q, H, P], dt [B, nc, Q, H],
    b / c per head [B, nc, Q, H, N], cum (inclusive in-chunk cumsum of
    dt a) [B, nc, Q, H], and the exp of the masked decay exponent
    L [B, nc, H, Q, Q] (zero above the diagonal)."""
    bsz, l, h, p, g, n, q = _check(x, dt, a, b, c, chunk)
    nc = l // q
    xf = _wide(x).reshape(bsz, nc, q, h, p)
    dtf = _wide(dt).reshape(bsz, nc, q, h)
    bf = _heads(b, h // g).reshape(bsz, nc, q, h, n)
    cf = _heads(c, h // g).reshape(bsz, nc, q, h, n)
    cum = torch.cumsum(dtf * _wide(a), dim=2)
    cum_t = cum.transpose(2, 3)                                  # [B, nc, H, Q]
    causal = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    ldecay = torch.where(causal, cum_t[..., :, None] - cum_t[..., None, :],
                         -float("inf"))
    return xf, dtf, bf, cf, cum, torch.exp(ldecay)


def ssd_scan_fwd_ref(x, dt, a, b, c, chunk: int = 128, einsum=torch.einsum):
    """The chunk algorithm: (y f32 [B, L, H, P], h0s f32 [B, H, nc, P, N],
    each chunk's entering state; the first is zeros).  Differentiable."""
    xf, dtf, bf, cf, cum, decay = _chunk_operands(x, dt, a, b, c, chunk)
    bsz, nc, q, h, p = xf.shape
    scores = (einsum("bcihn,bcjhn->bchij", cf, bf) * decay
              * dtf.transpose(2, 3)[..., None, :])
    y = einsum("bchij,bcjhp->bcihp", scores, xf)
    # each chunk's own state contribution, then the chunk-to-chunk carry
    wj = torch.exp(cum[:, :, -1:, :] - cum) * dtf                # [B, nc, Q, H]
    own = einsum("bcjhp,bcjhn->bchpn", xf * wj[..., None], bf)
    carry = torch.exp(cum[:, :, -1])                             # [B, nc, H]
    state = torch.zeros_like(own[:, 0])
    h0s = []
    for ci in range(nc):
        h0s.append(state)
        state = state * carry[:, ci, :, None, None] + own[:, ci]
    h0s = torch.stack(h0s, dim=2)                                # [B, H, nc, P, N]
    y = y + (einsum("bcihn,bhcpn->bcihp", cf, h0s)
             * torch.exp(cum)[..., None])
    return y.reshape(bsz, nc * q, h, p), h0s


def ssd_scan_chunked(x, dt, a, b, c, chunk: int = 128):
    """y [B, L, H, P] in x's dtype by the chunk algorithm."""
    return ssd_scan_fwd_ref(x, dt, a, b, c, chunk)[0].to(x.dtype)


def ssd_scan_bwd_state_ref(dt, a, c, dy, chunk: int = 128, einsum=torch.einsum):
    """dhs f32 [B, H, nc, P, N]: the gradient of the state leaving each
    chunk, carried from the last chunk (zeros) to the first."""
    bsz, l, h, p = dy.shape
    _, _, _, _, g, n, q = _check(dy, dt, a, c, c, chunk)
    nc = l // q
    dyf = _wide(dy).reshape(bsz, nc, q, h, p)
    cf = _heads(c, h // g).reshape(bsz, nc, q, h, n)
    cum = torch.cumsum(_wide(dt).reshape(bsz, nc, q, h) * _wide(a), dim=2)
    own = einsum("bcihp,bcihn->bchpn", dyf * torch.exp(cum)[..., None], cf)
    carry = torch.exp(cum[:, :, -1])
    dh = torch.zeros_like(own[:, 0])
    dhs = [dh]
    for ci in range(nc - 1, 0, -1):
        dh = dh * carry[:, ci, :, None, None] + own[:, ci]
        dhs.append(dh)
    return torch.stack(dhs[::-1], dim=2)


def ssd_scan_bwd_chunk_ref(x, dt, a, b, c, h0s, dhs, dy, chunk: int = 128,
                           einsum=torch.einsum):
    """(dx [B, L, H, P], ddt [B, L, H], da [H], db, dc [B, L, G, N]), all
    f32, from each chunk's entering state h0s and leaving-state gradient
    dhs (see the module docstring for the formulas)."""
    xf, dtf, bf, cf, cum, decay = _chunk_operands(x, dt, a, b, c, chunk)
    bsz, nc, q, h, p = xf.shape
    g, n = b.shape[2], b.shape[3]
    dyf = _wide(dy).reshape(bsz, nc, q, h, p)
    h0 = _wide(h0s).transpose(1, 2)                             # [B, nc, H, P, N]
    dh = _wide(dhs).transpose(1, 2)
    dt_j = dtf.transpose(2, 3)[..., None, :]                     # [B, nc, H, 1, Q]

    s = einsum("bcihn,bcjhn->bchij", cf, bf)
    w = einsum("bcihp,bcjhp->bchij", dyf, xf) * decay
    ws = w * s
    ddt = ws.sum(-2).transpose(2, 3)                             # [B, nc, Q, H]
    t = ws * dt_j
    dcum = (t.sum(-1) - t.sum(-2)).transpose(2, 3)               # [B, nc, Q, H]
    dx = einsum("bchij,bcihp->bcjhp", s * decay * dt_j, dyf)
    wd = w * dt_j
    dc = einsum("bchij,bcjhn->bcihn", wd, bf)
    db = einsum("bchij,bcihn->bcjhn", wd, cf)

    # the entering state h0 and the leaving-state gradient dh
    tail = torch.exp(cum[:, :, -1:, :] - cum)                    # [B, nc, Q, H]
    dc_state = einsum("bchpn,bcihp->bcihn", h0, dyf) * torch.exp(cum)[..., None]
    dc = dc + dc_state
    dcum = dcum + (cf * dc_state).sum(-1)
    v = einsum("bchpn,bcjhp->bcjhn", dh, xf) * tail[..., None]
    db = db + v * dtf[..., None]
    ddt_state = (bf * v).sum(-1)
    ddt = ddt + ddt_state
    dx = dx + einsum("bchpn,bcjhn->bcjhp", dh, bf) * (tail * dtf)[..., None]
    u = dtf * ddt_state
    dcum = dcum - u
    last = torch.exp(cum[:, :, -1]) * (h0 * dh).sum((-2, -1)) + u.sum(2)
    dcum = torch.cat([dcum[:, :, :-1], dcum[:, :, -1:] + last[:, :, None]], dim=2)
    dda = dcum.flip(2).cumsum(2).flip(2)
    ddt = ddt + _wide(a) * dda
    da = (dtf * dda).sum((0, 1, 2))
    l = nc * q
    db = db.reshape(bsz, l, g, h // g, n).sum(3)
    dc = dc.reshape(bsz, l, g, h // g, n).sum(3)
    return dx.reshape(bsz, l, h, p), ddt.reshape(bsz, l, h), da, db, dc


def ssd_scan_bwd_ref(x, dt, a, b, c, h0s, dy, chunk: int = 128):
    """(dx, ddt, da, db, dc) of ``ssd_scan_fwd_ref``'s y for the output
    gradient ``dy``, from the saved entering states ``h0s``."""
    dhs = ssd_scan_bwd_state_ref(dt, a, c, dy, chunk)
    return ssd_scan_bwd_chunk_ref(x, dt, a, b, c, h0s, dhs, dy, chunk)
