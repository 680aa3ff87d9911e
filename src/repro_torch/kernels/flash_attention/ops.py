"""Public ops: training attention and serving (masked) attention (port
of ``repro/kernels/flash_attention/ops.py``).

``attention`` (reference :19) is the full-sequence op of the training
forward.  With ``use_kernel=True`` it runs :class:`FlashAttention`, an
autograd function whose forward is the flash kernel (saving q, k, v, the
output and the row log-sum-exp) and whose backward is the two backward
kernels; on CPU tensors the same wrappers run their plain versions.
``use_kernel=False`` runs the reference's plain route under autograd
(``attention_ref``, or ``attention_blockwise`` at ``Skv >=
BLOCKWISE_THRESHOLD``), the only way to reach it on the card (counted in
``attention.plain_launches`` there).

``masked_attention`` (reference :44) sends every call to the masked
flash kernel, whose wrapper takes the plain version only for CPU
tensors; unlike the reference there is no "tiles don't divide ->
oracle" route, because the kernel masks ragged tiles itself.  int8-KV dequant scales
(``k_scale``/``v_scale``) on the card take the reference's kernel route:
K and V are dequantized to q's dtype before the kernel (``ops.py:75-78``,
:func:`dequantize`).  On CPU tensors a scaled call takes the plain
version, which folds the scales exactly, as the reference's CPU route
does (every other device takes the card's route: ``meta``, the
planner's).  ``q_offsets`` (int32 [B]) gives each sequence its own query
offset (the kernel's per-sequence form): the dense decode read and the
speculative verify burst, whose masks ``start_b <= j <= pos_b + t`` it
computes from ``(start, q_offsets)``.  The explicit ``valid`` mask (the
plain path's decode reads, the ring's among them) has no kernel: it runs
the plain version on the CPU and raises on the card unless
``use_kernel=False``, which asks for the plain version explicitly
(counted in ``masked_attention.plain_launches`` on the card).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import cost as C
from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention, flash_attention_bwd, flash_attention_masked)
from repro_torch.kernels.flash_attention.ref import (
    attention_blockwise, attention_ref, masked_attention_ref)

# at or above this many kv columns the plain route is the O(chunk)-memory
# blockwise version, as the reference's CPU route (reference :16)
BLOCKWISE_THRESHOLD = 2048


class FlashAttention(torch.autograd.Function):
    """Flash attention with the hand-written backward: forward saves
    (q, k, v, out, lse); backward computes (dq, dk, dv) from them."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        out, lse = flash_attention(q, k, v, causal=causal, window=window,
                                   scale=scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = (causal, window, scale)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, scale = ctx.mask
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do.contiguous(),
                                         causal=causal, window=window,
                                         scale=scale)
        return dq, dk, dv, None, None, None


def attention(q, k, v, *, causal=True, window=None, scale=None,
              use_kernel: bool = True):
    """q [B, Hq, Sq, D], k/v [B, Hkv, Skv, D] -> [B, Hq, Sq, D] in q's
    dtype, differentiable in q, k and v; query row t sits at kv position
    ``Skv - Sq + t``."""
    if use_kernel:
        return FlashAttention.apply(q.contiguous(), k.contiguous(),
                                    v.contiguous(), causal, window, scale)
    if q.is_cuda:
        attention.plain_launches += 1
    if k.shape[2] >= BLOCKWISE_THRESHOLD:
        return attention_blockwise(q, k, v, causal=causal, window=window,
                                   scale=scale)
    return attention_ref(q, k, v, causal=causal, window=window, scale=scale)


attention.plain_launches = 0


def dequantize(t, t_scale, dtype):
    """[B, Hkv, S, D] codes x [B, Hkv, S] scale -> ``dtype`` operand,
    multiplied in ``dtype`` as the reference's kernel route does."""
    return t.to(dtype) * t_scale[..., None].to(dtype)


def masked_attention(q, k, v, *, start=None, q_offset=0, causal=True,
                     window=None, scale=None, k_scale=None, v_scale=None,
                     valid=None, use_kernel: bool = True, chunk=None, q_offsets=None):
    """q [B, Hq, Sq, D], k/v [B, Hkv, Skv, D] -> [B, Hq, Sq, D]: in q's
    dtype from the kernel (as the Pallas kernel writes it), float32 from
    the plain version.  The reference op upcasts the kernel's output to
    float32; here the caller's cast to the compute dtype (``_finish``)
    makes both the same, so the kernel's output stays in q's dtype."""
    for name, s, t in (("k_scale", k_scale, k), ("v_scale", v_scale, v)):
        if s is not None and tuple(s.shape) != tuple(t.shape[:3]):
            raise ValueError(f"{name} {tuple(s.shape)} must be [B, Hkv, Skv] = "
                             f"{tuple(t.shape[:3])}")
    scaled = k_scale is not None or v_scale is not None
    if valid is None and use_kernel and (q.device.type != "cpu" or not scaled):
        if k_scale is not None:   # the kernel takes dequantized operands
            k = dequantize(k, k_scale, q.dtype)
        if v_scale is not None:
            v = dequantize(v, v_scale, q.dtype)
        if start is None:
            start = torch.zeros((q.shape[0],), dtype=torch.int32, device=q.device)
        return flash_attention_masked(
            q.contiguous(), k.contiguous(), v.contiguous(),
            start.to(torch.int32).contiguous(), q_offset=q_offset,
            q_offsets=None if q_offsets is None else q_offsets.to(torch.int32).contiguous(),
            causal=causal, window=window, scale=scale)
    if q.is_cuda:
        if valid is not None and use_kernel:
            raise NotImplementedError(
                "the explicit-mask attention has no kernel: the card reads "
                "dense rows and verify bursts through (start, q_offsets)")
        masked_attention.plain_launches += 1
    return masked_attention_ref(q, k, v, start=start, q_offset=q_offset,
                                causal=causal, window=window, scale=scale,
                                k_scale=k_scale, v_scale=v_scale, valid=valid,
                                chunk=chunk, q_offsets=q_offsets)


masked_attention.plain_launches = 0


# --- what a call costs (``kernels/cost.py``) ------------------------------------

def _band(q, k, causal, window, q_offset):
    b, _, sq, _ = q.shape
    skv = k.shape[2]
    off = skv - sq if q_offset is None else int(q_offset)
    return b * C.band_pairs(sq, skv, off, causal, window)


def _attention_cost(q, k, v, *, causal=True, window=None, scale=None, q_offset=None):
    """Kernel 7: q, k, v read, the output and the f32 lse written."""
    b, hq, sq, d = q.shape
    pairs = _band(q, k, causal, window, q_offset)
    return [("flash_attention", {C.op_type(q.dtype): 4 * pairs * hq * d},
             C.nbytes(q, k, v, q) + 4 * b * hq * sq)]


def _attention_bwd_cost(q, k, v, o, lse, do, *, causal=True, window=None, scale=None,
                        q_offset=None):
    """Kernel 7c (q, O, dO, K, V and lse read; dQ and D_i written), then 7b
    (q, dO, K, V, lse and D_i read; dK and dV written)."""
    hq, d = q.shape[1], q.shape[3]
    pairs = _band(q, k, causal, window, q_offset)
    io, kv, lb = C.nbytes(q), C.nbytes(k), C.nbytes(lse)
    t = C.op_type(q.dtype)
    return [("flash_attention_bwd_dq", {t: 6 * pairs * hq * d}, 3 * io + 2 * kv + lb + io + lb),
            ("flash_attention_bwd_dkdv", {t: 8 * pairs * hq * d},
             2 * io + 2 * kv + 2 * lb + 2 * kv)]


def _masked_cost(q, k, v, start, *, q_offset=0, q_offsets=None, causal=True, window=None,
                 scale=None):
    """Kernel 2: q, start (and the offsets) read, the K / V columns some
    query row of a sequence attends read once, the output (q's dtype)
    written; the products of the pairs the mask keeps.  On ``meta`` every
    sequence starts at 0 and, with per-sequence offsets, sits at the
    cache's last row."""
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    if C.known(start, q_offsets):
        t = torch.arange(sq, device=q.device)[None, :]
        qp = (t + q_offsets.long()[:, None] if q_offsets is not None else t + int(q_offset))
        qp = qp[..., None]
        col = torch.arange(skv, device=q.device)[None, None, :]
        mask = (col >= start.long()[:, None, None]).expand(b, sq, skv)
        if causal:
            mask = mask & (col <= qp)
        if window:
            mask = mask & (col > qp - window)
        pairs, live = int(mask.sum()), int(mask.any(1).sum())
    else:
        off = skv - sq if q_offsets is not None else int(q_offset)
        pairs = b * C.band_pairs(sq, skv, off, causal, window)
        live = b * C.band_columns(sq, skv, off, causal, window)
    return [("flash_attention_masked", {C.op_type(q.dtype): 4 * pairs * hq * d},
             2 * C.nbytes(q) + 2 * live * hkv * d * k.element_size()
             + C.nbytes(start, q_offsets))]


_COSTS = {"flash_attention": _attention_cost, "flash_attention_bwd": _attention_bwd_cost,
          "flash_attention_masked": _masked_cost}
COSTED = tuple(_COSTS)


def cost(name, *args, **kwargs):
    """The launches wrapper ``name`` (of ``COSTED``) makes on these
    arguments: [(kernel, {operand type: FLOPs}, bytes)]."""
    return _COSTS[name](*args, **kwargs)
