"""Public op: the SSD scan (port of ``repro/kernels/ssd_scan/ops.py``).

``ssd`` with ``use_kernel=True`` runs :class:`SSDScan`, an autograd
function whose forward is the scan kernel (saving x, dt, a, b, c and
each chunk's entering state) and whose backward is the two backward
kernels; on CPU tensors the same wrappers run their plain versions, so
the forward is the reference's CPU route (``ssd_scan_ref`` when L <=
chunk, ``ssd_scan_chunked`` otherwise, reference :12-23) and the
backward ``ssd_scan_bwd_ref``.  ``use_kernel=False`` runs that route
under autograd, the only way to reach it on the card (counted in
``ssd.plain_launches`` there).  ``ssd_prefill`` (row 8p, serving's
prompt recurrence) is the wrapper itself, looked up here so that a
check can plant a fault in the model's call.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import cost as C
from repro_torch.kernels.ssd_scan.ref import (  # noqa: F401
    ssd_decode_step_ref, ssd_scan_chunked, ssd_scan_ref)
from repro_torch.kernels.ssd_scan.ssd_scan import (  # noqa: F401
    ssd_prefill, ssd_scan, ssd_scan_bwd)


class SSDScan(torch.autograd.Function):
    """The SSD scan with the hand-written backward: forward saves (x, dt,
    a, b, c, h0s); backward computes (dx, ddt, da, db, dc) from them."""

    @staticmethod
    def forward(ctx, x, dt, a, b, c, chunk):
        y, h0s = ssd_scan(x, dt, a, b, c, chunk=chunk, save_states=True)
        ctx.save_for_backward(x, dt, a, b, c, h0s)
        ctx.chunk = chunk
        return y

    @staticmethod
    def backward(ctx, dy):
        x, dt, a, b, c, h0s = ctx.saved_tensors
        grads = ssd_scan_bwd(x, dt, a, b, c, h0s, dy.contiguous(), chunk=ctx.chunk)
        return (*(g.to(t.dtype) for g, t in zip(grads, (x, dt, a, b, c))), None)


def ssd(x, dt, a, b, c, *, chunk: int = 128, use_kernel: bool = True):
    """x [B, L, H, P], dt [B, L, H], a [H], b / c [B, L, G, N] -> y
    [B, L, H, P], differentiable in all five."""
    if use_kernel:
        return SSDScan.apply(x.contiguous(), dt.contiguous(), a.contiguous(),
                             b.contiguous(), c.contiguous(), chunk)
    if x.is_cuda:
        ssd.plain_launches += 1
    if x.shape[1] <= chunk:
        return ssd_scan_ref(x, dt, a, b, c)
    return ssd_scan_chunked(x, dt, a, b, c, chunk=chunk)


ssd.plain_launches = 0


# --- what a call costs (``kernels/cost.py``) ------------------------------------

# kernels 8, 8b, 8c and 8p take each f32 chunk product as three split-bf16
# tensor-core passes
SPLIT_PASSES = 3


def _sizes(x, b, chunk):
    """Element counts of the f32 operands: x, dt, b (or c), the chunks'
    states; the chunk q, the chunk count and the causal pairs of a chunk."""
    bsz, l, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    q = min(chunk, l)
    nc = -(-l // q)
    return (bsz, h, p, n, q, nc, q * (q + 1) // 2,
            bsz * l * h * p, bsz * l * h, bsz * l * g * n, bsz * h * nc * p * n)


def _scan_cost(x, dt, a, b, c, *, chunk=128, save_states=False, fault=0):
    """Kernel 8: x, dt, a, b, c read, y and the states written; the causal
    half of the [Q, Q] chunk products plus the [Q, P, N] state products."""
    bsz, h, p, n, q, nc, pairs, xb, dtb, bcb, st = _sizes(x, b, chunk)
    flops = bsz * h * nc * (2 * pairs * (n + p) + 4 * q * p * n)
    return [("ssd_scan", {"bf16": SPLIT_PASSES * flops}, 4 * (2 * xb + dtb + h + 2 * bcb + st))]


def _scan_bwd_cost(x, dt, a, b, c, h0s, dy, *, chunk=128):
    """Kernel 8b (the states' gradients), then 8c (the five gradients)."""
    bsz, h, p, n, q, nc, pairs, xb, dtb, bcb, st = _sizes(x, b, chunk)
    return [("ssd_scan_bwd_state", {"bf16": SPLIT_PASSES * bsz * h * (nc - 1) * 2 * q * p * n},
             4 * (dtb + h + bcb + xb + st)),
            ("ssd_scan_bwd_chunk",
             {"bf16": SPLIT_PASSES * bsz * h * nc * (2 * pairs * (2 * p + 3 * n) + 6 * q * p * n)},
             4 * (3 * xb + 2 * dtb + 2 * h + 4 * bcb + 2 * st))]


def _prefill_cost(x, dt, a, b, c, h_init, *, mask=None, chunk=128, fault=0):
    """Kernel 8p (one call of three launches): x, dt, a, b, c and the
    entering state read, y and the leaving state written; kernel 8's
    products over the padded chunks."""
    bsz, h, p, n, q, nc, pairs, xb, dtb, bcb, _ = _sizes(x, b, chunk)
    flops = bsz * h * nc * (2 * pairs * (n + p) + 4 * q * p * n)
    return [("ssd_prefill", {"bf16": SPLIT_PASSES * flops},
             4 * (2 * xb + dtb + h + 2 * bcb + 2 * bsz * h * p * n))]


_COSTS = {"ssd_scan": _scan_cost, "ssd_scan_bwd": _scan_bwd_cost, "ssd_prefill": _prefill_cost}
COSTED = tuple(_COSTS)


def cost(name, *args, **kwargs):
    """The launches wrapper ``name`` (of ``COSTED``) makes on these
    arguments: [(kernel, {operand type: FLOPs}, bytes)]."""
    return _COSTS[name](*args, **kwargs)
