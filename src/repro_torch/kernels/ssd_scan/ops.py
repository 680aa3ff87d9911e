"""Public op: the SSD scan (port of ``repro/kernels/ssd_scan/ops.py``).

``ssd`` with ``use_kernel=True`` runs :class:`SSDScan`, an autograd
function whose forward is the scan kernel (saving x, dt, a, b, c and
each chunk's entering state) and whose backward is the two backward
kernels; on CPU tensors the same wrappers run their plain versions, so
the forward is the reference's CPU route (``ssd_scan_ref`` when L <=
chunk, ``ssd_scan_chunked`` otherwise, reference :12-23) and the
backward ``ssd_scan_bwd_ref``.  ``use_kernel=False`` runs that route
under autograd, the only way to reach it on the card (counted in
``ssd.plain_launches`` there).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.ssd_scan.ref import (  # noqa: F401
    ssd_decode_step_ref, ssd_scan_chunked, ssd_scan_ref)
from repro_torch.kernels.ssd_scan.ssd_scan import ssd_scan, ssd_scan_bwd


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
