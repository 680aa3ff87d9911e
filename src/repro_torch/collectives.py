"""The port's collectives over a :class:`~repro_torch.launch.mesh.Mesh`:
``torch.distributed``'s own (NCCL on the card, gloo on the CPU), named
by mesh axes instead of groups.

Plain (no autograd): :func:`all_reduce` (sum, in place) and
:func:`all_gather` (blocks along a dim, in the entry's major-to-minor
order).  Through autograd, Megatron's pair for a region whose ranks hold
the same input and each compute a part of one output:

- :func:`copy_to` ("f"): identity forward; the backward sums the
  cotangent over the axes, since each rank's part saw the input;
- :func:`reduce_from` ("g"): the forward sums the parts; the backward
  passes the cotangent through unchanged, since it is the same on every
  rank of the axes (what comes after is replicated).  Summing it again
  would count it once per rank.

:func:`mean_over` averages a value each rank computed on its own rows
(the MoE auxiliary loss over the data axes); its backward averages the
cotangents, so that each rank's term keeps a weight of one in its own
gradient, which the step then averages over the same axes.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import axes_of

# all_gather_single supersedes all_gather_into_tensor in newer torch
_gather_single = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def all_reduce(t: torch.Tensor, mesh, entry) -> torch.Tensor:
    """Sum ``t`` over ``entry``'s axes, in place (through a contiguous copy
    where ``t`` is not contiguous, which NCCL refuses); returns ``t``."""
    if axes_of(entry):
        c = t if t.is_contiguous() else t.contiguous()
        dist.all_reduce(c, group=mesh.group(entry))
        if c is not t:
            t.copy_(c)
    return t


def all_gather(t: torch.Tensor, mesh, entry, dim: int) -> torch.Tensor:
    """Each rank's ``t`` along ``dim``, block ``i`` from the rank whose
    index along ``entry`` is ``i`` (``Mesh.index``); contiguous, as the
    single-device tensor is (a strided weight may take another matmul
    kernel)."""
    if not axes_of(entry):
        return t
    ranks = mesh.group_ranks(entry)
    n = len(ranks)
    src = t.movedim(dim, 0).contiguous()
    out = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]), dtype=src.dtype,
                      device=src.device)
    _gather_single(out, src, group=mesh.group(entry))
    blocks = out.chunk(n)                       # in group-rank order
    order = sorted(range(n), key=lambda j: mesh.index(entry, ranks[j]))
    if order != list(range(n)):
        out = torch.cat([blocks[j] for j in order])
    return out.movedim(0, dim).contiguous()


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, entry):
        ctx.mesh, ctx.entry = mesh, entry
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.mesh, ctx.entry), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, entry):
        ctx.mesh, ctx.entry = mesh, entry
        return all_reduce(x.contiguous().clone(), mesh, entry)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _MeanOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, entry):
        ctx.mesh, ctx.entry = mesh, entry
        n = mesh.axis_size(entry)
        return all_reduce(x.contiguous().clone(), mesh, entry) / n

    @staticmethod
    def backward(ctx, g):
        n = ctx.mesh.axis_size(ctx.entry)
        return all_reduce(g.contiguous().clone(), ctx.mesh, ctx.entry) / n, None, None


def copy_to(x, mesh, entry):
    """Megatron's "f": identity forward, the cotangent summed over ``entry``."""
    return _CopyTo.apply(x, mesh, entry)


def reduce_from(x, mesh, entry):
    """Megatron's "g": ``x`` summed over ``entry``, the cotangent passed
    through."""
    return _ReduceFrom.apply(x, mesh, entry)


def mean_over(x, mesh, entry):
    """The mean of ``x`` over ``entry``'s ranks; the cotangent's mean in the
    backward."""
    return _MeanOver.apply(x, mesh, entry)
