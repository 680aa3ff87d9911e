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

Every call over a non-empty entry adds its result's bytes on this rank
(the gathered tensor; the reduced one) to :data:`moved`, keyed by
(kind, group size), as a kernel wrapper counts its ``.launches``;
:func:`reset_counts` sets it to zero.  While :data:`log` is a list,
each call also appends ``(kind, result bytes, the group's global
ranks)``: the planner's collective records (``core/roofline.py``).
On an :class:`~repro_torch.launch.mesh.AbstractMesh` (no world) the
calls move nothing and only log (not in :data:`moved`): they take
``meta`` tensors alone, the all-reduce returns its input and the
all-gather an empty tensor of the gathered shape.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import Mesh, axes_of

# all_gather_single supersedes all_gather_into_tensor in newer torch
_gather_single = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor

moved: dict = {}   # (kind, group size) -> result bytes on this rank
log = None         # a list: every call's (kind, result bytes, group ranks)


def reset_counts() -> None:
    moved.clear()


def _count(kind: str, t: torch.Tensor, mesh, entry) -> bool:
    """Log one call, and count it when it moves data (a real world's)."""
    nbytes = t.numel() * t.element_size()
    if log is not None:
        log.append((kind, nbytes, tuple(mesh.group_ranks(entry))))
    if not isinstance(mesh, Mesh):
        if t.device.type != "meta":
            raise ValueError(f"{mesh} has no ranks: its collectives trace meta tensors only")
        return False
    key = (kind, mesh.axis_size(entry))
    moved[key] = moved.get(key, 0) + nbytes
    return True


def all_reduce(t: torch.Tensor, mesh, entry) -> torch.Tensor:
    """Sum ``t`` over ``entry``'s axes, in place (through a contiguous copy
    where ``t`` is not contiguous, which NCCL refuses); returns ``t``."""
    if axes_of(entry) and _count("all-reduce", t, mesh, entry):
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
    if not _count("all-gather", out, mesh, entry):
        return out.movedim(0, dim).contiguous()
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
