"""Pipeline parallelism: the GPipe schedule over a "stage" mesh axis (port
of ``repro/runtime/pipeline.py``).

Layer groups are partitioned into S stages, one a rank along the mesh
axis ``axis``; microbatches stream through with point-to-point transfers
between neighbouring stages.

Schedule: classic GPipe fill-drain.  T = M + S - 1 ticks; at tick t,
stage s computes microbatch (t - s) if 0 <= t - s < M, having received
it from stage s - 1 at the end of tick t - 1.  Bubble fraction =
(S-1)/(M+S-1), reported by :func:`bubble_fraction` so configs can size M.

As in the reference this is the feature-completeness path (the
production meshes use FSDP x TP x EP); the port runs it forward only:
its sends and receives are ``torch.distributed``'s, outside autograd.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch import collectives
from repro_torch.tree import map_tree


def bubble_fraction(num_micro: int, num_stages: int) -> float:
    return (num_stages - 1) / (num_micro + num_stages - 1)


def pipeline_apply(stage_fn, stage_params, x, *, mesh, num_micro: int,
                   axis: str = "stage"):
    """Run ``x`` through the S pipeline stages of ``stage_fn``.

    stage_fn(params, x_mb) -> y_mb         (one stage, one microbatch, same shape)
    stage_params: this rank's stage, every leaf [1, ...] (the leading [S]
        axis already split over ``axis``, ``sharding.local_shard`` with
        spec (axis, ...))
    x: [B, ...] the global batch, the same on every rank; split into
        ``num_micro`` microbatches
    Returns y: [B, ...] after all S stages, on every rank (the last
    stage's outputs reach the others by a sum of the buffers in which only
    the last stage's is not zero, as the reference's masked psum).
    """
    s_count = mesh.shape[axis]
    b = x.shape[0]
    if b % num_micro:
        raise ValueError(f"batch {b} does not split into {num_micro} microbatches")
    xm = x.reshape((num_micro, b // num_micro) + tuple(x.shape[1:]))
    params = map_tree(lambda a: a[0], stage_params)
    s = mesh.coords[axis]
    ranks = {c: mesh.rank_of({**mesh.coords, axis: c}) for c in range(s_count)}
    out_buf = torch.zeros_like(xm)
    inbox = torch.empty_like(xm[0])
    with torch.no_grad():
        for t in range(num_micro + s_count - 1):
            mb = t - s
            if not 0 <= mb < num_micro:
                continue
            if s == 0:
                x_in = xm[mb]
            else:
                dist.recv(inbox, src=ranks[s - 1])
                x_in = inbox
            y = stage_fn(params, x_in)
            if s == s_count - 1:
                out_buf[mb] = y
            else:
                dist.send(y.contiguous(), dst=ranks[s + 1])
        collectives.all_reduce(out_buf, mesh, axis)
    return out_buf.reshape((b,) + tuple(x.shape[1:]))
