"""Gradient accumulation and int8 compression (port of
``repro/optim/grad.py``).

``accumulate`` runs the backward once per microbatch.  float32 grads of
float32 params accumulate in the leaves' ``.grad`` (autograd's in-place
accumulation: no second copy of the grads); otherwise each microbatch's
gradient is cast to the accumulation dtype (``grad_dtype``, else
float32) and summed in it, as the reference does.

``compress_int8`` is the reference's error-feedback int8 compression of
the cross-pod gradient (absmax scale per leaf of the reference's tree,
residual fed back); on one card it only changes the numbers, as the
reference's does on a single device.
"""

from __future__ import annotations

import torch

from repro_torch.tree import leaves, map_tree, unflatten


def accumulate(loss_of, params, microbatches, grad_dtype=None):
    """(mean loss, mean grads) over ``microbatches``: ``loss_of(params,
    mb)`` returns a scalar loss; the float leaves of ``params`` become
    leaves with ``requires_grad``.  Grads come back in a tree of the
    params' structure, float32 unless ``grad_dtype`` is given."""
    flat = leaves(params)
    acc_dt = grad_dtype or torch.float32
    direct = all(p.dtype == acc_dt for p in flat)
    for p in flat:
        p.requires_grad_(True)
        p.grad = None
    acc = None
    total, n = None, 0
    for mb in microbatches:
        loss = loss_of(params, mb)
        loss.backward()
        total = loss.detach().float() if total is None else total + loss.detach().float()
        n += 1
        if not direct:
            gs = [p.grad.to(acc_dt) if p.grad is not None   # a leaf the loss never read
                  else torch.zeros(p.shape, dtype=acc_dt, device=p.device) for p in flat]
            acc = gs if acc is None else [a.add_(g) for a, g in zip(acc, gs)]
            for p in flat:
                p.grad = None
    if direct:
        acc = [p.grad if p.grad is not None else torch.zeros_like(p) for p in flat]
        for p in flat:
            p.grad = None
    inv = 1.0 / max(n, 1)
    for g in acc:
        g.mul_(inv)
    return total * inv, unflatten(params, acc)


def ef_init(params):
    return map_tree(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _scale_sets(tree, group_size: int):
    """Lists of ``tree``'s leaves that share one scale.  A reference leaf
    under ``"groups"`` stacks the same leaf of every layer group, so a
    layer leaf shares its scale with that leaf of the layers at the same
    group position (``group_size`` layers per group); every other leaf
    has its own."""
    sets = [[x] for k, v in tree.items() if k != "layers" for x in leaves(v)]
    layers = tree.get("layers", [])
    for i in range(group_size):
        sets.extend(list(col) for col in zip(*(leaves(l) for l in layers[i::group_size])))
    return sets


@torch.no_grad()
def compress_int8(grads, ef_state, group_size: int = 1):
    """(quantized-dequantized grads, new error-feedback state) of a grads
    tree of the model state's structure: absmax scale per leaf of the
    reference's tree (see :func:`_scale_sets`)."""
    gl, el = leaves(grads), leaves(ef_state)
    deq, res = [None] * len(gl), [None] * len(gl)
    for idx in _scale_sets(unflatten(grads, range(len(gl))), group_size):
        gs = {i: gl[i].to(torch.float32) + el[i] for i in idx}
        amax = torch.stack([g.abs().max() for g in gs.values()]).max()
        scale = torch.clamp_min(amax, 1e-12) / 127.0
        for i, g in gs.items():
            q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
            deq[i] = q.to(torch.float32) * scale
            res[i] = g - deq[i]
    return unflatten(grads, deq), unflatten(grads, res)
