"""AdamW (bias-corrected, decoupled weight decay), port of
``repro/optim/adamw.py``.

Moments are float32 whatever the param dtype, in trees of the params'
structure.  Unlike the reference's pure function, :func:`update` works
in place under ``torch.no_grad``: it writes the new params and moments
into the tensors it is given (and clips the grads in place), so a
full-width step holds no second copy of the weights or the state.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.configs.base import OptimConfig
from repro_torch.optim.schedule import lr_at
from repro_torch.tree import leaves, map_tree


def init(params):
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
    return {"m": map_tree(zeros, params), "v": map_tree(zeros, params), "step": 0}


def global_norm(tree) -> torch.Tensor:
    sums = [g.to(torch.float32).square().sum() for g in leaves(tree)]
    return torch.sqrt(torch.stack(sums).sum())


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float, norm=None):
    """Scales ``grads`` in place to a global norm of at most ``max_norm``;
    returns (grads, the norm before clipping).  ``norm``: the norm to clip
    by, when ``grads`` are a rank's shards of a larger gradient."""
    if norm is None:
        norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp_min(norm, 1e-12), max=1.0)
    for g in leaves(grads):
        g.mul_(scale)
    return grads, norm


@torch.no_grad()
def update(cfg: OptimConfig, grads, state, params, norm=None):
    """One AdamW step, in place: ``params``, ``state["m"]`` and
    ``state["v"]`` are overwritten (and float32 ``grads`` clipped in
    place).  ``norm``: the global norm of the whole gradient, when
    ``grads``, ``state`` and ``params`` are a rank's shards (the norm of
    the shards alone differs on every rank).  Returns (params, new state,
    {"grad_norm", "lr"})."""
    p_leaves = leaves(params)
    with tracing.span("train.adamw", leaves=len(p_leaves)):
        grads = map_tree(lambda g: g.to(torch.float32), grads)
        if cfg.grad_clip > 0:
            grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip, norm)
        else:
            gnorm = global_norm(grads) if norm is None else norm
        step = state["step"] + 1
        lr = lr_at(cfg, step)
        f = np.float32
        b1, b2 = cfg.beta1, cfg.beta2
        bc1 = float(f(1.0) - f(b1) ** f(step))
        bc2 = float(f(1.0) - f(b2) ** f(step))
        for p, g, m, v in zip(p_leaves, leaves(grads), leaves(state["m"]),
                              leaves(state["v"])):
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            delta = (m / bc1).div_((v / bc2).sqrt_().add_(cfg.eps))
            delta.add_(p, alpha=cfg.weight_decay).mul_(lr)
            if p.dtype == torch.float32:
                p.sub_(delta)
            else:
                p.copy_(p.to(torch.float32) - delta)
        new_state = {"m": state["m"], "v": state["v"], "step": step}
        return params, new_state, {"grad_norm": gnorm, "lr": lr}
