"""numpy bridge between the reference's param tree and the port's model
state.

The reference's ``Model.init`` returns plain dicts whose layer stack sits
under ``"groups"``: a tuple with one dict per group position, every leaf
stacked ``[G, ...]`` over the layer groups (``models/transformer.py``).
Quantized trees carry the same records (int8 ``"q"``, f32 ``"scale"``,
and int8 ``"planes_packed"`` or legacy ``"planes"`` where the reference
encoded them, ``[, "bias"]``) with the ``[G]`` axis in front; every
leaf crosses bit for bit, in its own dtype.  The port
keeps one dict per layer under ``"layers"`` (layer ``g * len(group) + i``
is group ``g``'s position ``i``), so :func:`params_from_numpy` unstacks
the groups and moves every leaf onto ``device`` as a torch tensor.

Callers convert the reference tree to numpy first
(``jax.tree.map(np.asarray, params)``); this module imports no JAX.
:func:`params_to_numpy` goes back: it re-stacks ``"layers"`` into the
reference's ``"groups"`` layout, so that port trees (params, gradients,
optimizer moments) compare leaf by leaf with the reference's.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def _to_torch(node, device):
    if isinstance(node, dict):
        return {k: _to_torch(v, device) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_to_torch(v, device) for v in node)
    return torch.from_numpy(np.array(node)).to(device)   # np.array: a writable copy


def _index(node, g: int):
    if isinstance(node, dict):
        return {k: _index(v, g) for k, v in node.items()}
    return node[g]


def params_from_numpy(tree, device=None):
    """Reference param tree (numpy leaves, float or quantized) -> the
    port's state: ``{"embed", "final_norm"[, "lm_head"], "layers":
    [per-layer dict, ...]}`` with torch leaves on ``device``."""
    device = resolve_device(device)
    out = {k: _to_torch(v, device) for k, v in tree.items() if k != "groups"}
    groups = tree["groups"]
    num_groups = np.shape(next(_leaves(groups[0])))[0]
    layers = []
    for g in range(num_groups):
        for pos in groups:
            layers.append(_to_torch(_index(pos, g), device))
    out["layers"] = layers
    return out


def _leaves(node):
    if isinstance(node, dict):
        for v in node.values():
            yield from _leaves(v)
    else:
        yield node


def _to_numpy(node, like):
    if isinstance(node, dict):
        return {k: _to_numpy(v, like[k]) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_to_numpy(v, w) for v, w in zip(node, like))
    t = node.detach().cpu()
    if t.dtype == torch.bfloat16:   # numpy has no bfloat16: widen exactly
        t = t.to(torch.float32)
    return t.numpy().astype(np.asarray(like).dtype, copy=False)


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


def params_to_numpy(state, like):
    """The port's state (or a tree of its structure: gradients, moments)
    -> a numpy tree in the layout of the reference tree ``like``: layer
    ``g * len(groups) + i`` goes to ``like["groups"][i]`` at index ``g``,
    every leaf in ``like``'s leaf dtype."""
    groups = like["groups"]
    n = len(groups)
    out = {k: _to_numpy(v, like[k]) for k, v in state.items() if k != "layers"}
    layers = state["layers"]
    out["groups"] = type(groups)(
        _stack([_to_numpy(layer, _index(groups[i], g))
                for g, layer in enumerate(layers[i::n])])
        for i in range(n))
    return out
