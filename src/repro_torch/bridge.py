"""numpy bridge from the reference's param tree to the port's model state.

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
