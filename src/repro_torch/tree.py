"""Param trees: nested dicts, lists and tuples of tensors (the port's
counterpart of JAX's pytrees for the model state)."""

from __future__ import annotations


def leaves(tree) -> list:
    """Leaves in a fixed order: dict keys as stored, sequences in order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def map_tree(fn, tree, *rest):
    """``fn`` applied leaf by leaf over ``tree`` and trees of its structure."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def unflatten(like, flat):
    """A tree of ``like``'s structure holding ``flat`` (in :func:`leaves`
    order)."""
    it = iter(flat)
    out = map_tree(lambda _: next(it), like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out
