"""Nested dicts of tensors (the port's param trees), walked in JAX's
flatten order: dict keys sorted, depth first. Checkpoint leaves and the
optimizer's per-tensor loop follow this order."""
from __future__ import annotations

from typing import Callable, List


def leaves(tree) -> List:
    """The leaves of a nested dict, keys sorted at every level."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    return [tree]


def unflatten(like, flat: List):
    """A nested dict shaped like ``like`` holding ``flat`` (in
    :func:`leaves` order)."""
    it = iter(flat)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def map_tree(fn: Callable, tree):
    return unflatten(tree, [fn(x) for x in leaves(tree)])


def treedef_repr(tree) -> str:
    """The structure as ``repr(jax.tree_util.tree_structure(tree))``
    prints it for a nested dict, e.g. ``PyTreeDef({'a': *, 'b': {'c':
    *}})`` (what a checkpoint records beside its leaves)."""
    def node(t):
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {node(t[k])}"
                                   for k in sorted(t)) + "}"
        return "*"
    return f"PyTreeDef({node(tree)})"
