"""Nested dicts and lists of leaves, walked in the JAX package's order.

The port's parameter and optimizer-state trees are plain dicts and lists
of tensors.  The JAX package flattens the same trees with
jax.tree_util: dict keys sorted, list items in order, None an empty node.
Keeping that order here makes leaf i of a tree the same array in both
packages, which the checkpoint format (utils/checkpoint.py) relies on.
"""

from __future__ import annotations


def tree_leaves(tree) -> list:
    """The leaves of `tree` in jax.tree_util.tree_flatten order."""
    out: list = []
    _collect(tree, out)
    return out


def _collect(x, out: list) -> None:
    # a module-level walk: a nested recursive closure would be a reference
    # cycle (function -> cell -> function) holding `out`, and with it every
    # leaf (a train step's gradients), until the cyclic collector ran
    if isinstance(x, dict):
        for key in sorted(x):
            _collect(x[key], out)
    elif isinstance(x, (list, tuple)):
        for item in x:
            _collect(item, out)
    elif x is not None:
        out.append(x)


def tree_map(fn, tree, *rest):
    """fn(leaf, *leaves of the other trees at the same place), rebuilt into
    `tree`'s structure.  The other trees must have the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_unflatten(like, leaves):
    """`like`'s structure filled with `leaves` in flatten order."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the structure holds")
    return out
