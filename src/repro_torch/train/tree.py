"""Nested dicts/lists/tuples of tensors (the port's parameter trees): flatten
to a list of leaves and rebuild, and map a function over matching trees."""
from __future__ import annotations


def leaves(tree) -> list:
    """The leaves of ``tree`` in a fixed order (dict keys as stored)."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def unflatten(like, flat: list):
    """A tree shaped like ``like`` holding ``flat``'s leaves in order."""
    return _build(like, iter(flat))


def _build(t, it):
    # a module-level function, not a closure over itself: a recursive
    # closure is a reference cycle, and its iterator would keep every leaf
    # (whole embedding tables) alive until the cyclic garbage collector ran
    if isinstance(t, dict):
        return {k: _build(v, it) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return type(t)(_build(v, it) for v in t)
    return next(it)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of the same-shaped ``rest``."""
    others = [leaves(r) for r in rest]
    return unflatten(tree, [fn(x, *(o[i] for o in others))
                            for i, x in enumerate(leaves(tree))])
