"""Nested containers of tensors in the reference's leaf order.

The reference flattens its pytrees with ``jax.tree_util``: a dict's
values by sorted key, a tuple's (and a NamedTuple's) and a list's in
their order, ``None`` as no leaf, anything else as one leaf. The optimizer
pairs the leaves of params, grads and moments in that order, the global
gradient norm sums them in it, and a checkpoint numbers its arrays by it,
so a checkpoint written by either package restores in the other.
"""

from __future__ import annotations

from typing import Any, Callable, List


def leaves(tree: Any) -> List[Any]:
    """Every leaf of ``tree`` in the reference's order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in leaves(v)]
    if tree is None:
        return []
    return [tree]


def unflatten(like: Any, flat: List[Any]) -> Any:
    """A tree of ``like``'s structure holding ``flat`` as its leaves."""
    it = iter(flat)

    def build(t):
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*[build(v) for v in t])
        if isinstance(t, (tuple, list)):
            return type(t)(build(v) for v in t)
        if t is None:
            return None
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has places")
    return out


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of each
    tree of ``rest`` (same structure)."""
    flat = leaves(tree)
    others = [leaves(r) for r in rest]
    if any(len(o) != len(flat) for o in others):
        raise ValueError("trees of different structure")
    return unflatten(tree, [fn(*xs) for xs in zip(flat, *others)])


def structure(tree: Any) -> str:
    """The tree's shape with '*' for each leaf, for a checkpoint's
    manifest."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {structure(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree).__name__ + "(" + ", ".join(
            f"{f}={structure(v)}" for f, v in zip(tree._fields, tree)) + ")"
    if isinstance(tree, (tuple, list)):
        inner = ", ".join(structure(v) for v in tree)
        return f"({inner})" if isinstance(tree, tuple) else f"[{inner}]"
    return "None" if tree is None else "*"
