"""Trees of tensors: the port's parameter, gradient and optimizer-state
trees are nested dicts and lists with tensors (or numpy arrays, or
scalars) at the leaves.

They are walked in the JAX package's order (dict keys sorted, lists in
order), and a leaf's path is written as ``jax.tree_util.keystr`` writes
it (``['layers'][0]['mix']['q']['w']``), so that a checkpoint's keys and
an optimizer's per-leaf cache read the same in both packages.
"""
from __future__ import annotations

from typing import Any, Callable

__all__ = ["leaves", "leaves_with_path", "map_tree", "unflatten"]


def leaves_with_path(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """``[(path, leaf), ...]`` in the JAX package's leaf order."""
    if isinstance(tree, dict):
        return [item for key in sorted(tree)
                for item in leaves_with_path(tree[key], f"{prefix}[{key!r}]")]
    if isinstance(tree, (list, tuple)):
        return [item for i, sub in enumerate(tree)
                for item in leaves_with_path(sub, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_path(tree)]


def unflatten(tree, new_leaves) -> Any:
    """``tree``'s structure with ``new_leaves`` (in :func:`leaves` order) at
    its leaves."""
    it = iter(new_leaves)

    def build(node):
        if isinstance(node, dict):
            built = {key: build(node[key]) for key in sorted(node)}
            return {key: built[key] for key in node}
        if isinstance(node, (list, tuple)):
            return type(node)(build(sub) for sub in node)
        return next(it)

    out = build(tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def map_tree(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` and of the trees ``rest`` of the
    same structure, leaf by leaf."""
    if isinstance(tree, dict):
        return {key: map_tree(fn, tree[key], *(r[key] for r in rest)) for key in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, sub, *(r[i] for r in rest))
                          for i, sub in enumerate(tree))
    return fn(tree, *rest)
