"""Parameter trees: nested dicts, lists and tuples of tensors, as the JAX
package's pytrees. Leaves are visited in one fixed order (dict keys
sorted, as ``jax.tree_util`` sorts them), so the leaves of two trees of one
structure pair up."""

from __future__ import annotations

from typing import Any, Callable, List


def tree_leaves(tree: Any) -> List[Any]:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree: Any) -> Any:
    """``fn`` of each leaf, in a tree of ``tree``'s structure (leaves
    visited in ``tree_leaves``' order)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)
