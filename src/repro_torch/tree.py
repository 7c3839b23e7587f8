"""Trees of tensors as the port keeps them: nested dicts and lists (the
parameters, their gradients and the optimizer's moments), walked in the
order of their keys and items."""
from __future__ import annotations

from typing import Any, Callable, List


def tree_map(fn: Callable[..., Any], tree, *rest):
    """A tree shaped like ``tree`` of ``fn`` over the leaves of ``tree``
    and of each tree in ``rest`` (all of one structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree) -> List[Any]:
    """The leaves of ``tree``, in the order ``tree_map`` visits them."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]
