"""Nested-dict trees in the reference's leaf order.

The port's parameter, gradient, optimizer and checkpoint trees are nested
dicts of tensors with the reference's keys (``layers/attn/wq``).  These
helpers visit them as ``jax.tree_util`` does: dict keys in sorted order,
list and tuple items by index, ``None`` an empty subtree.  That order fixes
a checkpoint's segment order and the order in which the optimizer sums the
gradient norm, so both match the reference's.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, List, Mapping, Optional, Tuple

__all__ = ["keystr", "tree_flatten_with_path", "tree_leaves", "tree_map",
           "tree_unflatten_like"]


def _children(node) -> Optional[List[Tuple[Any, Any]]]:
    if isinstance(node, Mapping):
        return [(k, node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    return None


def tree_flatten_with_path(tree, prefix: Tuple = ()
                           ) -> List[Tuple[Tuple, Any]]:
    """(path, leaf) pairs, dict keys sorted, list items by index."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for k, v in kids:
        out += tree_flatten_with_path(v, prefix + (k,))
    return out


def tree_leaves(tree) -> List[Any]:
    return [leaf for _, leaf in tree_flatten_with_path(tree)]


def tree_map(fn: Callable, tree):
    """``fn`` on every leaf; dicts, lists and tuples rebuilt."""
    if tree is None:
        return None
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_unflatten_like(like, leaves) -> Any:
    """``like``'s structure with its leaves, in flatten order, replaced by
    ``leaves``."""
    return _build(like, iter(leaves))


def _build(node, it: Iterator) -> Any:
    # a module-level function, not a closure that calls itself: such a
    # closure is a reference cycle, which would keep ``leaves`` (a step's
    # gradients) alive until the cyclic garbage collector runs
    if node is None:
        return None
    if isinstance(node, Mapping):
        built = {k: _build(node[k], it) for k in sorted(node)}
        return {k: built[k] for k in node}      # like's own key order
    if isinstance(node, (list, tuple)):
        return type(node)(_build(v, it) for v in node)
    return next(it)


def keystr(path: Tuple) -> str:
    """``jax.tree_util.keystr`` of a path of dict keys and list indices:
    ``"['layers']['attn']['wq']"``."""
    return "".join(f"[{k!r}]" for k in path)
