"""A small walker over nested dict/list/tuple parameter trees.

It visits leaves in the order ``jax.tree_util`` does: dict keys sorted,
lists and tuples in order. ``torch.utils._pytree`` and
``nn.Module.parameters()`` keep insertion order instead, which for
papernet would put ``stem`` before ``fc`` and change the packet stream
and the critical-packet mask of ``core.packets.make_plan``.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List


def _children(node: Any) -> Iterator[Any]:
    if isinstance(node, dict):
        for k in sorted(node):
            yield node[k]
    elif isinstance(node, (list, tuple)):
        yield from node


def _is_leaf(node: Any) -> bool:
    return not isinstance(node, (dict, list, tuple))


def tree_leaves(tree: Any) -> List[Any]:
    """Leaves of ``tree`` in sorted-key order."""
    if _is_leaf(tree):
        return [tree]
    out: List[Any] = []
    for child in _children(tree):
        out.extend(tree_leaves(child))
    return out


def tree_unflatten(template: Any, leaves: List[Any]) -> Any:
    """Rebuild ``template``'s structure with ``leaves`` in leaf order."""
    it = iter(leaves)

    def build(node: Any) -> Any:
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(build(c) for c in node)
        return next(it)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn`` over corresponding leaves of trees of one structure."""
    cols = [tree_leaves(t) for t in (tree, *rest)]
    if any(len(c) != len(cols[0]) for c in cols):
        raise ValueError("trees differ in their number of leaves")
    return tree_unflatten(tree, [fn(*xs) for xs in zip(*cols)])
