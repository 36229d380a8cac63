"""A small walker over nested dict/list/tuple parameter trees.

It visits leaves in the order ``jax.tree_util`` does: dict keys sorted,
lists and tuples in order. ``torch.utils._pytree`` and
``nn.Module.parameters()`` keep insertion order instead, which for
papernet would put ``stem`` before ``fc`` and change the packet stream
and the critical-packet mask of ``core.packets.make_plan``.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple


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


def tree_leaves_with_path(tree: Any) -> List[Tuple[Tuple[Any, ...], Any]]:
    """``(path, leaf)`` pairs in sorted-key order, as
    ``jax.tree_util.tree_flatten_with_path`` gives them: a path holds
    the dict keys and the list/tuple positions down to the leaf. ``None``
    is an empty subtree, as in JAX, and yields nothing."""
    out: List[Tuple[Tuple[Any, ...], Any]] = []

    def walk(node: Any, path: Tuple[Any, ...]) -> None:
        if node is None:
            return
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (k,))
        elif isinstance(node, (list, tuple)):
            for i, c in enumerate(node):
                walk(c, path + (i,))
        else:
            out.append((path, node))

    walk(tree, ())
    return out


def tree_map_with_path(fn: Callable[[Tuple[Any, ...], Any], Any],
                       tree: Any) -> Any:
    """``tree``'s structure with each leaf replaced by ``fn(path, leaf)``
    (paths as ``tree_leaves_with_path`` gives them; ``None`` stays)."""
    def build(node: Any, path: Tuple[Any, ...]) -> Any:
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: build(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(build(c, path + (i,))
                              for i, c in enumerate(node))
        return fn(path, node)

    return build(tree, ())
