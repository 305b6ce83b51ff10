"""Nested-container helpers that walk a parameter tree in the order
``jax.tree.flatten`` does: dict keys sorted, lists and tuples in order,
``None`` an empty subtree, anything else a leaf.

The flat update layout on the wire is this leaf order, so an update
flattened by the port folds into a JAX-side aggregate and back.
"""
from __future__ import annotations

from typing import Any, Callable, Iterable, Iterator, List, Tuple

#: treedef node kinds
_LEAF, _NONE, _DICT, _LIST, _TUPLE = "leaf", "none", "dict", "list", "tuple"


def tree_flatten(tree: Any) -> Tuple[List[Any], Any]:
    """-> (leaves in JAX order, treedef for :func:`tree_unflatten`)."""
    leaves: List[Any] = []

    def walk(node: Any) -> Any:
        if node is None:
            return (_NONE,)
        if isinstance(node, dict):
            keys = sorted(node)
            return (_DICT, tuple(keys), tuple(walk(node[k]) for k in keys))
        if isinstance(node, (list, tuple)):
            kind = _LIST if isinstance(node, list) else _TUPLE
            return (kind, tuple(walk(c) for c in node))
        leaves.append(node)
        return (_LEAF,)

    treedef = walk(tree)
    return leaves, treedef


def tree_unflatten(treedef: Any, leaves: List[Any]) -> Any:
    it = iter(leaves)

    def build(d: Any) -> Any:
        kind = d[0]
        if kind == _LEAF:
            return next(it)
        if kind == _NONE:
            return None
        if kind == _DICT:
            return {k: build(c) for k, c in zip(d[1], d[2])}
        children = [build(c) for c in d[1]]
        return children if kind == _LIST else tuple(children)

    out = build(treedef)
    if next(it, None) is not None:
        raise ValueError("more leaves than the treedef holds")
    return out


def tree_leaves(tree: Any) -> List[Any]:
    return tree_flatten(tree)[0]


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn`` over corresponding leaves of trees of one structure."""
    leaves, treedef = tree_flatten(tree)
    others = [tree_flatten(r) for r in rest]
    for _, d in others:
        if d != treedef:
            raise ValueError("tree_map over trees of different structure")
    return tree_unflatten(
        treedef, [fn(*xs) for xs in zip(leaves, *(o[0] for o in others))])


def named_leaves(tree: Any, prefix: str = "",
                 sep: str = ".") -> Iterator[Tuple[str, Any]]:
    """``(dotted path, leaf)`` in JAX order: ``stages.0.1.conv1`` — the
    parameter names of an ``nn.Module`` laid out like the tree.  With
    ``sep="/"`` the paths are the JAX package's checkpoint keys (its
    path keys joined with ``/``)."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from named_leaves(tree[k], f"{prefix}{k}{sep}", sep)
    elif isinstance(tree, (list, tuple)):
        for i, c in enumerate(tree):
            yield from named_leaves(c, f"{prefix}{i}{sep}", sep)
    else:
        yield prefix[:-1], tree


def tree_from_named(named: Iterable[Tuple[str, Any]]) -> Any:
    """Inverse of :func:`named_leaves`: nested dicts from dotted paths,
    with a level whose keys are all indices made a list."""
    root: dict = {}
    for name, leaf in named:
        *path, last = name.split(".")
        node = root
        for part in path:
            node = node.setdefault(part, {})
        node[last] = leaf

    def fix(node: Any) -> Any:
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [fix(node[k]) for k in sorted(node, key=int)]
        return {k: fix(v) for k, v in node.items()}

    return fix(root)
