"""Nested containers as the JAX package's pytrees: the leaf order, the
leaf paths and their names, for the runtime's checkpoints and payload
checks.

A node is a dict (its keys sorted, as ``jax.tree`` sorts them), a list
or tuple, a NamedTuple or a dataclass (its fields in order, as the
reference's NamedTuple states); ``None`` holds no leaf; anything else
(a tensor, a numpy array, a number) is a leaf.  A path is a tuple of
(kind, key) pairs with kind "key", "idx" or "attr": ``name`` joins it
as the reference's checkpoint names its leaves ("0/layers/wq",
"1/.mu/embed"), ``keystr`` as ``jax.tree_util.keystr`` does
("['params']['embed']").
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(node) -> list[tuple[tuple[str, Any], Any]] | None:
    """((kind, key), child) of a node in leaf order; None for a leaf."""
    if isinstance(node, dict):
        return [(("key", k), node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return [(("attr", f), getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(("idx", i), v) for i, v in enumerate(node)]
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(("attr", f.name), getattr(node, f.name)) for f in dataclasses.fields(node)]
    return None


def leaves_with_path(tree: Any, prefix: tuple = ()) -> list[tuple[tuple, Any]]:
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for key, child in kids:
        out.extend(leaves_with_path(child, prefix + (key,)))
    return out


def leaves(tree: Any) -> list:
    return [leaf for _, leaf in leaves_with_path(tree)]


def name(path: tuple) -> str:
    """The reference checkpoint's leaf name: keys and indices as they
    are, attributes as ".field", joined by "/"."""
    return "/".join(f".{k}" if kind == "attr" else str(k) for kind, k in path)


def keystr(path: tuple) -> str:
    return "".join(f".{k}" if kind == "attr" else f"[{k!r}]" for kind, k in path)


def unflatten(tree: Any, new_leaves) -> Any:
    """``tree`` with its leaves replaced, in leaf order, by ``new_leaves``."""
    it = iter(new_leaves)

    def build(node):
        if node is None:
            return None
        kids = _children(node)
        if kids is None:
            return next(it)
        vals = {key: build(child) for key, child in kids}
        if isinstance(node, dict):
            return {k: vals[("key", k)] for k in node}
        if _is_namedtuple(node):
            return type(node)(*(vals[("attr", f)] for f in node._fields))
        if isinstance(node, (list, tuple)):
            return type(node)(vals[("idx", i)] for i in range(len(node)))
        return dataclasses.replace(node, **{k: v for (_, k), v in vals.items()})

    out = build(tree)
    if next(it, None) is not None:
        raise ValueError("unflatten: more leaves than the tree holds")
    return out


def tree_map(fn: Callable, tree: Any) -> Any:
    return unflatten(tree, [fn(leaf) for leaf in leaves(tree)])
