"""Nested containers of tensors walked in JAX's leaf order.

``jax.tree_util`` visits a dict's keys sorted, a list's or tuple's items
in order, and treats ``None`` as a node with no leaves. Wherever the
reference's result depends on that order — the gradient norm's python
``sum`` over leaves, a checkpoint's leaf paths — the port walks its
trees with these helpers, whatever order its dicts were built in.
"""
from __future__ import annotations

from typing import Any, Callable


def leaves_with_paths(tree, prefix: tuple = ()) -> "list[tuple[tuple, Any]]":
    """[(path, leaf)] in JAX's order; a path is a tuple of keys and
    indices."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in leaves_with_paths(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [item for i, v in enumerate(tree)
                for item in leaves_with_paths(v, prefix + (i,))]
    return [(prefix, tree)]


def leaves(tree) -> list:
    """The leaves in JAX's order."""
    return [leaf for _, leaf in leaves_with_paths(tree)]


def path_str(path: tuple) -> str:
    """``"params/blocks/pos0/ffn/w_gate"``, as the reference writes a
    checkpoint's leaf paths."""
    return "/".join(str(k) for k in path)


def map(fn: Callable, tree, *rest):  # noqa: A001 — tree_util's name
    """``fn`` over matching leaves of same-structured trees."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def unflatten_like(tree, new_leaves: list):
    """``tree``'s structure with its leaves (in JAX's order) replaced."""
    it = iter(new_leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)
    out = build(tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out
