"""Path-keyed flatten / unflatten of nested dict/tuple parameter trees.

Stands in for ``jax.tree_util.tree_flatten_with_path`` in the port: dict keys
are visited in sorted order and sequences by index, so the ``"/"``-joined
paths and their order equal the reference's (``embed/w``, ``head/w``,
``blocks/0/attn/wq``, ...). The sealing nonces are hashes of those paths,
so this order and spelling are part of the ciphertext.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple

Path = Tuple[str, ...]


def _is_node(x) -> bool:
    return isinstance(x, (dict, tuple, list))


def flatten_with_path(tree) -> List[Tuple[Path, Any]]:
    out: List[Tuple[Path, Any]] = []

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (str(k),))
        elif isinstance(node, (tuple, list)):
            for i, v in enumerate(node):
                walk(v, path + (str(i),))
        else:
            out.append((path, node))

    walk(tree, ())
    return out


def unflatten(like, leaves) -> Any:
    """A tree shaped like ``like`` with ``leaves`` in flatten order."""
    it: Iterator = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (tuple, list)):
            return type(node)(build(v) for v in node)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out


def map_leaves(fn: Callable, tree) -> Any:
    return unflatten(tree, [fn(leaf) for _, leaf in flatten_with_path(tree)])


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten_with_path(tree)]
