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


def _walk(node, path: Path, out: List[Tuple[Path, Any]]) -> None:
    if isinstance(node, dict):
        for k in sorted(node):
            _walk(node[k], path + (str(k),), out)
    elif isinstance(node, (tuple, list)):
        for i, v in enumerate(node):
            _walk(v, path + (str(i),), out)
    else:
        out.append((path, node))


def flatten_with_path(tree) -> List[Tuple[Path, Any]]:
    """(path, leaf) pairs in flatten order. The recursions here are
    module-level functions: a nested recursive closure forms a reference
    cycle through its own cell, and the list it fills (every leaf of a
    dispatch's serving view, sliced per layer) then lives until the cyclic
    garbage collector happens to run."""
    out: List[Tuple[Path, Any]] = []
    _walk(tree, (), out)
    return out


def _build(node, it: Iterator):
    if isinstance(node, dict):
        return {k: _build(node[k], it) for k in sorted(node)}
    if isinstance(node, (tuple, list)):
        return type(node)(_build(v, it) for v in node)
    return next(it)


def unflatten(like, leaves) -> Any:
    """A tree shaped like ``like`` with ``leaves`` in flatten order."""
    it: Iterator = iter(leaves)
    out = _build(like, it)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out


def map_leaves(fn: Callable, tree) -> Any:
    return unflatten(tree, [fn(leaf) for _, leaf in flatten_with_path(tree)])


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten_with_path(tree)]
