"""Nested-dict tree helpers: path flattening and parameter counting.

Counterpart of ``repro/util/tree.py`` for nested dicts of tensors. Paths are
'/'-joined keys, and leaves come out in sorted-key order (the order
``jax.tree_util`` flattens a dict in), so a flattened port tree lines up
one-to-one with the reference's ``flatten_with_paths``.
"""

from __future__ import annotations

from typing import Any, Dict


def flatten_with_paths(tree: Any) -> Dict[str, Any]:
    out: Dict[str, Any] = {}

    def walk(prefix: str, node: Any) -> None:
        if isinstance(node, dict):
            for k in sorted(node):
                walk(f"{prefix}/{k}" if prefix else str(k), node[k])
        elif node is not None:
            out[prefix] = node

    walk("", tree)
    return out


def unflatten_from_paths(flat: Dict[str, Any]) -> Dict[str, Any]:
    """Inverse of :func:`flatten_with_paths` for dict-of-dict trees."""
    out: Dict[str, Any] = {}
    for path, leaf in flat.items():
        parts = path.split("/")
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return out


def count_params(tree: Any) -> int:
    total = 0
    for x in flatten_with_paths(tree).values():
        n = 1
        for d in x.shape:
            n *= int(d)
        total += n
    return total
