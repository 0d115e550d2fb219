"""Nested-dict trees in the JAX package's leaf order.

No single JAX counterpart: ``jax.tree.leaves`` and ``ravel_pytree``
visit a dict's keys sorted as strings, so a ``Sequential``'s children
``"0".."15"`` come as ``0, 1, 10, 11, ..., 15, 2, ...`` and a layer's
``bias`` before its ``weight``.  Three things the port shares with the
JAX package depend on that order: the ``p{i}``/``s{i}`` keys of a
checkpoint's model npz, the flat parameter vector a ``zero1_flat``
optimizer state is laid out in, and the ``/``-joined keys of an
optimizer state's arrays.  Every one of them goes through
``leaves_with_paths`` here.
"""

from __future__ import annotations

from typing import Any, List, Tuple


def leaves_with_paths(tree, prefix: Tuple[str, ...] = ()
                      ) -> List[Tuple[Tuple[str, ...], Any]]:
    """(path, leaf) pairs of a nested dict in JAX's pytree order: each
    dict's keys sorted, depth first; empty dicts and ``None`` hold no
    leaf."""
    if tree is None:
        return []
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    out = []
    for k in sorted(tree):
        out.extend(leaves_with_paths(tree[k], prefix + (str(k),)))
    return out


def leaves(tree) -> list:
    """The leaves of ``tree`` in JAX's order."""
    return [leaf for _, leaf in leaves_with_paths(tree)]


def empty_paths(tree, prefix: Tuple[str, ...] = ()) -> List[Tuple[str, ...]]:
    """Paths of the empty dicts below the root (a parameter-less
    layer's slot), which an optimizer state's npz keeps as
    ``<path>/__emptydict__`` so the tree round-trips."""
    if not isinstance(tree, dict):
        return []
    if not tree:
        return [prefix] if prefix else []
    out = []
    for k in sorted(tree):
        out.extend(empty_paths(tree[k], prefix + (str(k),)))
    return out


def unflatten(pairs) -> dict:
    """A nested dict from (path, leaf) pairs; a path of length 0 is not
    allowed."""
    root: dict = {}
    for path, leaf in pairs:
        d = root
        for p in path[:-1]:
            d = d.setdefault(p, {})
        d[path[-1]] = leaf
    return root


__all__ = ["leaves_with_paths", "leaves", "empty_paths", "unflatten"]
