"""Nested dicts, lists and tuples of tensors: the port's parameter and
state trees (Enel's parameters, an LM's from ``models.transformer.
init_model``, a train state with the optimizer's moments, a campaign's
carry).

The order is fixed, as ``jax.tree_util``'s is: dict keys sorted, lists and
tuples in order.  A leaf's path joins its keys and indices with "/", as
the reference's checkpoint manifest names a leaf.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def leaves_with_paths(tree, path: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) pairs of ``tree`` in its fixed order."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in leaves_with_paths(tree[k], _join(path, k))]
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree)
                for pl in leaves_with_paths(v, _join(path, i))]
    return [(path, tree)]


def leaves(tree) -> List[Any]:
    """The leaves of ``tree`` in its fixed order."""
    return [leaf for _, leaf in leaves_with_paths(tree)]


def map_with_paths(fn: Callable[[str, Any], Any], tree, path: str = ""):
    """``fn(path, leaf)`` at every leaf; the same structure."""
    if isinstance(tree, dict):
        return {k: map_with_paths(fn, v, _join(path, k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_paths(fn, v, _join(path, i))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def tree_map(fn: Callable[[Any], Any], tree):
    """``fn`` applied to every leaf; the same structure."""
    return map_with_paths(lambda _, leaf: fn(leaf), tree)


def _join(path: str, key) -> str:
    return f"{path}/{key}" if path else str(key)
