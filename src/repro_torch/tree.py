"""Trees of tensors: nested dicts, lists, tuples and NamedTuples.

The reference keeps its parameters, optimizer state and train state as
JAX pytrees and walks them with ``jax.tree``; the port keeps the same
shapes of tree (dicts of tensors, NamedTuples of those) and walks them
here.  A leaf is anything else; ``None`` and empty containers hold no
leaf, as in a pytree.  Paths are the keys, field names and indices from
the root joined by ``"/"``, as the reference's ``_path_str`` writes
them.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple

__all__ = ["leaves_with_paths", "leaves", "tree_map", "unflatten"]


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree) -> Iterator[Tuple[str, Any]]:
    if isinstance(tree, dict):
        return ((str(k), v) for k, v in tree.items())
    if _is_namedtuple(tree):
        return ((f, getattr(tree, f)) for f in tree._fields)
    return ((str(i), v) for i, v in enumerate(tree))


def _is_node(tree) -> bool:
    return isinstance(tree, (dict, list, tuple))


def leaves_with_paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) of every leaf, depth first in the containers' order."""
    if tree is None:
        return []
    if not _is_node(tree):
        return [(prefix, tree)]
    out = []
    for name, child in _children(tree):
        out += leaves_with_paths(child, f"{prefix}/{name}" if prefix
                                 else name)
    return out


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``, trees of the same structure), in a tree of that
    structure."""
    if tree is None:
        return None
    if not _is_node(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, getattr(tree, f),
                                     *(getattr(r, f) for r in rest))
                            for f in tree._fields))
    return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                      for i, v in enumerate(tree))


def unflatten(template, new_leaves: List[Any]):
    """A tree of ``template``'s structure over ``new_leaves``, taken in
    :func:`leaves` order."""
    it = iter(new_leaves)
    out = tree_map(lambda _: next(it), template)
    if next(it, None) is not None:
        raise ValueError("unflatten: more leaves than the template holds")
    return out
