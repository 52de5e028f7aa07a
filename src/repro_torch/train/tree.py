"""Trees of tensors: nested dicts, lists and tuples (NamedTuples
included), the port's counterpart of the ``jax.tree`` calls the training
modules make.  Dict keys are walked in sorted order, as JAX flattens them.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

Path = Tuple[Any, ...]


def children(tree) -> List[Tuple[Any, Any]]:
    """(key, child) pairs of a node, or [] for a leaf."""
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return list(enumerate(tree))
    return []


def _is_node(tree) -> bool:
    return isinstance(tree, (dict, list, tuple))


def leaves_with_paths(tree, path: Path = ()) -> List[Tuple[Path, Any]]:
    """Every leaf with its path of dict keys and sequence indices."""
    if not _is_node(tree):
        return [(path, tree)]
    return [pl for k, child in children(tree) for pl in leaves_with_paths(child, path + (k,))]


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def rebuild(tree, kids: list):
    """A node of ``tree``'s type holding ``kids`` in its children's order."""
    if isinstance(tree, dict):
        return dict(zip(sorted(tree), kids))
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):  # NamedTuple
        return type(tree)(*kids)
    return type(tree)(kids)


def unflatten(like, new_leaves: List[Any]):
    """A tree of ``like``'s structure holding ``new_leaves`` in its leaf
    order."""
    it = iter(new_leaves)

    def build(t):
        if not _is_node(t):
            return next(it)
        return rebuild(t, [build(child) for _, child in children(t)])

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    columns = [leaves(t) for t in (tree,) + rest]
    if any(len(c) != len(columns[0]) for c in columns):
        raise ValueError("trees of different structure")
    return unflatten(tree, [fn(*xs) for xs in zip(*columns)])


def structure(tree) -> str:
    """A string of the tree's structure (keys, node types, no leaves), for
    a checkpoint's manifest."""
    if not _is_node(tree):
        return "*"
    inner = ",".join(f"{k}:{structure(child)}" for k, child in children(tree))
    return f"{type(tree).__name__}({inner})"
