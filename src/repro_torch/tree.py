"""Trees of tensors: nested dicts (keys sorted at every level, the order in
which JAX flattens a dict), with ``NamedTuple`` nodes such as ``optim.Q8``.

Leaf paths are spelled as ``jax.tree_util.keystr`` spells them —
``['params']['layers']['wq']``, ``['opt']['m']['layers']['wq'].codes``,
``['step']`` — so that a checkpoint names its leaves as the reference's
does, and each package restores the other's.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def leaves_with_path(tree, is_leaf: Callable[[Any], bool] | None = None,
                     path: str = "") -> Iterator[tuple[str, Any]]:
    """(key path, leaf) of every leaf, in flatten order."""
    if is_leaf is not None and is_leaf(tree):
        yield path, tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_path(tree[k], is_leaf, f"{path}[{k!r}]")
    elif _is_namedtuple(tree):
        for f in tree._fields:
            yield from leaves_with_path(getattr(tree, f), is_leaf, f"{path}.{f}")
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            yield from leaves_with_path(x, is_leaf, f"{path}[{i}]")
    else:
        yield path, tree


def leaves(tree, is_leaf: Callable[[Any], bool] | None = None) -> list:
    return [x for _, x in leaves_with_path(tree, is_leaf)]


def tree_map(fn, tree, *rest, is_leaf: Callable[[Any], bool] | None = None):
    """The tree of ``fn(leaf, *leaves of rest at the same place)``; every
    tree in ``rest`` has ``tree``'s structure."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest), is_leaf=is_leaf) for k in sorted(tree)}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, getattr(tree, f), *(getattr(r, f) for r in rest), is_leaf=is_leaf)
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, x, *(r[i] for r in rest), is_leaf=is_leaf) for i, x in enumerate(tree))
    return fn(tree, *rest)


def unflatten_like(like, values: list, is_leaf: Callable[[Any], bool] | None = None):
    """``like``'s structure with its leaves, in flatten order, replaced by ``values``."""
    it = iter(values)
    out = tree_map(lambda _: next(it), like, is_leaf=is_leaf)
    if next(it, it) is not it:
        raise ValueError("unflatten_like: more values than leaves")
    return out
