"""Parameter trees: nested dicts (and lists or tuples) of tensors, the port's
counterpart of the JAX package's pytrees."""
from __future__ import annotations

from typing import Any, Callable, Iterator


def tree_leaves(tree: Any) -> Iterator[Any]:
    """The leaves in a fixed order: dict values in insertion order, then
    list and tuple items in order."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tree_leaves(v)
    else:
        yield tree


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """The same structure with ``fn`` applied to every leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)
