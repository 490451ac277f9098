"""Parameter trees of the port: nested dicts and lists whose leaves are
tensors, QTensors or plain values (the counterpart of JAX pytrees)."""

from __future__ import annotations

from typing import Any, Callable


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """Apply ``fn`` to every leaf; dicts, lists and tuples are nodes."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)

