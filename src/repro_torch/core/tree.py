"""Parameter trees of the port: nested dicts and lists whose leaves are
tensors, QTensors or plain values (the counterpart of JAX pytrees).

Where the JAX package stacks a family's layers along a leading L axis
(the dense, MoE, vlm and SSM ``"layers"``, the encoder-decoder's
``"enc_layers"`` and ``"dec_layers"``), the port keeps a ``LayerStack``:
a list of per-layer dicts that the tree functions treat as that axis
(``quantize_tree`` counts sizes over it, ``cast_for_compute`` counts one
dimension more). A plain list of layer dicts, the hybrid's ``"layers"``,
is a list in the JAX package too, and its leaves are taken one by one."""

from __future__ import annotations

from typing import Any, Callable


class LayerStack(list):
    """The per-layer dicts of a stack the JAX package holds as one
    (L, ...) tree; ``tree_map`` keeps the type."""


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` to every leaf; dicts, lists and tuples are nodes. With
    ``rest`` (trees of the same structure) ``fn`` takes the leaves of
    every tree at one place, as ``jax.tree_util.tree_map`` does."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list:
    """The leaves in ``tree_map``'s order."""
    out: list = []
    tree_map(out.append, tree)
    return out


def tree_unflatten(like: Any, leaves: list) -> Any:
    """A tree of ``like``'s structure holding ``leaves`` in order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)
