"""Nested dicts, lists and tuples of tensors: the port's pytrees."""

from __future__ import annotations

import torch


def tree_map(fn, tree, *rest):
    """Apply ``fn`` to the leaves of ``tree`` (and the matching leaves of
    ``rest``), keeping the structure.  ``None`` stays ``None``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in ``tree_map`` order."""
    out = []
    tree_map(out.append, tree)
    return out


def tree_clone(tree):
    """A copy of ``tree`` whose tensors share no memory with it."""
    return tree_map(
        lambda x: x.clone() if isinstance(x, torch.Tensor) else x, tree)


def scan(step, state, x_stream, y_stream):
    """``lax.scan`` of ``step(state, x, y) -> (state, metrics)`` over the
    micro-batches of a stream: (final state, metrics stacked to [T])."""
    metrics = []
    for x, y in zip(x_stream, y_stream):
        state, m = step(state, x, y)
        metrics.append(m)
    return state, {k: torch.stack([m[k] for m in metrics])
                   for k in metrics[0]}
