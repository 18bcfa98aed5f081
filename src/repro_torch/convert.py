"""Carry state and weights between the JAX package and the port as numpy
arrays.

``state_from_numpy`` turns a learner or topology carry of the JAX package,
read out as numpy (``jax.tree.map(np.asarray, state)``), into the port's
tensors; ``state_to_numpy`` goes the other way.  ``params_from_numpy`` turns
an LM's parameter or cache tree into the port's, split per layer;
``accumulator_from_numpy`` a ``MetricAccumulator`` state (float64, the one
tree here that holds 64-bit arrays) into the port's accumulator.  A
CluStream state and a chunked carry (``{"states": ..., "feedback": ...}``,
the feedback ``None`` before the first step) go through
``state_from_numpy`` like any learner state; ``fleet_state_from_numpy``
takes a ``LearnerFleet``'s packed state (its ``[F, ...]`` tenant leaves
and ``[F]`` cursor) and checks that every leaf has the fleet axis.  Dtypes
are kept: f32 stays float32, i32 stays int32, bool stays bool and bf16
stays bfloat16, and a uint32 PRNG key (the ensembles') stays uint32.
64-bit arrays are refused, because numpy makes them by default and no
state or weight holds one.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.pytree import tree_leaves, tree_map
from repro_torch.device import resolve_device

_DTYPES = {np.dtype(np.float32): torch.float32,
           np.dtype(np.int32): torch.int32,
           np.dtype(np.bool_): torch.bool,
           np.dtype(np.uint32): torch.uint32}


def _tensor(a, dev):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # numpy knows bf16 only through ml_dtypes; its bits travel as int16,
        # so that neither the port nor the card's machine needs that package
        bits = np.ascontiguousarray(a).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(dev)
    if a.dtype not in _DTYPES:
        raise TypeError(f"arrays are float32, bfloat16, int32, uint32 or "
                        f"bool; got {a.dtype} (convert fixtures explicitly)")
    return torch.from_numpy(np.array(a, copy=True)).to(dev)


def state_from_numpy(tree, device=None):
    """Nested dicts/lists/tuples of numpy arrays -> the same of tensors on
    ``device`` (``None`` means cuda)."""
    dev = resolve_device(device)
    return tree_map(lambda a: _tensor(a, dev), tree)


def state_to_numpy(tree):
    """Nested dicts/lists/tuples of tensors -> the same of numpy arrays."""
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)


def fleet_state_from_numpy(tree, device=None):
    """A fleet state of the JAX package, read out as numpy (``{"tenant":
    packed [F, ...] leaves, "cursor": [F] int32}``), -> the port's, on
    ``device`` (``None`` means cuda).  Raises unless the cursor is [F]
    int32 and every tenant leaf leads with the same F."""
    if not (isinstance(tree, dict) and set(tree) == {"tenant", "cursor"}):
        raise TypeError("a fleet state is {'tenant': ..., 'cursor': ...}")
    cursor = np.asarray(tree["cursor"])
    if cursor.ndim != 1 or cursor.dtype != np.int32:
        raise TypeError(f"the fleet cursor must be [F] int32, got "
                        f"{cursor.dtype} of shape {cursor.shape}")
    F = cursor.shape[0]
    for leaf in tree_leaves(tree["tenant"]):
        if np.ndim(leaf) < 1 or np.shape(leaf)[0] != F:
            raise ValueError(f"a tenant leaf of shape {np.shape(leaf)} "
                             f"lacks the fleet axis of {F} tenants")
    return state_from_numpy(tree, device)


def params_from_numpy(tree, cfg, device=None):
    """An LM's parameter tree (or cache tree) of the JAX package, read out
    as numpy, -> the port's tree on ``device`` (``None`` means cuda): each
    layer-stacked subtree (leading axis = layer, ``lm.py::_stack_defs``)
    becomes a list of per-layer trees.  ``LanguageModel(cfg, params)``
    takes the parameters; ``decode_step`` takes the caches."""
    from repro_torch.models.lm import stacks

    dev = resolve_device(device)
    stacked = {name for name, _, _ in stacks(cfg)}
    out = {}
    for key, sub in tree.items():
        sub = tree_map(lambda a: _tensor(a, dev), sub)
        if key in stacked:
            n = tree_leaves(sub)[0].shape[0]
            sub = [tree_map(lambda t, i=i: t[i].clone(), sub)
                   for i in range(n)]
        out[key] = sub
    return out


def accumulator_from_numpy(state):
    """A ``MetricAccumulator.state()`` of the JAX package (float64 numpy
    arrays: correct, abs_err, seen, curve) -> the port's accumulator,
    holding the same numbers."""
    from repro_torch.core.evaluation import MetricAccumulator
    return MetricAccumulator().load(
        {k: np.asarray(state[k], np.float64)
         for k in ("correct", "abs_err", "seen", "curve")})
