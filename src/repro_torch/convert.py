"""Carry state between the JAX package and the port as numpy arrays.

``state_from_numpy`` turns a learner or topology carry of the JAX package,
read out as numpy (``jax.tree.map(np.asarray, state)``), into the port's
tensors; ``state_to_numpy`` goes the other way.  Dtypes are kept: f32 stays
float32, i32 stays int32 and bool stays bool.  64-bit arrays are refused,
because numpy makes them by default and the state holds none.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.pytree import tree_map
from repro_torch.device import resolve_device

_DTYPES = {np.dtype(np.float32): torch.float32,
           np.dtype(np.int32): torch.int32,
           np.dtype(np.bool_): torch.bool}


def state_from_numpy(tree, device=None):
    """Nested dicts/lists/tuples of numpy arrays -> the same of tensors on
    ``device`` (``None`` means cuda)."""
    dev = resolve_device(device)

    def one(a):
        a = np.asarray(a)
        if a.dtype not in _DTYPES:
            raise TypeError(f"state arrays are float32, int32 or bool; got "
                            f"{a.dtype} (convert fixtures explicitly)")
        return torch.from_numpy(np.array(a, copy=True)).to(dev)

    return tree_map(one, tree)


def state_to_numpy(tree):
    """Nested dicts/lists/tuples of tensors -> the same of numpy arrays."""
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)
