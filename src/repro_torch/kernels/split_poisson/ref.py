"""Plain PyTorch version of ``split_poisson``: ``jax.random.split`` and
``jax.random.poisson`` of ``core/prng.py``, as ``repro/ml/ensemble.py``
draws its member weights."""

from __future__ import annotations

import torch

from repro_torch.core import prng


def split_poisson_ref(key, lam, shape):
    """key: [2] uint32; lam: f32 broadcastable to ``shape`` (every value
    below 10).  Returns (key', w): the first key of ``split(key)``, and
    f32 Poisson(lam) draws of ``shape`` from its second key."""
    keys = prng.split(key)
    w = prng.poisson_knuth(keys[1], lam, shape).to(torch.float32)
    return keys[0].clone(), w
