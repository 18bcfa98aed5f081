"""Parameter metadata: declare, then materialize.

The models of the zoo declare their parameters (and their decode caches)
as trees of ``ParamDef`` leaves, as the JAX package does: shape, logical
axes, initializer and dtype.  ``init_params`` materializes a tree on a
device.  The port runs on one card, so the axes are kept only to read like
the JAX declarations; nothing shards by them.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.pytree import tree_leaves
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    init: str = "normal"          # normal | zeros | ones | small
    dtype: torch.dtype = torch.bfloat16
    scale: float | None = None    # overrides fan-in scaling when set
    # > 0: one layer of a stack of this many.  The JAX package declares a
    # stack as one leaf with a leading layer axis, and its fan-in counts
    # that axis; so does the port's, to draw from the same distribution.
    layers: int = 0

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def _fan_in(d: ParamDef) -> int:
    shape = (d.layers, *d.shape) if d.layers else d.shape
    if len(shape) <= 1:
        return shape[0] if shape else 1
    # contract over all but the last axis by convention [in..., out]
    return math.prod(shape[:-1])


def map_defs(fn, defs):
    if isinstance(defs, ParamDef):
        return fn(defs)
    if isinstance(defs, dict):
        return {k: map_defs(fn, v) for k, v in defs.items()}
    if isinstance(defs, (list, tuple)):
        return type(defs)(map_defs(fn, v) for v in defs)
    raise TypeError(f"not a ParamDef tree: {type(defs)}")


def init_params(defs, generator: torch.Generator | None = None, device=None):
    """Materialize a tree of ``ParamDef`` into tensors on ``device`` (None
    means cuda, and raises without one).

    The initializers are the JAX package's: ``zeros``, ``ones``, and a
    normal draw in float32 times the fan-in std (``scale`` overrides it;
    ``small`` is 0.02 unless ``scale`` is set), cast to the leaf's dtype.
    The draws come from ``generator``, which must live on ``device`` (a
    fresh one seeded 0 when None), so they match the JAX package's in
    distribution only."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)

    def one(d: ParamDef):
        if d.init == "zeros":
            return torch.zeros(d.shape, dtype=d.dtype, device=dev)
        if d.init == "ones":
            return torch.ones(d.shape, dtype=d.dtype, device=dev)
        std = d.scale if d.scale is not None else 1.0 / math.sqrt(
            max(_fan_in(d), 1))
        if d.init == "small":
            std = d.scale if d.scale is not None else 0.02
        x = torch.randn(d.shape, generator=generator, dtype=torch.float32,
                        device=dev)
        return (x.mul_(std)).to(d.dtype)

    return map_defs(one, defs)


def count_params(defs) -> int:
    return sum(math.prod(d.shape) for d in tree_leaves(defs))
