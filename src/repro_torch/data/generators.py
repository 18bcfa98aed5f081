"""Synthetic dense stream generator of the paper's evaluation (section 6.3).

Port of ``bin_numeric`` and ``RandomTreeGenerator`` of
``repro/data/generators.py``.  The dense stream: attributes drawn under a
hidden random decision tree; mixed categorical/numerical ("100-100" = 100
cat + 100 num); binary balanced classes.

The hidden tree comes from the same ``np.random.RandomState(seed)`` draws
as in the JAX package, so it is identical.  The samples are drawn on the
device from a ``torch.Generator``: they follow the same distribution as
the JAX sampler's, not the same numbers.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device

f32 = torch.float32
i32 = torch.int32


def bin_numeric(x, n_bins: int):
    """[0,1] floats -> i32 bins."""
    return torch.clamp((x * n_bins).to(i32), 0, n_bins - 1)


@dataclasses.dataclass
class RandomTreeGenerator:
    """Dense generator: hidden random binary decision tree labels instances.

    n_cat categorical (n_vals values) + n_num numerical attributes.
    """
    n_cat: int = 100
    n_num: int = 100
    n_vals: int = 5
    n_classes: int = 2
    depth: int = 8
    seed: int = 7
    device: object = None

    def __post_init__(self):
        dev = resolve_device(self.device)
        rng = np.random.RandomState(self.seed)
        n_nodes = 2 ** self.depth - 1
        m = self.n_cat + self.n_num
        self._attr = torch.as_tensor(rng.randint(0, m, n_nodes).astype(np.int32),
                                     device=dev)
        self._thresh = torch.as_tensor(rng.rand(n_nodes).astype(np.float32),
                                       device=dev)
        # leaves get balanced classes
        leaves = 2 ** self.depth
        labels = np.tile(np.arange(self.n_classes),
                         leaves // self.n_classes + 1)[:leaves]
        rng.shuffle(labels)
        self._leaf_label = torch.as_tensor(labels.astype(np.int32), device=dev)

    @property
    def n_attrs(self):
        return self.n_cat + self.n_num

    def _label(self, x):
        """Walk the hidden tree on x [n, m] f32 -> labels [n] i32."""
        node = torch.zeros(x.shape[0], dtype=torch.long, device=x.device)
        for _ in range(self.depth):
            a = self._attr[node].long()
            v = torch.gather(x, 1, a[:, None])[:, 0]
            node = 2 * node + 1 + (v > self._thresh[node]).long()
        return self._leaf_label[node - (2 ** self.depth - 1)]

    def sample(self, generator: torch.Generator, n: int):
        """(x [n, m] f32 in [0, 1], y [n] i32), drawn from ``generator`` on
        the generator's device."""
        dev = generator.device
        x_num = torch.rand((n, self.n_num), generator=generator, device=dev)
        x_cat = (torch.randint(0, self.n_vals, (n, self.n_cat),
                               generator=generator, device=dev).to(f32)
                 / max(self.n_vals - 1, 1))
        x = torch.cat([x_cat, x_num], dim=1)
        return x, self._label(x)

    def sample_binned(self, generator: torch.Generator, n: int,
                      n_bins: int = 8):
        """Pre-binned dense sample: (bins [n, m] i32 in [0, n_bins), y),
        each bin uniform, labels from the hidden tree walked on the bin
        midpoints.  Power-of-two n_bins <= 16, as in the JAX package."""
        if n_bins & (n_bins - 1) or not 0 < n_bins <= 16:
            raise ValueError(f"n_bins must be a power of two <= 16, "
                             f"got {n_bins}")
        dev = generator.device
        bins = torch.randint(0, n_bins, (n, self.n_attrs), generator=generator,
                             device=dev, dtype=i32)
        x = (bins.to(f32) + 0.5) / n_bins         # bin midpoints in [0, 1]
        return bins, self._label(x)
