"""Streaming data pipeline: generator -> micro-batches on the device.

Port of ``StreamPipeline`` of ``repro/data/pipeline.py``, without the
sharding argument.  The generator samples on the device, so there is no
host prefetch thread: each batch is a few asynchronous kernel launches.
"""

from __future__ import annotations

import torch

from repro_torch.data.generators import bin_numeric
from repro_torch.device import resolve_device


class StreamPipeline:
    """Prequential micro-batch stream of (x, y), x binned to ``n_bins``
    when that is not 0, drawn from a ``torch.Generator`` seeded with
    ``seed`` on ``device``."""

    def __init__(self, gen, batch: int, n_batches: int, *, n_bins: int = 0,
                 seed: int = 0, device=None):
        self.gen = gen
        self.batch = batch
        self.n_batches = n_batches
        self.n_bins = n_bins
        self.seed = seed
        self.device = device

    def __iter__(self):
        g = torch.Generator(device=resolve_device(self.device))
        g.manual_seed(self.seed)
        for _ in range(self.n_batches):
            x, y = self.gen.sample(g, self.batch)
            if self.n_bins:
                x = bin_numeric(x, self.n_bins)
            yield x, y

