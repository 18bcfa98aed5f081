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
    ``seed`` on ``device``.  With ``classification`` (the default) a
    generator's ``sample_classification`` is taken where it has one."""

    def __init__(self, gen, batch: int, n_batches: int, *, n_bins: int = 0,
                 seed: int = 0, classification: bool = True, device=None):
        self.gen = gen
        self.batch = batch
        self.n_batches = n_batches
        self.n_bins = n_bins
        self.seed = seed
        self.classification = classification
        self.device = device

    def __iter__(self):
        g = torch.Generator(device=resolve_device(self.device))
        g.manual_seed(self.seed)
        sample = getattr(self.gen, "sample_classification", None)
        if not self.classification or sample is None:
            sample = self.gen.sample
        for _ in range(self.n_batches):
            x, y = sample(g, self.batch)
            if self.n_bins:
                x = bin_numeric(x, self.n_bins)
            yield x, y

