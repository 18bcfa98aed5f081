"""Synthetic stream generators of the paper's evaluation.

Port of ``bin_numeric``, ``RandomTreeGenerator``, ``RandomTweetGenerator``,
``WaveformGenerator``, ``ElectricityLikeGenerator`` and
``CovtypeLikeGenerator`` of ``repro/data/generators.py``:

  dense       -- attributes drawn under a hidden random decision tree;
                 mixed categorical/numerical ("100-100" = 100 cat + 100
                 num); binary balanced classes (section 6.3).
  sparse      -- tweet-like Zipf bag of words, binary class.
  waveform    -- 21 waveform attributes + 19 noise, the waveform index as
                 a numeric target (section 7.3).
  electricity -- household power-consumption-like autoregressive series,
                 12 attributes, numeric target (section 7.3), or the
                 target thresholded at 0.5 as a binary class.
  covtype     -- covtype-like tabular stream: 10 numeric + 44 binary
                 attributes, 7 classes from a hidden noisy linear rule.

Constants (the hidden tree, the base waveforms, the Zipf word
distributions, the covtype rule) are the JAX package's own:
the same ``np.random.RandomState(seed)`` draws, or the same formula.  The
samples are drawn on the device from a ``torch.Generator``: they follow the
same distribution as the JAX sampler's, not the same numbers.
"""

from __future__ import annotations

import dataclasses
import math

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


@dataclasses.dataclass
class RandomTweetGenerator:
    """Sparse generator: Zipf(z) bag of words, about ``avg_words`` words a
    tweet, a binary class that permutes the Zipf ranking (a
    class-conditional word distribution)."""
    vocab: int = 1000
    avg_words: float = 15.0
    zipf_z: float = 1.5
    seed: int = 7
    device: object = None

    MAX_WORDS = 30

    def __post_init__(self):
        dev = resolve_device(self.device)
        rng = np.random.RandomState(self.seed)
        ranks = np.arange(1, self.vocab + 1, dtype=np.float64)
        p = ranks ** (-self.zipf_z)
        p /= p.sum()
        perm = rng.permutation(self.vocab)
        self._p = torch.as_tensor(np.stack([p, p[perm]]).astype(np.float32),
                                  device=dev)

    @property
    def n_attrs(self):
        return self.vocab

    @property
    def n_classes(self):
        return 2

    def sample(self, generator: torch.Generator, n: int):
        """(x [n, vocab] f32 word presence in {0, 1}, y [n] i32)."""
        dev = generator.device
        y = (torch.rand((n,), generator=generator, device=dev) < 0.5).to(i32)
        n_words = torch.clamp((self.avg_words + 4.0 * torch.randn(
            (n,), generator=generator, device=dev)).to(i32), 1, self.MAX_WORDS)
        words = torch.multinomial(self._p[y.long()], self.MAX_WORDS,
                                  replacement=True, generator=generator)
        kept = (torch.arange(self.MAX_WORDS, device=dev)[None]
                < n_words[:, None]).to(f32)
        x = torch.zeros((n, self.vocab), dtype=f32, device=dev)
        return x.scatter_add_(1, words, kept).clamp_(max=1.0), y


@dataclasses.dataclass
class WaveformGenerator:
    """3 base waveforms, 21 signal + 19 noise attrs; label = waveform id,
    taken as a numeric target by the regression learners (section 7.3)."""
    seed: int = 7
    n_attrs_signal: int = 21
    n_noise: int = 19
    device: object = None

    def __post_init__(self):
        dev = resolve_device(self.device)
        t = np.arange(self.n_attrs_signal)
        w = np.stack([
            np.maximum(6 - np.abs(t - 7), 0),
            np.maximum(6 - np.abs(t - 13), 0),
            np.maximum(6 - np.abs(t - 3), 0) + np.maximum(6 - np.abs(t - 17), 0),
        ]) / 6.0
        self._wave = torch.as_tensor(w.astype(np.float32), device=dev)

    @property
    def n_attrs(self):
        return self.n_attrs_signal + self.n_noise

    @property
    def n_classes(self):
        return 3

    def sample(self, generator: torch.Generator, n: int):
        """(x [n, 40] f32 in [0, 1], y [n] i32 waveform id), drawn from
        ``generator`` on its device."""
        dev = generator.device
        y = torch.randint(0, 3, (n,), generator=generator, device=dev)
        u = torch.rand((n, 1), generator=generator, device=dev)
        base = u * self._wave[y] + (1 - u) * self._wave[(y + 1) % 3]
        sig = base + 0.1 * torch.randn((n, self.n_attrs_signal),
                                       generator=generator, device=dev)
        noise = torch.rand((n, self.n_noise), generator=generator, device=dev)
        x = torch.cat([torch.clamp(sig, 0, 1), noise], 1)
        return x, y.to(i32)

    def sample_regression(self, generator: torch.Generator, n: int):
        x, y = self.sample(generator, n)
        return x, y.to(f32)


@dataclasses.dataclass
class ElectricityLikeGenerator:
    """Autoregressive household-consumption-like series: 12 attrs, numeric
    target (watt-hours) in [0, 1]."""
    seed: int = 7
    n_attrs: int = 12

    def sample(self, generator: torch.Generator, n: int):
        """(x [n, n_attrs] f32 in [0, 1], target [n] f32), drawn from
        ``generator`` on its device."""
        dev = generator.device
        t = torch.rand((n,), generator=generator, device=dev) * 2 * math.pi
        daily = 0.5 + 0.3 * torch.sin(t) + 0.1 * torch.sin(3 * t)
        feats = [daily[:, None]]
        carry = daily
        noise = torch.randn((n, self.n_attrs - 1), generator=generator,
                            device=dev) * 0.05
        for j in range(self.n_attrs - 1):
            carry = torch.clamp(0.8 * carry + 0.2 * noise[:, j] + 0.05, 0, 1)
            feats.append(carry[:, None])
        x = torch.cat(feats, 1)
        target = torch.clamp(0.6 * daily + 0.4 * x[:, -1] + 0.05 * torch.randn(
            (n,), generator=generator, device=dev), 0, 1)
        return x, target

    @property
    def n_classes(self):
        return 2

    def sample_classification(self, generator: torch.Generator, n: int):
        """(x, y [n] i32): the target above 0.5 as the class."""
        x, target = self.sample(generator, n)
        return x, (target > 0.5).to(i32)


@dataclasses.dataclass
class CovtypeLikeGenerator:
    """Covtype-like tabular stream: 54 attributes (10 numeric + 44 binary),
    7 classes from a hidden noisy linear rule (stands in for covtypeNorm)."""
    seed: int = 7
    device: object = None

    def __post_init__(self):
        dev = resolve_device(self.device)
        rng = np.random.RandomState(self.seed)
        self._w = torch.as_tensor((rng.randn(54, 7) * 0.7).astype(np.float32),
                                  device=dev)
        self._b = torch.as_tensor((rng.randn(7) * 0.1).astype(np.float32),
                                  device=dev)

    @property
    def n_attrs(self):
        return 54

    @property
    def n_classes(self):
        return 7

    def sample(self, generator: torch.Generator, n: int):
        """(x [n, 54] f32 in [0, 1], y [n] i32 in [0, 7))."""
        dev = generator.device
        xnum = torch.rand((n, 10), generator=generator, device=dev)
        xbin = (torch.rand((n, 44), generator=generator, device=dev)
                < 0.15).to(f32)
        x = torch.cat([xnum, xbin], 1)
        logits = x @ self._w + self._b + 0.5 * torch.randn(
            (n, 7), generator=generator, device=dev)
        return x, logits.argmax(-1).to(i32)
