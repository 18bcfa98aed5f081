"""Plain PyTorch version of the split-gain reduction (mirrors
``repro/kernels/split_gain/ref.py`` operation by operation)."""

from __future__ import annotations

import torch

NEG = -1e30


def _entropy(counts, dim=-1):
    tot = counts.sum(dim, keepdim=True)
    p = counts / torch.clamp(tot, min=1e-12)
    h = -torch.sum(torch.where(p > 0, p * torch.log2(torch.clamp(p, min=1e-12)),
                               0.0), dim)
    return torch.where(tot[..., 0] > 0, h, 0.0)


def split_gain_ref(stats):
    """stats: [N, m, bins, C] f32 -> gains [N, m, bins] f32."""
    cum = torch.cumsum(stats, dim=2)
    total = cum[:, :, -1:, :]
    left = cum
    right = total - left
    nl = left.sum(-1)
    nr = right.sum(-1)
    n = torch.clamp(nl + nr, min=1e-12)
    h_tot = _entropy(total[:, :, 0, :])
    hl = _entropy(left)
    hr = _entropy(right)
    gain = h_tot[..., None] - (nl / n * hl + nr / n * hr)
    valid = (nl > 0) & (nr > 0)
    return torch.where(valid, gain, NEG)
