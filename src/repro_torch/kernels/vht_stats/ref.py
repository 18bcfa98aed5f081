"""Plain PyTorch version of the VHT statistics update (mirrors
``repro/kernels/vht_stats/ref.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def stats_update_ref(stats, leaf, xbin, y, w):
    """stats: [N, m, bins, C] f32; leaf: [B] i32; xbin: [B, m] i32;
    y: [B] i32; w: [B] f32.  Adds the micro-batch's one-hot counts to
    ``stats`` in place and returns it."""
    n_bins, n_classes = stats.shape[2], stats.shape[3]
    binoh = F.one_hot(xbin.long(), n_bins).to(torch.float32)      # [B,m,bins]
    clsoh = F.one_hot(y.long(), n_classes).to(torch.float32) * w[:, None]
    val = binoh[..., None] * clsoh[:, None, None, :]              # [B,m,bins,C]
    return stats.index_add_(0, leaf.long(), val)
