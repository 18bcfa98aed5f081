"""Plain PyTorch version of the batched multi-tree router (the semantics
of ``repro/kernels/tree_route/ref.py``, written as flat gathers)."""

from __future__ import annotations

import torch


def tree_route_ref(split_attr, split_bin, children, xbin, max_depth: int):
    """split_attr/split_bin: [M, N] i32; children: [M, N, 2] i32;
    xbin: [B, m] i32 (one micro-batch shared by all M trees).
    Returns leaf ids [M, B] i32."""
    M, N = split_attr.shape
    B, m = xbin.shape
    dev = xbin.device
    sa = split_attr.reshape(-1).long()
    sb = split_bin.reshape(-1)
    ch = children.reshape(-1).long()
    xflat = xbin.reshape(-1)
    brow = (torch.arange(B, device=dev) * m)[None]                 # [1, B]
    base = (torch.arange(M, device=dev) * N)[:, None]              # [M, 1]
    node = base.expand(M, B).clone()                               # flat ids
    for _ in range(max_depth):
        attr = sa[node]
        v = xflat[brow + attr.clamp(min=0)]
        go_right = (v > sb[node]).long()
        nxt = base + ch[node * 2 + go_right]
        node = torch.where(attr < 0, node, nxt)
    return (node - base).to(torch.int32)
