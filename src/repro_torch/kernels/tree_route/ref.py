"""Plain PyTorch versions of the batched multi-tree router (the semantics
of ``repro/kernels/tree_route/ref.py``, written as flat gathers), and of
its two fleet forms: one batch per tree, and a tree per row."""

from __future__ import annotations

import torch


def _walk(split_attr, split_bin, children, xbin, tree, row, max_depth):
    """The leaf of each (tree[i], row[i]) pair: ``tree`` [...] the flat
    tree index, ``row`` [...] the xbin row, broadcast together."""
    N = split_attr.shape[1]
    m = xbin.shape[-1]
    sa = split_attr.reshape(-1).long()
    sb = split_bin.reshape(-1)
    ch = children.reshape(-1).long()
    xflat = xbin.reshape(-1)
    base = tree * N
    brow = row * m
    node = (base + 0 * brow).clone()                               # flat ids
    for _ in range(max_depth):
        attr = sa[node]
        v = xflat[brow + attr.clamp(min=0)]
        go_right = (v > sb[node]).long()
        nxt = base + ch[node * 2 + go_right]
        node = torch.where(attr < 0, node, nxt)
    return (node - base).to(torch.int32)


def tree_route_ref(split_attr, split_bin, children, xbin, max_depth: int):
    """split_attr/split_bin: [M, N] i32; children: [M, N, 2] i32;
    xbin: [B, m] i32 (one micro-batch shared by all M trees).
    Returns leaf ids [M, B] i32."""
    M, B = split_attr.shape[0], xbin.shape[0]
    dev = xbin.device
    return _walk(split_attr, split_bin, children, xbin,
                 torch.arange(M, device=dev)[:, None],
                 torch.arange(B, device=dev)[None], max_depth)


def tree_route_batched_ref(split_attr, split_bin, children, xbin,
                           max_depth: int):
    """The fleet step's form: xbin [M, B, m] i32, tree i routes its own
    batch ``xbin[i]``.  Returns leaf ids [M, B] i32."""
    M, B = xbin.shape[:2]
    dev = xbin.device
    tree = torch.arange(M, device=dev)[:, None]
    return _walk(split_attr, split_bin, children, xbin, tree,
                 tree * B + torch.arange(B, device=dev)[None], max_depth)


def tree_route_rows_ref(split_attr, split_bin, children, xbin, member,
                        max_depth: int):
    """The fleet predict's form: xbin [R, m] i32 and member [R] i32, row
    i routed through tree ``member[i]``.  Returns leaf ids [R] i32, -1
    where the member is outside [0, M)."""
    M = split_attr.shape[0]
    member = member.long()
    ok = (member >= 0) & (member < M)
    leaf = _walk(split_attr, split_bin, children, xbin,
                 torch.where(ok, member, 0),
                 torch.arange(xbin.shape[0], device=xbin.device), max_depth)
    return torch.where(ok, leaf, -1)
