"""Sort one shared [B, m] micro-batch to a leaf in each of M trees (the
model aggregator's step, paper Alg. 1 line 1; M > 1 for ensembles), and
the two forms of a fleet of M learners: ``tree_route_batched`` (one batch
per tree, the fleet's step) and ``tree_route_rows`` (a tree per row, the
fleet's served batch, whose rows mix tenants).

On a CUDA tensor it launches the hand-written kernel of
``csrc/tree_route.cu``: a warp per (member, instance) loads the instance's
bin of every inner node of the member's tree at once and then walks the
tree in shared memory, so no device-memory read waits on another.  On a
CPU tensor it runs the plain version of ``ref.py``.  Routing is
integer-only, so both give the same leaf ids.  The batched form is the
same kernel, each block reading its own member's rows; the row form walks
each row's tree from device memory, a thread per row.  Each wrapper counts
its own launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.tree_route.ref import (tree_route_batched_ref,
                                                tree_route_ref,
                                                tree_route_rows_ref)

_ARGTYPES = (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 5 + (ctypes.c_void_p,)


def tree_route(split_attr, split_bin, children, xbin, *, max_depth: int):
    """split_attr/split_bin: [M, N] (or [N] for one tree) i32;
    children: [M, N, 2] (or [N, 2]) i32; xbin: [B, m] i32.
    Returns leaf ids [M, B] i32 ([B] when the tables were rank-1)."""
    single = split_attr.dim() == 1
    if single:
        split_attr, split_bin, children = (
            split_attr[None], split_bin[None], children[None])
    if xbin.device.type == "cpu":
        out = tree_route_ref(split_attr, split_bin, children, xbin, max_depth)
    else:
        out = _launch(split_attr, split_bin, children, xbin, max_depth)
    return out[0] if single else out


def tree_route_batched(split_attr, split_bin, children, xbin, *,
                       max_depth: int):
    """split_attr/split_bin: [M, N] i32; children: [M, N, 2] i32;
    xbin: [M, B, m] i32, tree i's own batch at ``xbin[i]``.  Returns leaf
    ids [M, B] i32."""
    if xbin.device.type == "cpu":
        return tree_route_batched_ref(split_attr, split_bin, children, xbin,
                                      max_depth)
    return _launch(split_attr, split_bin, children, xbin, max_depth,
                   batched=True)


def tree_route_rows(split_attr, split_bin, children, xbin, member, *,
                    max_depth: int):
    """split_attr/split_bin: [M, N] i32; children: [M, N, 2] i32;
    xbin: [R, m] i32; member: [R] i32, the tree of each row.  Returns
    leaf ids [R] i32, -1 for a row whose member is outside [0, M)."""
    if xbin.device.type == "cpu":
        return tree_route_rows_ref(split_attr, split_bin, children, xbin,
                                   member, max_depth)
    M, N = split_attr.shape
    R, m = xbin.shape
    dev = xbin.device
    _check_tables(split_attr, split_bin, children, M, N, dev)
    _build.check_tensor(xbin, torch.int32, (R, m), "xbin")
    _build.check_tensor(member, torch.int32, (R,), "member", dev)
    leaf = torch.empty((R,), dtype=torch.int32, device=dev)
    if R == 0:
        return leaf
    fn = _build.function("tree_route", "tree_route_rows_launch",
                         (ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 5
                         + (ctypes.c_void_p,))
    with torch.cuda.device(dev):
        err = fn(split_attr.data_ptr(), split_bin.data_ptr(),
                 children.data_ptr(), xbin.data_ptr(), member.data_ptr(),
                 leaf.data_ptr(), M, N, R, m, max_depth,
                 _build.stream_of(xbin))
    _build.check(err, "tree_route_rows")
    tree_route_rows.launches += 1
    return leaf


def _check_tables(split_attr, split_bin, children, M, N, dev):
    _build.check_tensor(split_attr, torch.int32, (M, N), "split_attr", dev)
    _build.check_tensor(split_bin, torch.int32, (M, N), "split_bin", dev)
    _build.check_tensor(children, torch.int32, (M, N, 2), "children", dev)


def _launch(split_attr, split_bin, children, xbin, max_depth, batched=False):
    M, N = split_attr.shape
    B, m = xbin.shape[-2:]
    dev = xbin.device
    _build.check_tensor(xbin, torch.int32, (M, B, m) if batched else (B, m),
                        "xbin")
    _check_tables(split_attr, split_bin, children, M, N, dev)
    leaf = torch.empty((M, B), dtype=torch.int32, device=dev)
    if leaf.numel() == 0:
        return leaf
    wrapper = tree_route_batched if batched else tree_route
    fn = _build.function("tree_route", "tree_route_batched_launch"
                         if batched else "tree_route_launch", _ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(split_attr.data_ptr(), split_bin.data_ptr(),
                 children.data_ptr(), xbin.data_ptr(), leaf.data_ptr(),
                 M, N, B, m, max_depth, _build.stream_of(xbin))
    _build.check(err, wrapper.__name__)
    wrapper.launches += 1
    return leaf


tree_route.launches = tree_route_batched.launches = 0
tree_route_rows.launches = 0
