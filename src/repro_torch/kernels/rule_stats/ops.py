"""The AMRules rule-statistics update, ``stats[r, j, b, c] += sum_i
1[seg_i = r] 1[xbin_ij = b] mom[i, c]``, with the (w, w*y, w*y^2) moments
of ``rule_moments``; rows outside [0, R) (AMRules' discard row R) and bins
outside [0, bins) are dropped.

``rule_stats_scatter`` launches the hand-written kernel of
``csrc/rule_stats.cu`` for CUDA tensors and runs the plain version of
``ref.py`` for CPU tensors; ``segment_sum`` does the same for the path's
float reductions and counts its launches apart.  Both sum each cell in
instance order, as XLA's CPU scatter does, so the kernel and the plain
version agree with each other and with the JAX package bit for bit, and
they update ``stats`` in place.  The other two functions are built on
them and take another scatter through ``scatter=`` (the plain one, say):

  rule_stats_update -- the JAX package's dispatcher: "segment" (its
                       default path off the TPU, the R == 1 branch
                       included; "auto" is the same here) or "onehot";
  batch_sum         -- a whole-array sum in XLA's CPU order (by default
                       through ``segment_sum``).

A fleet of F learners takes the kernel's tenant form: ``segment_sum_tenant``
sums F independent segment sums in one launch (each tenant's rows in its
own segments, in instance order, so each tenant's sums are the single
learner's bits), and ``batch_sum_tenant`` is ``batch_sum`` per tenant
through it.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rule_stats.ref import (batch_sum_tenant_with,
                                                batch_sum_with,
                                                rule_stats_ref,
                                                rule_stats_scatter_ref,
                                                segment_sum_tenant_ref,
                                                segment_update_with)

_ARGTYPES = (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 5 + (ctypes.c_void_p,)
# the columns csrc/rule_stats.cu takes: up to MAX_MOMENTS a thread keeps a
# cell's sums in registers; up to MAX_COLUMNS (its MAX_WIDE) its wide form
# takes a lane per column of a block's 32, for CluStream's 2d-column CF
# scatter
MAX_MOMENTS = 8
MAX_COLUMNS = 4096


def rule_moments(y, w=None):
    """The AMRules moment matrix [B, 3]: (w, w*y, w*y^2) per instance."""
    w = torch.ones_like(y) if w is None else w
    return torch.stack([w, w * y, w * torch.square(y)], -1)


def _scatter(stats, seg, xbin, mom, wrapper):
    """The plain version for CPU tensors; for CUDA tensors the kernel,
    counted in ``wrapper.launches``, and a launch of its wide form (more
    than ``MAX_MOMENTS`` columns) in ``wrapper.wide_launches`` too."""
    if stats.device.type == "cpu":
        return rule_stats_scatter_ref(stats, seg, xbin, mom)
    R, m, bins, C = stats.shape
    B = seg.shape[0]
    _build.check_tensor(stats, torch.float32, (R, m, bins, C), "stats")
    _build.check_tensor(seg, torch.int32, (B,), "seg", stats.device)
    _build.check_tensor(xbin, torch.int32, (B, m), "xbin", stats.device)
    _build.check_tensor(mom, torch.float32, (B, C), "mom", stats.device)
    if C > MAX_COLUMNS:
        raise ValueError(f"rule_stats kernel takes at most {MAX_COLUMNS} "
                         f"columns, got {C}")
    if R * m * bins * C == 0:
        return stats
    fn = _build.function("rule_stats", "rule_stats_launch", _ARGTYPES)
    with torch.cuda.device(stats.device):
        err = fn(stats.data_ptr(), seg.data_ptr(), xbin.data_ptr(),
                 mom.data_ptr(), R, m, bins, C, B, _build.stream_of(stats))
    _build.check(err, "rule_stats")
    wrapper.launches += 1
    if C > MAX_MOMENTS:
        wrapper.wide_launches += 1
    return stats


def rule_stats_scatter(stats, seg, xbin, mom):
    """The moment statistics.  stats: [R, m, bins, C] f32; seg: [B] i32;
    xbin: [B, m] i32; mom: [B, C] f32.  Adds each instance's moments to its
    cells in instance order, in place; returns ``stats``."""
    return _scatter(stats, seg, xbin, mom, rule_stats_scatter)


def segment_sum(out, seg, xbin, vals):
    """The same scatter, and kernel, for the paths' float reductions: the
    per-rule sums (``jax.ops.segment_sum``; one attribute, one bin), the
    levels of ``batch_sum`` and CluStream's CF scatter (its 2d columns of
    x | x^2 in the kernel's wide form).  Counted apart from
    ``rule_stats_scatter``, so that a run shows the moment statistics' own
    launches."""
    return _scatter(out, seg, xbin, vals, segment_sum)


rule_stats_scatter.launches = rule_stats_scatter.wide_launches = 0
segment_sum.launches = segment_sum.wide_launches = 0

_TENANT_ARGTYPES = (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 4 + (
    ctypes.c_void_p,)


def segment_sum_tenant(out, seg, vals):
    """F segment sums in one launch.  out: [F, S, C] f32; seg: [F * B]
    i32, tenant f's rows at [f * B, (f + 1) * B), their segment ids local
    to the tenant (outside [0, S): dropped); vals: [F * B, C] f32.  Adds
    each tenant's rows to its own segments in instance order, in place;
    returns ``out``.  Counted in ``segment_sum_tenant.launches``, apart
    from ``segment_sum``."""
    if out.device.type == "cpu":
        return segment_sum_tenant_ref(out, seg, vals)
    F, S, C = out.shape
    n = seg.shape[0]
    if F == 0 or n % F:
        raise ValueError(f"segment_sum_tenant: {n} rows do not split into "
                         f"{F} tenants")
    _build.check_tensor(out, torch.float32, (F, S, C), "out")
    _build.check_tensor(seg, torch.int32, (n,), "seg", out.device)
    _build.check_tensor(vals, torch.float32, (n, C), "vals", out.device)
    if C > MAX_COLUMNS:
        raise ValueError(f"segment_sum_tenant takes at most {MAX_COLUMNS} "
                         f"columns, got {C}")
    if out.numel() == 0 or n == 0:
        return out
    fn = _build.function("rule_stats", "segment_sum_tenant_launch",
                         _TENANT_ARGTYPES)
    with torch.cuda.device(out.device):
        err = fn(out.data_ptr(), seg.data_ptr(), vals.data_ptr(), F, S, C,
                 n // F, _build.stream_of(out))
    _build.check(err, "segment_sum_tenant")
    segment_sum_tenant.launches += 1
    return out


segment_sum_tenant.launches = 0


def rule_stats_update(stats, seg, xbin, mom, *, impl: str = "auto",
                      scatter=None):
    """stats: [R, m, bins, C]; seg: [B] i32 in [0, R] (R = discard); xbin:
    [B, m] i32; mom: [B, C] f32.  ``impl`` "auto" and "segment" take the
    JAX package's segment path (the kernel on the card).  "onehot" is its
    one-hot oracle, a new tensor, on the CPU; on the card the oracle's
    index_add_ would sum in the order of its atomics, so there it runs the
    scatter, which sums as the oracle does on the CPU, in instance order,
    R == 1 included."""
    scatter = scatter or rule_stats_scatter
    if impl in ("auto", "segment"):
        return segment_update_with(scatter, stats, seg, xbin, mom)
    if impl != "onehot":
        raise ValueError(f"unknown stats impl {impl!r} (auto, segment or "
                         "onehot)")
    if stats.device.type == "cpu":
        return rule_stats_ref(stats, seg, xbin, mom)
    return scatter(stats, seg, xbin, mom)


def batch_sum(vals, shape=None, *, scatter=None):
    """``vals`` [N, K] summed over its rows -> [K], in the order XLA on the
    CPU sums a whole array of ``shape`` (default ``(N,)``): what the JAX
    package's ``x.sum()`` gives, for K such columns at once."""
    return batch_sum_with(scatter or segment_sum, vals, shape)


def batch_sum_tenant(vals, shape=None, *, scatter=None):
    """``batch_sum`` of each tenant: ``vals`` [F, N, K] -> [F, K], each
    tenant's N rows in XLA's CPU order of a whole array of ``shape``
    (default ``(N,)``); one ``segment_sum_tenant`` launch a level of
    windows for all F tenants."""
    return batch_sum_tenant_with(scatter or segment_sum_tenant, vals, shape)


__all__ = ["MAX_COLUMNS", "MAX_MOMENTS", "batch_sum", "batch_sum_tenant",
           "rule_moments", "rule_stats_scatter", "rule_stats_update",
           "segment_sum", "segment_sum_tenant"]
