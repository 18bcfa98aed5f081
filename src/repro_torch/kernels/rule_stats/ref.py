"""Plain PyTorch versions of the rule-statistics update (mirrors
``repro/kernels/rule_stats/ref.py`` and the segment path of its ``ops.py``),
and XLA's CPU summation order, which the port follows so that its sums
agree with the JAX package's bit for bit.

``rule_stats_scatter_ref`` is the plain version of the kernel: each cell of
``stats`` starts from its old value and adds its instances' moments in
ascending instance order, as XLA's CPU scatter does.  It adds in passes
of distinct cells, so it runs the same way, and deterministically, on any
device.  ``rule_stats_ref`` is the JAX package's one-hot oracle.
``xla_windows`` is XLA's CPU order of a whole-array sum, and
``batch_sum_with`` takes it with a given scatter.  ``segment_sum_tenant_ref``
is the plain version of the kernel's tenant form (F independent segment
sums), and ``batch_sum_tenant_with`` a batch sum per tenant.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

WINDOW = 32     # XLA's CPU tree-reduction window (TreeReductionRewriter)


def rule_stats_scatter_ref(stats, seg, xbin, mom):
    """stats: [R, m, bins, C] f32; seg: [B] i32; xbin: [B, m] i32; mom:
    [B, C] f32.  ``stats[seg_i, j, xbin_ij] += mom[i]`` for i = 0, 1, ...
    in that order, in place; rows outside [0, R) and bins outside
    [0, bins) are dropped.  Returns ``stats``.

    Each (instance, attribute) entry gets its rank among the entries of its
    cell (a stable sort by cell keeps instance order within a cell); pass k
    adds the moments of every entry of rank k, one per cell, so the passes
    are as many as the fullest cell's instances, not B."""
    R, m, nb, C = stats.shape
    seg = seg.long()[:, None]
    xb = xbin.long()
    keep = (seg >= 0) & (seg < R) & (xb >= 0) & (xb < nb)          # [B, m]
    cells = ((seg * m + torch.arange(m, device=stats.device)) * nb + xb)[keep]
    if cells.numel() == 0:
        return stats
    inst = torch.nonzero(keep)[:, 0]          # row-major: instance order
    cells, order = torch.sort(cells, stable=True)
    inst = inst[order]
    pos = torch.arange(cells.numel(), device=stats.device)
    first = torch.ones_like(cells, dtype=torch.bool)
    first[1:] = cells[1:] != cells[:-1]
    rank = pos - torch.cummax(torch.where(first, pos, 0), 0).values
    by_rank = torch.argsort(rank, stable=True)
    counts = torch.bincount(rank).tolist()
    flat = stats.view(-1, C)
    for sel in torch.split(by_rank, counts):  # distinct cells in each pass
        c = cells[sel]
        flat[c] = flat[c] + mom[inst[sel]]
    return stats


def rule_stats_ref(stats, seg, xbin, mom):
    """The JAX package's one-hot oracle: the dense [B, m, bins, C] product
    of the bin one-hot and the moments, scatter-added by segment through a
    scratch row (seg == R drops the instance).  Returns a new tensor."""
    R, m, nb, C = stats.shape
    xb, seg = xbin.long(), seg.long()
    xb = torch.where((xb >= 0) & (xb < nb), xb, nb)       # one-hot of nothing
    binoh = F.one_hot(xb, nb + 1)[..., :nb].to(stats.dtype)
    val = binoh[..., None] * mom[:, None, None, :]
    seg = torch.where((seg >= 0) & (seg < R), seg, R)      # the scratch row
    ext = torch.cat([stats, stats.new_zeros((1, m, nb, C))])
    return ext.index_add_(0, seg, val)[:R]


def _windows(n):
    """(window count, zeros padded in front) of a summed dimension of n."""
    if n <= WINDOW:
        return 1, 0
    g = -(-n // WINDOW)
    return g, (g * WINDOW - n) // 2


@functools.lru_cache(maxsize=None)
def xla_windows(shape, device):
    """How XLA on the CPU sums a whole array of ``shape`` (a tuple): every
    dimension longer than ``WINDOW`` is cut into windows of ``WINDOW``,
    after padding it to a multiple of that with half the padding (rounded
    down) in front; shorter dimensions are one window.  Each window is
    summed from 0 in row-major order, then the grid of window sums is
    summed the same way, down to one window.  Returns one entry per level:
    (the window id of each of its elements in row-major order, i32; zero
    bins for them, i32 [n, 1]; the window count).  Cached: the tensors are
    shared and must not be written."""
    levels = []
    while True:
        ids = torch.zeros((), dtype=torch.long, device=device)
        grid = []
        for n in shape:
            g, lo = _windows(n)
            ids = ids[..., None] * g + (torch.arange(n, device=device)
                                        + lo) // WINDOW
            grid.append(g)
        ids = ids.reshape(-1).to(torch.int32)
        levels.append((ids, torch.zeros((ids.numel(), 1), dtype=torch.int32,
                                        device=device), math.prod(grid)))
        if levels[-1][2] == 1:
            return tuple(levels)
        shape = tuple(grid)


def batch_sum_with(scatter, vals, shape=None):
    """The sum of ``vals`` [N, K] over its N rows -> [K], in the order XLA
    on the CPU sums a whole array of ``shape`` (row-major, N elements;
    default ``(N,)``) holding one column.  Each level of windows is one
    ``scatter`` into zeros with the window id as the row."""
    N, K = vals.shape
    shape = tuple(shape) if shape is not None else (N,)
    if math.prod(shape) != N:
        raise ValueError(f"shape {shape} does not hold {N} elements")
    for ids, xb, n_win in xla_windows(shape, vals.device):
        vals = scatter(vals.new_zeros((n_win, 1, 1, K)), ids, xb,
                       vals).view(n_win, K)
    return vals.view(K)


def segment_update_with(scatter, stats, seg, xbin, mom):
    """The JAX package's segment path (``rule_stats_update_segment``) with
    ``scatter`` as its element scatter.  For R > 1 it is the scatter.  For
    R == 1 (a default-rule tensor) the JAX package sums the batch's masked
    moments with a reduction over the batch and adds the sum to ``stats``;
    so does this, in XLA's order: the first level of windows by
    ``scatter``, the window sums by ``batch_sum_with`` and the plain
    scatter: their m * bins * C columns pass the kernel's limit of 4096
    (``ops.MAX_COLUMNS``) from 171 attributes on at 8 bins and 3 moments,
    where the kernel raises, and the plain scatter takes any width.
    Updates ``stats`` in place and returns it."""
    R, m, nb, C = stats.shape
    if R != 1:
        return scatter(stats, seg, xbin, mom)
    (ids, _, n_win), *_ = xla_windows((seg.shape[0],), seg.device)
    wseg = torch.where(seg == 0, ids, n_win).to(torch.int32)   # n_win drops
    parts = scatter(stats.new_zeros((n_win, m, nb, C)), wseg, xbin, mom)
    stats[0] = stats[0] + batch_sum_with(rule_stats_scatter_ref,
                                         parts.view(n_win, -1)).view(m, nb, C)
    return stats


def segment_sum_tenant_ref(out, seg, vals):
    """out: [F, S, C] f32; seg: [F * B] i32, tenant f's rows at [f * B,
    (f + 1) * B) with segment ids in [0, S) (others are dropped); vals:
    [F * B, C] f32.  ``out[f, seg_i] += vals[i]`` for each tenant's rows
    in instance order, in place; returns ``out``.

    The per-tenant scatters of ``rule_stats_scatter_ref`` composed into
    one: tenant f's segment s becomes row f * S + s of [F * S] rows (a
    dropped row, row F * S, which the scatter drops too).  Each cell gets
    its own tenant's rows, in instance order, as a scatter per tenant
    would add them."""
    F, S, C = out.shape
    n = seg.shape[0]
    if F * S == 0 or n == 0:
        return out
    s = seg.long().view(F, n // F)
    ok = (s >= 0) & (s < S)
    rows = s + torch.arange(F, device=seg.device)[:, None] * S
    flat = torch.where(ok, rows, F * S).reshape(-1).to(torch.int32)
    zero = torch.zeros((n, 1), dtype=torch.int32, device=seg.device)
    rule_stats_scatter_ref(out.view(F * S, 1, 1, C), flat, zero, vals)
    return out


@functools.lru_cache(maxsize=None)
def tenant_windows(shape, n_tenants, device):
    """``xla_windows(shape)``'s levels for ``n_tenants`` tenants at once:
    each level's window ids repeated for every tenant (i32 [F * n]) and
    its window count.  Cached: the tensors are shared and must not be
    written."""
    return tuple((ids.repeat(n_tenants), n_win)
                 for ids, _, n_win in xla_windows(shape, device))


def batch_sum_tenant_with(scatter, vals, shape=None):
    """Each tenant's ``batch_sum_with``: ``vals`` [F, N, K] summed over
    its N rows -> [F, K], each tenant's rows in the order XLA on the CPU
    sums a whole array of ``shape`` (default ``(N,)``).  Each level of
    windows is one tenant-form ``scatter`` into zeros for all tenants."""
    F, N, K = vals.shape
    shape = tuple(shape) if shape is not None else (N,)
    if math.prod(shape) != N:
        raise ValueError(f"shape {shape} does not hold {N} elements")
    vals = vals.reshape(F * N, K)
    for ids, n_win in tenant_windows(shape, F, vals.device):
        vals = scatter(vals.new_zeros((F, n_win, K)), ids,
                       vals).view(F * n_win, K)
    return vals.view(F, K)
