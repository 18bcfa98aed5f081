"""Tensorized streaming Hoeffding tree (VFDT), capacity-bounded, in PyTorch.

Port of ``repro/ml/htree.py``.  The tree is a set of dense tensors: a node
pool of ``max_nodes``, binary threshold splits over *binned* attribute
values, and the sufficient statistics n_ijk as one tensor

    stats[node, attr, bin, class]

whose attribute axis is the paper's vertical-parallelism axis.  State is a
plain dict of tensors with the JAX package's keys and dtypes (f32, i32,
bool), so the two can be compared leaf by leaf.

Three kernels carry the module: ``tree_route`` (``route``/``predict``),
``vht_stats`` (``update_stats``) and ``split_gain`` (``split_gains``).  On
a CUDA tensor each launches its hand-written kernel; on a CPU tensor it
runs its plain version.

The step's functions (``route``, ``predict``, ``update_stats``,
``decide_splits``, ``apply_splits``) also take F trees stacked on a
leading axis, each with its own micro-batch (``xbin`` [F, B, m]): a
fleet's tenants, the members of an ensemble.  Every kernel then launches
once for all F trees (``tree_route``'s batched form; ``vht_stats`` and
``split_gain`` over the node pools flattened to [F * N], see ``fold``),
and row f of the result is tree f's own, bit for bit.

Where the JAX package gates work with ``lax.cond`` (``decide_splits``,
``gated_check``, ``apply_splits``), the port has two forms.  Eagerly it
branches in Python on a value read from the device, so each gate costs one
device-to-host sync.  In a step's capturable form (under
``core.compiled.compile_step``) each gate is a ``compiled.cond``: a
conditional node of the step's CUDA graph, the predicate read on the
device.  The results are those of the ungated code either way.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.core import compiled
from repro_torch.device import resolve_device
from repro_torch.kernels.split_gain.ops import NEG, split_gain
from repro_torch.kernels.tree_route.ops import tree_route, tree_route_batched
from repro_torch.kernels.vht_stats.ops import stats_update

f32 = torch.float32
i32 = torch.int32


@dataclasses.dataclass(frozen=True)
class TreeConfig:
    n_attrs: int
    n_bins: int = 8
    n_classes: int = 2
    max_nodes: int = 255          # odd: root + 2k children
    max_depth: int = 24
    n_min: int = 200              # grace period between split attempts
    delta: float = 1e-7           # Hoeffding confidence
    tau: float = 0.05             # tie-break threshold
    split_delay: int = 0          # D engine-steps between decide & apply
    buffer_size: int = 0          # wk(z); 0 = wok when delay>0, local if D=0
    stats_impl: str = "auto"      # the kernel on CUDA, its plain version on CPU
    route_impl: str = "auto"      # the kernel on CUDA, its plain version on CPU
    gate_splits: bool = True      # gate split checks on the grace period
    check_tile: int = 16          # gated check: max due leaves examined via
                                  # gather before falling back to all nodes

    def __post_init__(self):
        for name in ("stats_impl", "route_impl"):
            if getattr(self, name) != "auto":
                raise ValueError(
                    f"{name}={getattr(self, name)!r}: the port has one "
                    "implementation, picked by the tensors' device ('auto')")

    @property
    def range_r(self) -> float:
        return math.log2(max(self.n_classes, 2))


def init_tree(tc: TreeConfig, device=None):
    dev = resolve_device(device)
    N = tc.max_nodes

    def z(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)

    state = {
        "split_attr": torch.full((N,), -1, dtype=i32, device=dev),
        "split_bin": z((N,), i32),
        "children": z((N, 2), i32),
        "stats": z((N, tc.n_attrs, tc.n_bins, tc.n_classes), f32),
        "class_counts": z((N, tc.n_classes), f32),
        "since_attempt": z((N,), f32),
        "n_total": z((N,), f32),
        "depth": z((N,), i32),
        "n_nodes": torch.ones((), dtype=i32, device=dev),
        # pending split feedback (wok / wk(z) staleness emulation)
        "pending": z((N,), torch.bool),
        "pending_attr": z((N,), i32),
        "pending_bin": z((N,), i32),
        "pending_timer": z((N,), i32),
        "n_splits": z((), i32),
    }
    if tc.buffer_size:
        state["buf_x"] = z((tc.buffer_size, tc.n_attrs), i32)
        state["buf_y"] = z((tc.buffer_size,), i32)
        state["buf_valid"] = z((tc.buffer_size,), torch.bool)
        state["buf_n"] = z((), i32)
    return state


def top_k(x, k: int):
    """``jax.lax.top_k`` over the last axis: the k largest values and their
    indices (i32), and among equal values the lower index first.
    ``torch.topk`` promises no order among ties, so this sorts stably."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k].to(i32)


# --------------------------------------------------------------------------
# routing (model aggregator: sort instance to leaf -- Alg. 1 line 1)
# --------------------------------------------------------------------------

def fold(idx, n: int):
    """Indices into each tree's n rows, ``idx`` [F, B] for F trees on a
    leading axis, as indices into their rows flattened to [F * n] (tree
    f's at [f * n, (f + 1) * n)), flattened to [F * B].  One tree's [B]
    indices are returned as they are."""
    if idx.dim() == 1:
        return idx
    off = torch.arange(idx.shape[0], dtype=idx.dtype, device=idx.device)
    return (idx + off[:, None] * n).reshape(-1)


def route(state, xbin, tc: TreeConfig):
    """xbin: [B, m] i32 binned attributes -> leaf ids [B] i32, through the
    ``tree_route`` kernel with one tree; F trees ([F, N] tables), each
    with its own batch (xbin [F, B, m]) -> [F, B], in one launch of its
    batched form."""
    tables = (state["split_attr"], state["split_bin"], state["children"])
    if state["split_attr"].dim() == 1:
        return tree_route(*tables, xbin, max_depth=tc.max_depth)
    return tree_route_batched(*tables, xbin, max_depth=tc.max_depth)


def route_members(trees, xbin, tc: TreeConfig):
    """Route ONE shared micro-batch through M stacked member trees in a
    single ``tree_route`` launch -> leaf ids [M, B]."""
    return tree_route(trees["split_attr"], trees["split_bin"],
                      trees["children"], xbin, max_depth=tc.max_depth)


def vote(trees, leaf, n_classes: int):
    """Each member's class at its leaf (the first of equal counts, as
    ``jnp.argmax``) -> votes [M, B], and the majority over members, the
    lowest class among ties -> pred [B]."""
    C = n_classes
    counts = torch.gather(trees["class_counts"], 1,
                          leaf.long()[:, :, None].expand(-1, -1, C))
    votes = counts.argmax(-1)
    pred = F.one_hot(votes, C).to(f32).sum(0).argmax(-1)
    return votes, pred


def predict(state, xbin, tc: TreeConfig):
    leaf = route(state, xbin, tc)
    lf = leaf.long()
    counts = torch.gather(state["class_counts"], -2,
                          lf[..., None].expand(*lf.shape, tc.n_classes))
    return torch.argmax(counts, dim=-1).to(i32), leaf


# --------------------------------------------------------------------------
# statistics update (LS processors: Alg. 2)
# --------------------------------------------------------------------------

def update_stats(state, leaf, xbin, y, w, tc: TreeConfig):
    """Accumulate n_ijk for a micro-batch.  w: [B] f32 weights (0 = dropped).
    F trees on a leading axis take leaf, y, w [F, B] and xbin [F, B, m]:
    one ``vht_stats`` launch over their statistics viewed as [F * N, m,
    bins, C], the leaves folded (``fold``), and one ``index_add`` a
    counter over the [F * N] pool.

    ``state["stats"]`` is updated IN PLACE by the ``vht_stats`` kernel
    (the JAX package returns a new array); the other counters are new
    tensors in the returned dict.
    """
    C = tc.n_classes
    lf = fold(leaf, tc.max_nodes)
    wf = w.reshape(-1)
    yf = y.reshape(-1)
    stats = state["stats"]
    stats_update(stats.view((-1,) + stats.shape[-3:]), lf,
                 xbin.reshape(lf.shape[0], -1), yf, wf)
    lf = lf.long()
    clsoh = F.one_hot(yf.long(), C).to(f32) * wf[:, None]
    state = dict(state)
    for key, val in (("class_counts", clsoh), ("since_attempt", wf),
                     ("n_total", wf)):
        old = state[key]
        state[key] = old.reshape((-1,) + val.shape[1:]).index_add(
            0, lf, val).view(old.shape)
    return state


def update_stats_members(trees, leaf, xbin, y, w, tc: TreeConfig):
    """``update_stats`` of M stacked member trees on one shared batch:
    leaf, w [M, B] (member m's leaves and weights), xbin [B, m], y [B].

    Each member's ``stats`` is updated IN PLACE by one ``vht_stats`` launch
    (M a step); the counters of all members take one ``index_add`` each,
    over the flattened [M * N] pool."""
    M, N, C = leaf.shape[0], tc.max_nodes, tc.n_classes
    for k in range(M):
        stats_update(trees["stats"][k], leaf[k], xbin, y, w[k])
    flat = fold(leaf, N).long()
    wf = w.reshape(-1)
    clsoh = (F.one_hot(y.long(), C).to(f32)[None] * w[:, :, None]).reshape(-1, C)
    trees = dict(trees)
    trees["class_counts"] = trees["class_counts"].reshape(M * N, C).index_add(
        0, flat, clsoh).reshape(M, N, C)
    for key in ("since_attempt", "n_total"):
        trees[key] = trees[key].reshape(-1).index_add(0, flat, wf).reshape(M, N)
    return trees


# --------------------------------------------------------------------------
# split criterion (LS: Alg. 3 + MA: Alg. 4)
# --------------------------------------------------------------------------

def split_gains(stats, tc: TreeConfig):
    """Information gain for every (node, attr, threshold-bin) through the
    ``split_gain`` kernel: stats [N, m, bins, C] -> gains [N, m, bins]."""
    return split_gain(stats)


def hoeffding_bound(n, tc: TreeConfig):
    # The constant is a Python double rounded once to f32, and the division
    # by 2 max(n, 1) is in f32, in the JAX package's order: a bound that
    # differs in its last bit can flip a split.
    c = tc.range_r ** 2 * math.log(1.0 / tc.delta)
    return torch.sqrt(torch.full_like(n, c) / (2.0 * torch.clamp(n, min=1.0)))


def _decide_splits_impl(state, tc: TreeConfig):
    gains = split_gains(state["stats"], tc)             # [N, m, bins]
    # paper (Alg. 3/4): compare the best TWO ATTRIBUTES -- adjacent bins of
    # one attribute have near-identical gain and would make DeltaG ~ 0
    per_attr = gains.amax(-1)                           # [N, m]
    best_bin_per_attr = gains.argmax(-1)                # [N, m], first max
    top2, idx2 = top_k(per_attr, 2)
    ga, gb = top2[:, 0], top2[:, 1]
    best_attr = idx2[:, 0]
    best_bin = torch.gather(best_bin_per_attr, 1,
                            best_attr.long()[:, None])[:, 0].to(i32)
    eps = hoeffding_bound(state["n_total"], tc)
    is_leaf = state["split_attr"] < 0
    pure = (state["class_counts"] > 0).sum(-1) <= 1
    attempted = state["since_attempt"] >= tc.n_min
    ok = (ga > 0) & ((ga - gb > eps) | (eps < tc.tau))
    depth_ok = state["depth"] < tc.max_depth - 1
    should = is_leaf & attempted & (~pure) & ok & depth_ok & (~state["pending"])
    return should, best_attr, best_bin


_DECIDE_KEYS = ("stats", "n_total", "split_attr", "class_counts",
                "since_attempt", "depth", "pending")


def due_topk(due, score, k):
    """Indices of up to k due rows, highest score first.  Non-due rows
    score -1 so they rank last; when fewer than k rows are due the filler
    rows MUST be masked out again by the caller's attempted/due test."""
    return top_k(torch.where(due, score, -1.0), k)[1]


def child_counts_from_stats(stats, best_attr, best_bin):
    """Left/right child class distributions for the chosen (attr, bin)
    thresholds, from the cumsum over the bin axis of the chosen attribute.
    stats: [R, m, bins, C]; best_attr/best_bin: [R] -> ([R, C], [R, C])."""
    rows = torch.arange(stats.shape[0], device=stats.device)
    cum = torch.cumsum(stats[rows, best_attr.long().clamp(min=0)], dim=1)
    left = cum[rows, best_bin.long().clamp(min=0)]
    right = cum[:, -1] - left
    return left, right


def gather_decide_tile(flat_state, due, k, tc: TreeConfig,
                       with_children=False):
    """Gather up to k due rows of a node pool (top-k on the grace counter)
    and run the split decision on just that tile.  Returns (idx, should_k,
    attr_k, bin_k), plus the gathered rows' child class distributions when
    ``with_children``.  Filler rows (fewer than k due) fail the attempted
    test, so their should_k is always False."""
    idx = due_topk(due, flat_state["since_attempt"], k)
    sub = {key: flat_state[key][idx.long()] for key in _DECIDE_KEYS}
    s_k, a_k, b_k = _decide_splits_impl(sub, tc)
    if not with_children:
        return idx, s_k, a_k, b_k
    left_k, right_k = child_counts_from_stats(sub["stats"], a_k, b_k)
    return idx, s_k, a_k, b_k, left_k, right_k


def gated_check(n_due, k, gathered, full, idle, operand):
    """The exact split-check gate shared by decide_splits and the LS
    processor: skip entirely when nothing is due, reduce a gathered row
    tile when the due set fits k, fall back to the full reduction
    otherwise.  In a capturable step, two nested conds on the device, as
    the JAX package nests its lax.conds; eagerly, reading ``n_due`` syncs
    with the device."""
    if compiled.capturable():
        return compiled.cond(
            n_due > 0,
            lambda op: compiled.cond(n_due <= k, gathered, full, op),
            idle, operand)
    n = int(n_due)
    if n <= 0:
        return idle(operand)
    return gathered(operand) if n <= k else full(operand)


def scatter_rows(n, idx, values):
    """A length-n tensor of zeros with ``values`` written at ``idx``."""
    out = torch.zeros((n, *values.shape[1:]), dtype=values.dtype,
                      device=values.device)
    out[idx.long()] = values
    return out


def decide_splits(state, tc: TreeConfig):
    """MA Receive(local_result): top-2 across attributes, Hoeffding test.

    Returns (should_split[N], best_attr[N], best_bin[N]) ([F, N] for F
    trees on a leading axis, whose node pools are checked as one [F * N]
    pool: each row's decision is its own).  With tc.gate_splits the gain
    reduction is gated on the grace period, exactly:

      * no leaf due            -> skip entirely; all-False is exact because
                                  only attempted leaves can split
      * <= check_tile leaves due a tree -> gather just those rows (top-k
                                  on the grace counter) and reduce [K, m,
                                  bins, C] instead of [F * N, m, bins, C]
      * more due than the tile -> fall back to the full reduction
    """
    shape = state["split_attr"].shape
    FN = state["split_attr"].numel()
    pool = {k: state[k].reshape((FN,) + state[k].shape[len(shape):])
            for k in _DECIDE_KEYS}

    def unfold(vals):
        return tuple(v.reshape(shape) for v in vals)

    if not tc.gate_splits:
        return unfold(_decide_splits_impl(pool, tc))
    K = min(tc.check_tile * (FN // tc.max_nodes), FN)
    due = (pool["split_attr"] < 0) & (pool["since_attempt"] >= tc.n_min)
    dev = due.device

    def gathered(st):
        idx, s_k, a_k, b_k = gather_decide_tile(st, due, K, tc)
        return (scatter_rows(FN, idx, s_k), scatter_rows(FN, idx, a_k),
                scatter_rows(FN, idx, b_k))

    def idle(st):
        return (torch.zeros(FN, dtype=torch.bool, device=dev),
                torch.zeros(FN, dtype=i32, device=dev),
                torch.zeros(FN, dtype=i32, device=dev))

    return unfold(gated_check(due.sum(), K, gathered,
                              lambda st: _decide_splits_impl(st, tc), idle,
                              pool))


def apply_splits(state, split_mask, best_attr, best_bin, tc: TreeConfig,
                 child_counts=None):
    """Replace chosen leaves by split nodes, allocate 2 children each
    (MA Alg. 4 lines 6-10; the 'drop' event = children stats start at 0).

    `child_counts=(left[N, C], right[N, C])` supplies the child class
    distributions directly (the MA processor receives them in the
    local-result event and holds no statistics tensor); otherwise they are
    derived from state["stats"].  With tc.gate_splits the whole rewiring is
    skipped on steps where no leaf splits, the common case in steady state:
    eagerly, one device-to-host sync finds out; in a capturable step a cond
    decides on the device, and only the leaves the rewiring replaces (not
    the statistics, which it clears in place) pass through it."""
    if not tc.gate_splits:
        return _apply_splits_impl(state, split_mask, best_attr, best_bin, tc,
                                  child_counts)
    def split(_):
        st, do = _apply_splits_impl(state, split_mask, best_attr, best_bin,
                                    tc, child_counts)
        return {k: st[k] for k in _SPLIT_KEYS}, do

    def keep(kept):
        return kept, torch.zeros_like(split_mask)

    new, do = compiled.gate(split_mask.any(), split, keep,
                            {k: state[k] for k in _SPLIT_KEYS})
    return {**state, **new}, do


# the leaves _apply_splits_impl replaces (it clears the split leaves'
# statistics in place)
_SPLIT_KEYS = ("split_attr", "split_bin", "children", "class_counts",
               "depth", "since_attempt", "n_nodes", "n_splits")


def _apply_splits_impl(state, split_mask, best_attr, best_bin, tc: TreeConfig,
                       child_counts=None):
    """The rewiring of ``apply_splits``, ungated; F trees on a leading axis
    each split their own leaves from their own node count."""
    N = tc.max_nodes
    rank = torch.cumsum(split_mask.to(i32), -1, dtype=i32) - 1  # [..., N]
    base = state["n_nodes"][..., None]
    room = (base + 2 * (rank + 1)) <= N
    do = split_mask & room
    lchild = base + 2 * rank
    rchild = base + 2 * rank + 1
    n_splits = do.sum(-1, dtype=i32)

    state = dict(state)
    state["split_attr"] = torch.where(do, best_attr, state["split_attr"])
    state["split_bin"] = torch.where(do, best_bin, state["split_bin"])
    state["children"] = torch.where(do[..., None],
                                    torch.stack([lchild, rchild], -1),
                                    state["children"])

    # initialize children class counts from the split distribution
    if child_counts is not None:
        left_cnt, right_cnt = child_counts
    else:
        stats = state["stats"]
        left_cnt, right_cnt = (c.reshape(do.shape + c.shape[1:])
                               for c in child_counts_from_stats(
                                   stats.view((-1,) + stats.shape[-3:]),
                                   best_attr.reshape(-1),
                                   best_bin.reshape(-1)))

    # scratch-row scatter: each tree's rows not splitting all write to its
    # throwaway row N, which is dropped (many writes land there in one call)
    l_idx = fold(torch.where(do, lchild.clamp(0, N - 1), N), N + 1).long()
    r_idx = fold(torch.where(do, rchild.clamp(0, N - 1), N), N + 1).long()

    def set_rows(arr, idx, val):
        tail = arr.shape[do.dim():]
        rows = arr.reshape((-1, N) + tail)
        padded = torch.cat([rows, torch.zeros_like(rows[:, :1])], 1)
        padded.view((-1,) + tail)[idx] = val.reshape((-1,) + tail).to(
            arr.dtype)
        return padded[:, :N].reshape(arr.shape)

    cc = set_rows(state["class_counts"], l_idx, left_cnt)
    state["class_counts"] = set_rows(cc, r_idx, right_cnt)
    child_depth = state["depth"] + 1
    dep = set_rows(state["depth"], l_idx, child_depth)
    state["depth"] = set_rows(dep, r_idx, child_depth)
    # release the split leaf's statistics (drop content event), in place as
    # update_stats does; the MA processor holds no statistics tensor -- its
    # LS peers drop theirs on the broadcast 'drop' event instead
    if "stats" in state:
        state["stats"] = state["stats"].masked_fill_(
            do[..., None, None, None], 0.0)
    state["since_attempt"] = torch.where(do, 0.0, state["since_attempt"])
    state["n_nodes"] = state["n_nodes"] + 2 * n_splits
    state["n_splits"] = state["n_splits"] + n_splits
    return state, do


__all__ = ["NEG", "TreeConfig", "apply_splits", "child_counts_from_stats",
           "decide_splits", "due_topk", "fold", "gated_check",
           "gather_decide_tile", "hoeffding_bound", "init_tree", "predict",
           "route",
           "route_members", "scatter_rows", "split_gains", "top_k",
           "update_stats", "update_stats_members", "vote"]
