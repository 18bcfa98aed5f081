"""Distributed CluStream (paper section 5): online micro-clusters + periodic
micro-batch macro-clustering, in PyTorch.

Port of ``repro/ml/clustream.py``.  Micro-clusters are cluster-feature
vectors CF = (n, LS, SS, LT, ST) kept as dense tensors [K, ...].  Online
phase: each instance joins its nearest micro-cluster if within the RMS
radius boundary, else replaces the stalest cluster (capacity-bounded: no
dynamic allocation).  Every ``period`` instances a micro-batch k-means over
micro-cluster centroids produces the macro-clusters.

The CF scatter sums by micro-cluster id through the ``rule_stats`` kernel
as ``segment_sum`` (``kernels.rule_stats``): x | x^2 in one launch (2d
columns, the kernel's wide form), 1 | t | t^2 in another, each from zeros
into K + 1 segments (K the discard) and in instance order, as XLA's CPU
scatter adds them; so the CF sums, the counts and every instance's segment
agree with the JAX package bit for bit.  The whole-batch sums (the metric's
squared distances, the k-means' cluster weights) take ``batch_sum``, XLA's
CPU order.  The distance products (``pairwise_d2``'s ``x @ c.T``, the
k-means' ``oh.T @ cent``, the one-hot path's products) are plain float32
products (``torch.matmul``; TF32 stays off on the card), which sum in
another order than XLA's dot: what they feed (the macro centroids, the
metric) agrees within float32 rounding, not bit for bit.  The macro phase
is gated with ``compiled.gate``: a conditional node in a captured step, a
host read eagerly; the step reads nothing else on the host.

The state functions and the step take a leading tenant axis too: a fleet
of F CluStreams (``ml.fleet``) keeps its CF tensors as [F, K, ...], its
clock as [F], and steps them as they are, each segment reduction one
launch of the kernel's tenant form (``segment_sum_tenant``,
``batch_sum_tenant``) for all F tenants.  Each tenant's sums are its own
learner's, in its instance order; the products become batched products
(``torch.matmul`` over the tenant axis).

The JAX package's ``state_sharding`` and its mesh-aware macro gather
(``_active_mesh``) belong to the distributed runtime, which the port does
not have yet.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import prng
from repro_torch.core.compiled import gate
from repro_torch.core.pytree import tree_map
from repro_torch.core.xla_numerics import fma, sqrt
from repro_torch.kernels.rule_stats.ops import (batch_sum, batch_sum_tenant,
                                                segment_sum,
                                                segment_sum_tenant)

f32 = torch.float32
i32 = torch.int32


@dataclasses.dataclass(frozen=True)
class CluStreamConfig:
    n_dims: int
    n_micro: int = 100
    n_macro: int = 5
    radius_factor: float = 2.0
    period: int = 10_000        # macro-clustering trigger (instances)
    kmeans_iters: int = 10
    stats_impl: str = "auto"    # auto | segment (product + segment-sum) |
                                # onehot (broadcast + one-hot product)
    macro_impl: str = "step"    # step (gated inside every step) |
                                # boundary (the k-means in the chunk-
                                #   boundary hook; fires on the first
                                #   boundary after each period crossing --
                                #   align period to chunk_len * batch for
                                #   step-mode-equivalent trigger points)


def _impl(cc: CluStreamConfig) -> str:
    if cc.stats_impl == "auto":
        return "segment"
    if cc.stats_impl not in ("segment", "onehot"):
        raise ValueError(f"unknown stats impl {cc.stats_impl!r}")
    return cc.stats_impl


def _macro_impl(cc: CluStreamConfig) -> str:
    if cc.macro_impl not in ("step", "boundary"):
        raise ValueError(f"unknown macro impl {cc.macro_impl!r}")
    return cc.macro_impl


def init_clustream(cc: CluStreamConfig, key, init_x=None):
    """The CF state of K micro-clusters seeded at ``uniform(key, (K, d))``
    (JAX's draws, on the key's device) or at the first K rows of
    ``init_x``."""
    K, d = cc.n_micro, cc.n_dims
    centers = prng.uniform(key, (K, d)) if init_x is None else init_x[:K]
    dev = centers.device
    # seed with a generous per-cluster variance so cold clusters absorb
    # their neighbourhood instead of starving (radius ~ 0.3*sqrt(d))
    var0 = 0.1
    return {
        "n": torch.ones((K,), dtype=f32, device=dev) * 1e-3,
        "ls": centers * 1e-3,
        "ss": (torch.square(centers) + var0) * 1e-3,
        "lt": torch.zeros((K,), dtype=f32, device=dev),
        "st": torch.zeros((K,), dtype=f32, device=dev),
        "t": torch.zeros((), dtype=f32, device=dev),
    }


def _centroids(state):
    return state["ls"] / torch.clamp(state["n"][..., None], min=1e-9)


def _radius(state):
    n = torch.clamp(state["n"], min=1e-9)[..., None]
    mean = state["ls"] / n
    # XLA contracts ss/n - mean^2 into one fused multiply-add
    var = torch.clamp(fma(-mean, mean, state["ss"] / n), min=0.0)
    return sqrt(var.sum(-1))


def pairwise_d2(x, c, impl: str = "segment"):
    """[B, K] squared distances ([F, B, K] for a tenant axis).  The
    segment path is one [B, d] x [d, K] product plus rank-1 norms; the
    onehot path materializes the [B, K, d] broadcast difference."""
    if impl == "onehot":
        return torch.square(x[..., :, None, :] - c[..., None, :, :]).sum(-1)
    d2 = (torch.square(x).sum(-1)[..., :, None]
          + torch.square(c).sum(-1)[..., None, :]
          - (2.0 * x) @ c.transpose(-1, -2))
    return torch.clamp(d2, min=0.0)


def _one_hot(idx, n):
    """``jax.nn.one_hot(idx, n, dtype=f32)``: a comparison, which reads
    nothing on the host (``F.one_hot`` checks its range there)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(f32)


def _segment_sums(seg, vals, K):
    """``jax.ops.segment_sum(vals, seg, K + 1)[:K]`` for [B, C] vals: each
    segment's rows summed from zero in instance order (the kernel).  With
    a tenant axis (seg [F, B], vals [F, B, C]) each tenant's own, in one
    launch of the tenant form -> [F, K, C]."""
    if seg.dim() == 2:
        F, B, C = vals.shape
        out = vals.new_zeros((F, K + 1, C))
        return segment_sum_tenant(out, seg.reshape(F * B),
                                  vals.reshape(F * B, C))[:, :K]
    B, C = vals.shape
    out = vals.new_zeros((K + 1, 1, 1, C))
    zero = torch.zeros((B, 1), dtype=i32, device=vals.device)
    return segment_sum(out, seg, zero, vals.contiguous()).view(K + 1, C)[:K]


def _batch_sum(vals):
    """``batch_sum`` of [N, K] vals, or of each tenant's [F, N, K]."""
    return batch_sum(vals) if vals.dim() == 2 else batch_sum_tenant(vals)


def _cf_scatter(state, x, t, seg, cc: CluStreamConfig):
    """Accumulate CF moments (n, LS, SS, LT, ST) by micro-cluster id.
    seg: [B] i32 in [0, K] with K = discard (outside every radius)."""
    K, d = cc.n_micro, cc.n_dims
    state = dict(state)
    if _impl(cc) == "onehot":
        oh = _one_hot(seg, K + 1)[..., :K]
        ohT = oh.transpose(-1, -2)
        state["n"] = state["n"] + oh.sum(-2)       # sums of 0 and 1: exact
        state["ls"] = state["ls"] + ohT @ x
        state["ss"] = state["ss"] + ohT @ torch.square(x)
        state["lt"] = state["lt"] + (ohT @ t[..., None])[..., 0]
        state["st"] = state["st"] + (ohT @ torch.square(t)[..., None])[..., 0]
        return state
    moments = _segment_sums(seg, torch.cat([x, torch.square(x)], -1), K)
    times = _segment_sums(seg, torch.stack(
        [torch.ones_like(t), t, torch.square(t)], -1), K)
    state["n"] = state["n"] + times[..., 0]
    state["ls"] = state["ls"] + moments[..., :d]
    state["ss"] = state["ss"] + moments[..., d:]
    state["lt"] = state["lt"] + times[..., 1]
    state["st"] = state["st"] + times[..., 2]
    return state


def update(state, x, cc: CluStreamConfig):
    """Online phase for a micro-batch x: [B, d] (or [F, B, d], a batch
    per tenant of a state with a tenant axis)."""
    B = x.shape[-2]
    impl = _impl(cc)
    d2 = pairwise_d2(x, _centroids(state), impl)               # [B, K]
    nearest = torch.argmin(d2, -1)
    ndist = sqrt(torch.gather(d2, -1, nearest[..., None])[..., 0])
    rad = torch.gather(_radius(state), -1, nearest) * cc.radius_factor + 1e-6
    absorb = ndist <= rad

    t = state["t"][..., None] + torch.arange(1, B + 1, dtype=f32,
                                             device=x.device)
    K = cc.n_micro
    seg = torch.where(absorb, nearest, K).to(i32)
    state = _cf_scatter(state, x, t, seg, cc)

    # non-absorbed instances replace the stalest micro-clusters (batch: the
    # first such instance wins; capacity-bounded replacement)
    stale = state["lt"] / torch.clamp(state["n"], min=1e-9)
    victim = torch.argmin(stale, -1)
    new = ~absorb
    first_new = torch.argmax(new.to(torch.uint8), -1)[..., None]
    any_new = new.any(-1)
    xn = torch.gather(x, -2, first_new[..., None].expand(
        *first_new.shape, x.shape[-1]))                     # [1, d]
    tn = torch.gather(t, -1, first_new)                     # [1]
    hit = ((torch.arange(K, device=x.device) == victim[..., None])
           & any_new[..., None])

    def repl(arr, val):
        return torch.where(hit.view(hit.shape + (1,) * (arr.dim()
                                                        - hit.dim())),
                           val, arr)

    state["n"] = repl(state["n"], torch.ones((), dtype=f32, device=x.device))
    state["ls"] = repl(state["ls"], xn)
    state["ss"] = repl(state["ss"], torch.square(xn))
    state["lt"] = repl(state["lt"], tn)
    state["st"] = repl(state["st"], torch.square(tn))
    state["t"] = state["t"] + B
    return state


def macro_cluster(state, cc: CluStreamConfig, key=None):
    """Micro-batch phase: weighted k-means over micro-cluster centroids,
    ``kmeans_iters`` rounds from the ``n_macro`` heaviest (each tenant's
    own, for a state with a tenant axis)."""
    impl = _impl(cc)
    cent = _centroids(state)
    w = state["n"]
    k = cc.n_macro
    top = torch.argsort(-w, dim=-1, stable=True)[..., :k]
    c = torch.gather(cent, -2, top[..., None].expand(*top.shape,
                                                     cent.shape[-1]))
    for _ in range(cc.kmeans_iters):
        a = torch.argmin(pairwise_d2(cent, c, impl), -1)       # [K]
        oh = _one_hot(a, k) * w[..., None]
        tot = _batch_sum(oh)                                   # [k]
        newc = ((oh.transpose(-1, -2) @ cent)
                / torch.clamp(tot[..., None], min=1e-9))
        c = torch.where(tot[..., None] > 0, newc, c)
    return c


def merge(states):
    """Merge shard-local micro-cluster states (distributed reduction).

    Every CF field is additive across disjoint stream shards, the clock
    ``t`` included.  The ``macro`` centroids (and ``macro_t``) are not;
    they are taken from the first shard, and callers re-run
    ``macro_cluster`` on the merged CF state."""
    non_additive = ("macro", "macro_t")
    cf = [{k: v for k, v in s.items() if k not in non_additive}
          for s in states]
    out = tree_map(lambda *xs: sum(xs[1:], xs[0]), *cf)
    for k in non_additive:
        if k in states[0]:
            out[k] = states[0][k]
    return out


def assign(centers, x):
    return torch.argmin(pairwise_d2(x, centers), -1)


def ssq(centers, x):
    """The batch's sum of squared distances to the nearest center, summed
    in XLA's CPU order (each tenant's, for a tenant axis)."""
    return _batch_sum(torch.amin(pairwise_d2(x, centers), -1)[..., None])[
        ..., 0]


class CluStream:
    """CluStream learner: a state of CF tensors, the latest macro centroids
    and ``macro_t`` (the clock at their computation), and a step whose
    metrics are the batch's sum of squared distances to the macro
    centroids, its size and the active micro-clusters.

    With ``macro_impl="step"`` the k-means is gated inside every step on a
    period crossing.  With ``"boundary"`` the step has no k-means, and the
    ``boundary`` hook (present in that mode only) recomputes the macro
    centroids between chunks, on the first boundary after each period
    crossing: only a chunked driver fires it."""

    def __init__(self, cc: CluStreamConfig, device=None):
        self.cc = cc
        self.device = device
        if _macro_impl(cc) == "boundary":
            self.boundary = self._boundary

    def init(self, key=None):
        """The state from ``key`` (default ``prng.PRNGKey(0)`` on the
        learner's device); it lies on the key's device."""
        key = prng.PRNGKey(0, self.device) if key is None else key
        state = init_clustream(self.cc, key)
        state["macro"] = _centroids(state)[: self.cc.n_macro]
        state["macro_t"] = torch.zeros((), dtype=f32, device=key.device)
        return state

    def step(self, state, x):
        cc = self.cc
        t0 = state["t"]
        state = dict(state)
        macro_prev = state.pop("macro")
        macro_t_prev = state.pop("macro_t")
        state = update(state, x, cc)
        if _macro_impl(cc) == "step":
            crossed = (torch.div(t0, cc.period, rounding_mode="floor")
                       != torch.div(state["t"], cc.period,
                                    rounding_mode="floor"))
            state["macro"], state["macro_t"] = self._macro(
                crossed, state, macro_prev, macro_t_prev)
        else:
            state["macro"], state["macro_t"] = macro_prev, macro_t_prev
        metrics = {"seen": torch.full(x.shape[:-2], float(x.shape[-2]),
                                      dtype=f32, device=x.device),
                   "ssq": ssq(state["macro"], x),
                   "n_active": (state["n"] >= 1.0).to(f32).sum(-1)}
        return state, metrics

    def _macro(self, crossed, state, prev, prev_t):
        """(macro, macro_t): recomputed where the clock crossed a period,
        ``prev`` and ``prev_t`` elsewhere.  The k-means is gated on any
        crossing; with a tenant axis (``crossed`` [F]) it runs for all
        tenants and each crossed tenant takes its own result."""
        cc = self.cc

        def recompute(s):
            return (torch.where(crossed[..., None, None],
                                macro_cluster(s, cc), prev),
                    torch.where(crossed, s["t"], prev_t))

        return gate(crossed.any(), recompute, lambda s: (prev, prev_t),
                    state)

    def _boundary(self, state):
        """Chunk-boundary phase (exposed as ``self.boundary`` in boundary
        mode only): recompute the macro centroids iff a period boundary
        was crossed since the last macro."""
        cc = self.cc
        state = dict(state)
        crossed = (torch.div(state["t"], cc.period, rounding_mode="floor")
                   != torch.div(state["macro_t"], cc.period,
                                rounding_mode="floor"))
        state["macro"], state["macro_t"] = self._macro(
            crossed, state, state["macro"], state["macro_t"])
        return state

    def run(self, state, x_stream):
        """Every micro-batch of ``x_stream`` ([T, B, d]) in order: (final
        state, metrics stacked to [T]), the JAX package's scan.  Boundary
        mode refuses it: its macro centroids would never move."""
        if _macro_impl(self.cc) == "boundary":
            raise ValueError(
                "macro_impl='boundary' never fires inside a plain scan "
                "(the macro centroids would stay frozen at init): run "
                "through an engine's chunked driver, or use "
                "macro_impl='step'")
        metrics = []
        for x in x_stream:
            state, m = self.step(state, x)
            metrics.append(m)
        return state, {k: torch.stack([m[k] for m in metrics])
                       for k in metrics[0]}


__all__ = ["CluStream", "CluStreamConfig", "assign", "init_clustream",
           "macro_cluster", "merge", "pairwise_d2", "ssq", "update"]
