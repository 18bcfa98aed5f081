"""Adaptive Model Rules (paper section 7): MAMR, VAMR and HAMR, in PyTorch.

Port of ``repro/ml/amrules.py`` (all but ``state_sharding``, which comes
with the distribution slice).  The rule model is tensorized and bounded:
up to R rules of up to F (attribute, op, threshold-bin) predicates, a head
per rule (the mean target of the instances it covered), the per-rule
target moments (count, sum, sum of squares) per (attribute, bin) that
expansions are decided on, and a default rule for what no rule covers;
expanding the default rule creates a new rule.  Expansion: the
standard-deviation reduction (SDR) of the two best attributes under the
Hoeffding bound.  Page-Hinkley on each rule's absolute error evicts
drifted rules.  Ordered rules: the first covering rule predicts and
trains.

  MAMR -- ``AMRules``: the sequential reference.
  VAMR -- rule statistics keyed by rule id; expansion feedback delayed.
  HAMR -- ``replicas`` aggregators each take 1/replicas of the batch
          against the same rule set; one central default-rule learner.

Every float sum on the path follows the JAX package's order on the CPU, so
that the port learns the same rules bit for bit: the moment statistics
(``rule_stats_scatter``) and the per-rule segment sums (``segment_sum``)
go through the ``rule_stats`` kernel, which adds in instance order as
XLA's CPU scatter does, and the whole-batch sums through ``batch_sum``,
which takes XLA's CPU reduction order on the same kernel.  No sum on
the path uses atomics, so two runs of a stream on the card are identical.
The ``lax.cond`` gates of the expansion checks are Python ``if``s on a
value read from the device in the eager step, and ``compiled.cond``s (a
conditional node of the step's CUDA graph) in its capturable form, under
``core.compiled.compile_step``.  ``step`` leaves the state it is given as
it was.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core import compiled
from repro_torch.core.xla_numerics import cumsum, fma
from repro_torch.device import resolve_device
from repro_torch.kernels.rule_stats.ops import (batch_sum, rule_moments,
                                                rule_stats_scatter,
                                                rule_stats_update,
                                                segment_sum)
from repro_torch.ml.detectors import DetectorBank, PhEmaConfig
from repro_torch.ml.htree import top_k

f32 = torch.float32
i32 = torch.int32
BIG = 1e30

# moment-axis layout of the statistics tensor [R, m, bins, 3]
CNT, SUM, SQ = 0, 1, 2


@dataclasses.dataclass(frozen=True)
class RulesConfig:
    n_attrs: int
    n_bins: int = 8
    max_rules: int = 64
    max_feats: int = 8
    n_min: int = 200          # expansion grace period
    delta: float = 1e-7
    tau: float = 0.05
    ph_lambda: float = 35.0   # Page-Hinkley threshold
    ph_alpha: float = 0.005
    delay: int = 0            # expansion feedback staleness (VAMR/HAMR)
    stats_impl: str = "auto"  # auto (= segment: the kernel) | onehot (oracle)
    gate_expansions: bool = True  # gate the SDR checks on the grace period
    detector_impl: str = "bank"   # bank (packed DetectorBank) | inline

    def __post_init__(self):
        if self.stats_impl not in ("auto", "segment", "onehot"):
            raise ValueError(f"stats_impl={self.stats_impl!r}: the port has "
                             "'auto' (= 'segment', the kernel) and 'onehot'")
        if self.detector_impl not in ("bank", "inline"):
            raise ValueError(f"unknown detector impl {self.detector_impl!r}")

    @property
    def eps_n(self):
        return math.log(1.0 / self.delta) / 2.0


def init_rules(rc: RulesConfig, device=None):
    dev = resolve_device(device)
    R, F_, m, nb = rc.max_rules, rc.max_feats, rc.n_attrs, rc.n_bins

    def z(shape, dtype=f32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return {
        "active": z((R,), torch.bool),
        "pred_attr": z((R, F_), i32),
        "pred_op": z((R, F_), i32),        # 0: <= thr, 1: > thr
        "pred_bin": z((R, F_), i32),
        "pred_valid": z((R, F_), torch.bool),
        "head_n": z((R,)),
        "head_sum": z((R,)),
        "since": z((R,)),
        # (cnt, sum, sumsq) target moments per (rule, attr, bin)
        "stats": z((R, m, nb, 3)),
        # default rule
        "d_stats": z((m, nb, 3)),
        "d_n": z(()),
        "d_sum": z(()),
        "d_since": z(()),
        # Page-Hinkley per rule
        "ph_m": z((R,)),
        "ph_min": z((R,)),
        "ph_err": z((R,)),
        "n_rules": z((), i32),
        "n_created": z((), i32),
        "n_removed": z((), i32),
        "n_feats": z((), i32),
        # delayed expansion feedback buffers
        "pend_rule_valid": z((R,), torch.bool),
        "pend_attr": z((R,), i32),
        "pend_op": z((R,), i32),
        "pend_bin": z((R,), i32),
        "pend_timer": z((R,), i32),
    }


def _one_hot(x, n, dtype):
    """``jax.nn.one_hot``: a row of zeros for an index outside [0, n)."""
    return (x[..., None] == torch.arange(n, device=x.device)).to(dtype)


def coverage(state, xbin, rc: RulesConfig):
    """[B, R] bool: does rule r cover instance b?  A count of violated
    predicates as one [B, m*bins] x [m*bins, R] product against the bin
    one-hot; the counts are small integers, so the product is exact."""
    pa, po, pb, pv = (state["pred_attr"], state["pred_op"],
                      state["pred_bin"], state["pred_valid"])
    B = xbin.shape[0]
    R, m, nb = rc.max_rules, rc.n_attrs, rc.n_bins
    bins = torch.arange(nb, device=xbin.device)
    # maskf[r, f, v]: predicate f of rule r is violated by bin value v
    maskf = torch.where(po[..., None] == 0, bins > pb[..., None],
                        bins <= pb[..., None]) & pv[..., None]
    attr1h = _one_hot(pa, m, f32)                               # [R, F, m]
    viol = torch.einsum("rfa,rfv->rav", attr1h, maskf.to(f32))
    binoh = _one_hot(xbin, nb, f32)                             # [B, m, nb]
    unsat = binoh.reshape(B, m * nb) @ viol.reshape(R, m * nb).T
    return (unsat < 0.5) & state["active"][None]


def first_cover(cov, rc: RulesConfig):
    """Ordered mode: index of the first covering rule, R if none (i32)."""
    R = rc.max_rules
    idx = torch.where(cov, torch.arange(R, dtype=i32, device=cov.device), R)
    return torch.amin(idx, dim=-1)


def _sdr(cnt, sm, sq):
    """Standard-deviation reduction for all (attr, bin) thresholds.
    cnt/sm/sq: [..., m, bins] per-bin target stats.  The differences of
    products are fused multiply-adds, as XLA computes them on the CPU.
    Also returns the count cumsum."""
    c, s, q = cumsum(torch.stack([cnt, sm, sq]))
    ct, st, qt = c[..., -1:], s[..., -1:], q[..., -1:]

    def sd(n, sm_, sq_):
        n = torch.clamp(n, min=1e-9)
        mean = sm_ / n
        var = torch.clamp(fma(-mean, mean, sq_ / n), min=0.0)
        return torch.sqrt(var)

    tot_sd = sd(ct, st, qt)
    left_sd = sd(c, s, q)
    right_sd = sd(ct - c, st - s, qt - q)
    n = torch.clamp(ct, min=1e-9)
    sdr = fma(-((ct - c) / n), right_sd, fma(-(c / n), left_sd, tot_sd))
    valid = (c > 0) & ((ct - c) > 0)
    return torch.where(valid, sdr, -BIG), c


def _expansion_decision(cnt, sm, sq, rc: RulesConfig):
    """Return (expand?, attr, bin, op) from SDR + Hoeffding ratio test.

    Top-2 over ATTRIBUTES; the Hoeffding n is the rule's accumulated
    statistics count.  Ties resolve as ``lax.top_k``'s and ``argmax``'s:
    the lower index first."""
    sdr, c = _sdr(cnt, sm, sq)                    # [..., m, bins]
    per_attr, bin_per_attr = torch.max(sdr, -1)   # first max among ties
    top2, idx2 = top_k(per_attr, 2)
    s1, s2 = top2[..., 0], top2[..., 1]
    attr = idx2[..., 0].long()
    tbin = torch.gather(bin_per_attr, -1, attr[..., None])[..., 0]
    n_seen = torch.amax(cnt.sum(-1), -1)          # integer counts: exact
    eps = torch.sqrt(torch.full_like(n_seen, rc.eps_n)
                     / torch.clamp(n_seen, min=1.0))
    ratio = torch.where(s1 > 0, torch.clamp(s2, min=0.0)
                        / torch.clamp(s1, min=1e-9), 1.0)
    ok = (s1 > 0) & ((ratio + eps < 1.0) | (eps < rc.tau))
    # keep the branch with more mass (documented simplification)
    nb = c.shape[-1]
    sel_c = torch.gather(c, -2, attr[..., None, None].expand(
        *attr.shape, 1, nb))[..., 0, :]
    sel = torch.gather(sel_c, -1, tbin[..., None])[..., 0]
    tot = sel_c[..., -1]
    op = torch.where(sel >= tot - sel, 0, 1).to(i32)   # 0: keep <=, 1: keep >
    return ok, attr.to(i32), tbin.to(i32), op


class AMRules:
    """Sequential reference (MAMR) and the shared mechanics."""

    def __init__(self, rc: RulesConfig, device=None):
        self.rc = rc
        self.device = device
        # per-rule Page-Hinkley as a packed DetectorBank (ph_ema family);
        # its state lives in the flat ph_m/ph_min/ph_err keys
        self._ph = DetectorBank(
            "ph_ema", rc.max_rules,
            PhEmaConfig(alpha=rc.ph_alpha, lam=rc.ph_lambda), device=device)

    def init(self, key=None):
        return init_rules(self.rc, self.device)

    # ------------------------------------------------------------- step

    def step(self, state, xbin, y):
        """Prequential step.  xbin: [B, m] i32 bins; y: [B] f32 targets."""
        rc = self.rc
        R = rc.max_rules
        cov = coverage(state, xbin, rc)
        first = first_cover(cov, rc)                       # [B]
        covered = first < R
        head_mean = state["head_sum"] / torch.clamp(state["head_n"], min=1.0)
        d_mean = state["d_sum"] / torch.clamp(state["d_n"], min=1.0)
        pred = torch.where(covered, head_mean[torch.clamp(first, max=R - 1)],
                           d_mean)
        err = y - pred
        abs_err = torch.abs(err)

        state = dict(state)
        # ---- update covered rules' head + stats (scatter by rule id) ----
        ridx = torch.where(covered, first, R)
        sums = self._segment_sums(ridx, torch.ones_like(y), y, abs_err)
        cnt = sums[:R, 0]
        state["head_n"] = state["head_n"] + cnt
        state["head_sum"] = state["head_sum"] + sums[:R, 1]
        state["since"] = state["since"] + cnt
        mom = rule_moments(y)                                # [B, 3]
        state = self._scatter_stats(state, covered, first, xbin, mom)

        # ---- default rule head with uncovered instances ------------------
        w = (~covered).to(f32)
        tot = batch_sum(torch.stack([w, w * y, abs_err, torch.square(err)],
                                    -1), scatter=segment_sum)
        state["d_n"] = state["d_n"] + tot[0]
        state["d_sum"] = state["d_sum"] + tot[1]
        state["d_since"] = state["d_since"] + tot[0]

        # ---- Page-Hinkley drift eviction (packed detector bank) ----------
        rule_err = sums[:R, 2] / torch.clamp(cnt, min=1.0)
        has = cnt > 0
        if rc.detector_impl == "bank":
            ph, raw = self._ph.update(self._ph_view(state), rule_err, has=has)
            state["ph_m"], state["ph_min"], state["ph_err"] = \
                ph["m"], ph["min"], ph["err"]
            drift = state["active"] & raw
        else:
            # the inline formulation -- the bank's parity oracle
            mt = torch.where(has, state["ph_m"] + rule_err - state["ph_err"]
                             - rc.ph_alpha, state["ph_m"])
            err_avg = torch.where(
                has, fma(0.01, rule_err, 0.99 * state["ph_err"]),
                state["ph_err"])
            ph_min = torch.minimum(state["ph_min"], mt)
            drift = state["active"] & (mt - ph_min > rc.ph_lambda)
            state["ph_m"], state["ph_min"], state["ph_err"] = \
                mt, ph_min, err_avg
        state = self._evict(state, drift)

        # ---- expansions (gated on the grace period) ----------------------
        state = self._apply_pending(state)
        state = self._try_expand(state)
        state = self._try_default_expand(state)
        state["n_rules"] = state["active"].sum(dtype=i32)

        metrics = {
            "abs_err": tot[2],
            "sq_err": tot[3],
            "seen": torch.full((), float(y.shape[0]), dtype=f32,
                               device=y.device),
            "n_rules": state["active"].to(f32).sum(),
        }
        return state, metrics

    # ------------------------------------------------------------ pieces

    def _segment_sums(self, ridx, *vals):
        """``jax.ops.segment_sum`` of each of ``vals`` ([B] f32) over the
        R + 1 rows of ``ridx``, in instance order: the rule_stats kernel
        with one attribute and one bin, through ``segment_sum``.  Returns
        [R + 1, len(vals)]."""
        R = self.rc.max_rules
        v = torch.stack(vals, -1)
        out = v.new_zeros((R + 1, 1, 1, v.shape[1]))
        xb = torch.zeros((v.shape[0], 1), dtype=i32, device=v.device)
        return segment_sum(out, ridx, xb, v).view(R + 1, -1)

    def _scatter_stats(self, state, covered, first, xbin, mom):
        """Scatter (w, w*y, w*y^2) into the rule AND default-rule moment
        tensors.  The fused path runs ONE scatter over an [R+1]-row
        extension whose last row is the default rule; stats_impl="onehot"
        keeps the two one-hot updates of the oracle."""
        rc = self.rc
        R = rc.max_rules
        state = dict(state)
        if rc.stats_impl == "onehot":
            ridx = torch.where(covered, first, R)              # R = discard
            state["stats"] = rule_stats_update(
                state["stats"].clone(), ridx, xbin, mom, impl="onehot",
                scatter=rule_stats_scatter)
            d_seg = covered.to(i32)
            state["d_stats"] = rule_stats_update(
                state["d_stats"][None].clone(), d_seg, xbin, mom,
                impl="onehot", scatter=rule_stats_scatter)[0]
            return state
        ext = torch.cat([state["stats"], state["d_stats"][None]], 0)
        seg = torch.where(covered, first, R)                  # R = default row
        ext = rule_stats_update(ext, seg, xbin, mom, impl="segment",
                                scatter=rule_stats_scatter)
        state["stats"], state["d_stats"] = ext[:R], ext[R]
        return state

    def _ph_view(self, state):
        """The per-rule Page-Hinkley state in the DetectorBank's layout."""
        return {"m": state["ph_m"], "min": state["ph_min"],
                "err": state["ph_err"]}

    def _evict(self, state, drift):
        state = dict(state)
        state["active"] = state["active"] & ~drift
        state["pred_valid"] = torch.where(drift[:, None], False,
                                          state["pred_valid"])

        def zero(a):
            return torch.where(drift.reshape((-1,) + (1,) * (a.dim() - 1)),
                               0.0, a)

        for k in ("head_n", "head_sum", "since", "stats"):
            state[k] = zero(state[k])
        # drifted rules' detectors restart from scratch
        ph = self._ph.reset(self._ph_view(state), drift)
        state["ph_m"], state["ph_min"], state["ph_err"] = \
            ph["m"], ph["min"], ph["err"]
        state["n_removed"] = state["n_removed"] + drift.sum(dtype=i32)
        return state

    def _gated_decision(self, stats, gate):
        """The SDR cumsum + top-k over [..., m, bins] runs only when
        ``gate`` holds -- exact, because the caller uses the decision only
        under a mask that is all-False whenever the gate is closed.  The
        eager step reads ``gate`` from the device; the capturable one
        decides it there (``compiled.cond``)."""
        rc = self.rc

        def open_(st):
            return _expansion_decision(st[..., CNT], st[..., SUM],
                                       st[..., SQ], rc)

        def closed(st):
            z = torch.zeros(st.shape[:-3], dtype=i32, device=st.device)
            return z.to(torch.bool), z, z, z

        if not rc.gate_expansions:
            return open_(stats)
        return compiled.gate(gate, open_, closed, stats)

    def _try_expand(self, state):
        """Rules with >= n_min fresh updates attempt an SDR expansion."""
        rc = self.rc
        ready = state["active"] & (state["since"] >= rc.n_min)
        ok, attr, tbin, op = self._gated_decision(state["stats"],
                                                  torch.any(ready))
        room = state["pred_valid"].sum(-1) < rc.max_feats
        expand = ready & ok & room
        state = dict(state)
        state["since"] = torch.where(ready, 0.0, state["since"])
        if rc.delay == 0:
            return self._do_expand(state, expand, attr, tbin, op)
        state["pend_rule_valid"] = state["pend_rule_valid"] | expand
        state["pend_attr"] = torch.where(expand, attr, state["pend_attr"])
        state["pend_op"] = torch.where(expand, op, state["pend_op"])
        state["pend_bin"] = torch.where(expand, tbin, state["pend_bin"])
        state["pend_timer"] = torch.where(expand, rc.delay,
                                          state["pend_timer"])
        return state

    def _apply_pending(self, state):
        rc = self.rc
        if rc.delay == 0:
            return state
        state = dict(state)
        timer = torch.where(state["pend_rule_valid"], state["pend_timer"] - 1,
                            state["pend_timer"])
        mature = state["pend_rule_valid"] & (timer <= 0)
        state["pend_timer"] = timer
        state["pend_rule_valid"] = state["pend_rule_valid"] & ~mature
        return self._do_expand(state, mature, state["pend_attr"],
                               state["pend_bin"], state["pend_op"])

    def _do_expand(self, state, expand, attr, tbin, op):
        rc = self.rc
        state = dict(state)
        F_ = rc.max_feats
        slot = torch.clamp(state["pred_valid"].sum(-1), max=F_ - 1)
        sl_oh = _one_hot(slot, F_, torch.bool) & expand[:, None]
        state["pred_attr"] = torch.where(sl_oh, attr[:, None],
                                         state["pred_attr"])
        state["pred_bin"] = torch.where(sl_oh, tbin[:, None],
                                        state["pred_bin"])
        state["pred_op"] = torch.where(sl_oh, op[:, None], state["pred_op"])
        state["pred_valid"] = state["pred_valid"] | sl_oh
        # expansion resets the rule's statistics (it now covers a subset)
        state["stats"] = torch.where(expand[:, None, None, None], 0.0,
                                     state["stats"])
        state["n_feats"] = state["n_feats"] + expand.sum(dtype=i32)
        return state

    def _try_default_expand(self, state):
        """Default rule expansion creates a NEW rule.  The SDR decision is
        gated on the default rule's own grace period."""
        rc = self.rc
        R, F_ = rc.max_rules, rc.max_feats
        ready = state["d_since"] >= rc.n_min
        ok, attr, tbin, op = self._gated_decision(state["d_stats"][None],
                                                  ready)
        ok, attr, tbin, op = ok[0], attr[0], tbin[0], op[0]
        free = ~state["active"]
        has_free = torch.any(free)
        slot = torch.argmax(free.to(i32))                  # first free slot
        create = ready & ok & has_free
        state = dict(state)
        state["d_since"] = torch.where(ready, 0.0, state["d_since"])
        soh = _one_hot(slot, R, torch.bool) & create
        state["active"] = state["active"] | soh
        f0 = torch.arange(F_, device=soh.device) == 0
        first_pred = soh[:, None] & f0[None]
        state["pred_attr"] = torch.where(first_pred, attr, state["pred_attr"])
        state["pred_bin"] = torch.where(first_pred, tbin, state["pred_bin"])
        state["pred_op"] = torch.where(first_pred, op, state["pred_op"])
        state["pred_valid"] = torch.where(soh[:, None], f0[None],
                                          state["pred_valid"])
        # head seeded from the default rule's mean; fresh stats
        d_mean = state["d_sum"] / torch.clamp(state["d_n"], min=1.0)
        state["head_n"] = torch.where(soh, 1.0, state["head_n"])
        state["head_sum"] = torch.where(soh, d_mean, state["head_sum"])

        def reset(a):
            return torch.where(soh.reshape((-1,) + (1,) * (a.dim() - 1)),
                               0.0, a)

        for k in ("stats", "since", "ph_m", "ph_min", "ph_err"):
            state[k] = reset(state[k])
        # default rule restarts
        for k in ("d_stats", "d_n", "d_sum"):
            state[k] = torch.where(create, 0.0, state[k])
        state["n_created"] = state["n_created"] + create.to(i32)
        return state

    def run(self, state, x_stream, y_stream):
        """Every batch of x_stream [T, B, m] / y_stream [T, B] in turn:
        (final state, metrics stacked on a leading step axis)."""
        return _run(self, state, x_stream, y_stream)


class VAMR(AMRules):
    """Vertical AMRules: statistics keyed by rule id; expansion feedback
    delayed.  Functionally AMRules with delay > 0."""

    def __init__(self, rc: RulesConfig, device=None):
        if rc.delay == 0:
            rc = dataclasses.replace(rc, delay=1)
        super().__init__(rc, device=device)


class HAMR:
    """Hybrid AMRules (paper section 7.2 / Fig. 11): ``replicas`` model
    aggregators each process 1/replicas of the batch against the SAME rule
    set; their statistics updates merge by rule id (one scatter over the
    whole batch, replica by replica); uncovered instances go to ONE central
    default-rule learner, whose expansions reach every aggregator."""

    def __init__(self, rc: RulesConfig, replicas: int = 2, device=None):
        if rc.delay == 0:
            rc = dataclasses.replace(rc, delay=1)
        self.rc = rc
        self.replicas = replicas
        self.device = device
        self._inner = AMRules(rc, device=device)

    def init(self, key=None):
        return init_rules(self.rc, self.device)

    def step(self, state, xbin, y):
        rc = self.rc
        r = self.replicas
        R = rc.max_rules
        B = y.shape[0]
        Bs = (B // r) * r
        flat_x, flat_y = xbin[:Bs], y[:Bs]     # replica q holds rows q*B/r...

        # ---- aggregator phase (per replica, shared rule set) -------------
        head_mean = state["head_sum"] / torch.clamp(state["head_n"], min=1.0)
        d_mean = state["d_sum"] / torch.clamp(state["d_n"], min=1.0)
        flat_first = first_cover(coverage(state, flat_x, rc), rc)
        flat_cov = flat_first < R
        pred = torch.where(flat_cov,
                           head_mean[torch.clamp(flat_first, max=R - 1)],
                           d_mean)
        abse, sqe = torch.abs(flat_y - pred), torch.square(flat_y - pred)

        # ---- learner phase: merge replica updates (key grouping) ---------
        merged = dict(state)
        ridx = torch.where(flat_cov, flat_first, R)
        sums = self._inner._segment_sums(ridx, torch.ones_like(flat_y),
                                         flat_y)
        cnt = sums[:R, 0]
        merged["head_n"] = state["head_n"] + cnt
        merged["head_sum"] = state["head_sum"] + sums[:R, 1]
        merged["since"] = state["since"] + cnt
        mom = rule_moments(flat_y)
        merged = self._inner._scatter_stats(merged, flat_cov, flat_first,
                                            flat_x, mom)

        # ---- centralized default-rule learner (head) ---------------------
        w = (~flat_cov).to(f32)
        tot = batch_sum(torch.stack([w, w * flat_y], -1),
                        scatter=segment_sum)
        merged["d_n"] = state["d_n"] + tot[0]
        merged["d_sum"] = state["d_sum"] + tot[1]
        merged["d_since"] = state["d_since"] + tot[0]

        # ---- shared expansion machinery (delayed broadcast) --------------
        merged = self._inner._apply_pending(merged)
        merged = self._inner._try_expand(merged)
        merged = self._inner._try_default_expand(merged)
        merged["n_rules"] = merged["active"].sum(dtype=i32)

        # the JAX package sums the [replicas, B/replicas] error arrays
        err = batch_sum(torch.stack([abse, sqe], -1), (r, B // r),
                        scatter=segment_sum)
        metrics = {"abs_err": err[0], "sq_err": err[1],
                   "seen": torch.full((), float(Bs), dtype=f32,
                                      device=y.device),
                   "n_rules": merged["active"].to(f32).sum()}
        return merged, metrics

    def run(self, state, x_stream, y_stream):
        return _run(self, state, x_stream, y_stream)


def _run(learner, state, x_stream, y_stream):
    metrics = []
    for x, y in zip(x_stream, y_stream):
        state, m = learner.step(state, x, y)
        metrics.append(m)
    if not metrics:
        return state, {}
    return state, {k: torch.stack([m[k] for m in metrics])
                   for k in metrics[0]}
