"""Adaptive ensembles (paper section 5): OzaBag and OzaBoost with a change
detector per member (ADWIN, DDM, EDDM or Page-Hinkley), in PyTorch.

Port of ``repro/ml/ensemble.py``.  Online bagging (Oza & Russell): each
member trains on each instance with a weight drawn from Poisson(1).
Online boosting: the rate is raised for instances the earlier members got
wrong.  On drift a member is reset to a fresh tree.  The base learner is
the tensorized Hoeffding tree of ``ml.htree``, M members stacked on a
leading axis.

A step:

  * routes the batch through all M trees in one ``tree_route`` launch; the
    [M, B] leaves serve both the vote and the training;
  * draws the members' weights, JAX's threefry2x32 Poisson draws bit for
    bit, in one ``split_poisson`` launch (``member_weights``);
  * updates each member's statistics with its integer weights (one
    ``vht_stats`` launch a member, in place);
  * checks splits gated across members (``EnsembleConfig.gate_members``):
    ``split_check="pool"`` treats the M node pools as one [M * N] pool and
    runs ``split_gain`` on a gathered tile of at most ``check_tile`` due
    leaves, with the full pass as its fallback; ``"member"`` runs the full
    pass when any leaf is due; ``gate_members=False`` runs it always (the
    oracle).  The full pass takes one ``split_gain`` launch over the
    flattened pool, whose rows are independent;
  * updates the detectors in one packed ``DetectorBank`` pass and resets
    the drifted members.

Where the JAX package vmaps over members, the port runs batched tensor
ops or a Python loop over members; where it gates with ``lax.cond``, the
port takes ``compiled.gate`` (a conditional node in a captured step, a
host read eagerly).  A JAX ``lax.cond`` under ``vmap`` selects between
both branches, so a gated loop gives the same values.  The statistics are
updated and cleared in place and never pass through a gate; the drift
reset, ``where(drift, fresh, old)`` over every leaf in the JAX package, is
gated on any drift, and clears a drifted member's statistics in place.

The JAX package's ``state_sharding`` and its ``shard_map`` form of the
pooled check belong to the distributed runtime, which the port does not
have yet.  Its ``route_impl`` picks among TPU routers and its
``detector_impl="vmap"`` among detector programs; the port routes with
the ``tree_route`` kernel (its plain version on the CPU) and updates the
detectors as one bank, and takes neither option.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import prng
from repro_torch.core.compiled import gate
from repro_torch.core.pytree import scan, tree_clone
from repro_torch.core.xla_numerics import reciprocal
from repro_torch.kernels.split_poisson.ops import split_poisson
from repro_torch.ml import htree
from repro_torch.ml.detectors import DetectorBank
from repro_torch.ml.htree import TreeConfig

f32 = torch.float32
i32 = torch.int32
DETECTORS = ("adwin", "ddm", "eddm", "ph")


@dataclasses.dataclass(frozen=True)
class EnsembleConfig:
    tree: TreeConfig
    n_members: int = 10
    boost: bool = False
    detector: str = "adwin"      # adwin | ddm | eddm | ph | none
    gate_members: bool = True    # gate the split work on any member due
    split_check: str = "pool"    # pool (a gathered tile of the flattened
                                 # [M*N] pool) | member (the full pass
                                 # behind the any-due gate)


class OzaEnsemble:
    """OzaBag (``boost=False``) or OzaBoost: a state of stacked member
    trees, a packed detector bank and a PRNG key, and an eager step."""

    def __init__(self, ec: EnsembleConfig, device=None):
        if ec.split_check not in ("pool", "member"):
            raise ValueError(f"unknown split check {ec.split_check!r}")
        self.ec = ec
        self.tc = ec.tree
        self.device = device
        # the four documented member-detector families; "none" (and any
        # other name) means no detector
        self._bank = (DetectorBank(ec.detector, ec.n_members, device=device)
                      if ec.detector in DETECTORS else None)
        # the drift-reset target, built once; its statistics are zeros
        self._fresh = htree.init_tree(self.tc, device)
        # the per-member decisions run ungated: the gates are across members
        self._tci = dataclasses.replace(self.tc, gate_splits=False)

    def init(self, key=None):
        """M fresh trees, the detector bank and ``key`` (``None``:
        ``prng.PRNGKey(0)`` on the learner's device, the key
        ``PrequentialEvaluation`` gives)."""
        dev = self._fresh["n_nodes"].device
        key = prng.PRNGKey(0, dev) if key is None else key
        trees = {k: torch.stack([v] * self.ec.n_members)
                 for k, v in self._fresh.items()}
        det = self._bank.init() if self._bank is not None else None
        return {"trees": trees, "det": det, "key": key}

    # ---------------------------------------------------------- weights

    def member_weights(self, key, votes, y):
        """(key', w): the step's key and the members' training weights
        [M, B] f32, ``w = poisson(k1, lam)`` with ``(key', k1) =
        split(key)``: lam is 1 (bagging) or, boosting, 1 + 2 x the error
        rate of the earlier members on each instance.  One ``split_poisson``
        launch on the card."""
        M, B = votes.shape
        if not self.ec.boost:
            lam = torch.ones((M, 1), dtype=f32, device=votes.device)
            return split_poisson(key, lam, (M, B))
        member_err = (votes != y[None]).to(f32)
        cum_err = torch.cumsum(member_err, 0) / torch.arange(
            1, M + 1, dtype=f32, device=votes.device)[:, None]
        lam = 1.0 + 2.0 * torch.cat([torch.zeros_like(cum_err[:1]),
                                     cum_err[:-1]], 0)
        return split_poisson(key, lam, (M, B))

    # ------------------------------------------------------------- step

    def step(self, state, xbin, y):
        """Prequential micro-batch step: test then train.  Returns (state,
        metrics) with metrics {correct, seen, drifts}, 0-dim f32 tensors.
        The statistics are updated in place."""
        tc = self.tc
        B = y.shape[0]
        trees = state["trees"]
        leaf = htree.route_members(trees, xbin, tc)           # [M, B]
        votes, pred = htree.vote(trees, leaf, tc.n_classes)
        correct = (pred == y).to(f32).sum()
        key, w = self.member_weights(state["key"], votes, y)
        trees = htree.update_stats_members(trees, leaf, xbin, y, w, tc)
        trees = self._split_check(trees)
        det = state["det"]
        n_drift = torch.zeros((), dtype=f32, device=y.device)
        if det is not None:
            # the error rate, jnp.mean: the count of errors (exact) times
            # XLA's float32 1 / B, a product that XLA fuses into the
            # detectors' first sums
            member_err = (votes != y[None]).to(f32).sum(-1)
            det, drift = self._bank.update(det, member_err,
                                           scale=reciprocal(B))
            trees = self._reset_members(trees, drift)
            n_drift = drift.sum().to(f32)
        metrics = {"correct": correct,
                   "seen": torch.full((), B, dtype=f32, device=y.device),
                   "drifts": n_drift}
        return {"trees": trees, "det": det, "key": key}, metrics

    def _reset_members(self, trees, drift):
        """Drifted members become fresh trees: their statistics cleared in
        place, every other leaf taken from the fresh tree.  Gated on any
        drift (the identity otherwise)."""
        stats = trees["stats"]
        small = {k: v for k, v in trees.items() if k != "stats"}

        def reset(t):
            stats.masked_fill_(drift.view(-1, 1, 1, 1, 1), 0.0)
            return {k: torch.where(drift.view((-1,) + (1,) * (v.dim() - 1)),
                                   self._fresh[k][None], v)
                    for k, v in t.items()}

        small = gate(drift.any(), reset, lambda t: t, small)
        return {**small, "stats": stats}

    # ------------------------------------------------------- split check

    def _split_check(self, trees):
        ec, tc, tci = self.ec, self.tc, self._tci
        M, N, C = ec.n_members, tc.max_nodes, tc.n_classes
        MN = M * N
        K = min(tc.check_tile, MN)
        stats = trees["stats"]
        pool = stats.reshape((MN,) + stats.shape[2:])
        small = {k: v for k, v in trees.items() if k != "stats"}

        def flat(t):
            return {k: pool if k == "stats" else
                    t[k].reshape((MN,) + t[k].shape[2:])
                    for k in htree._DECIDE_KEYS}

        def due_of(t):
            return (t["split_attr"] < 0) & (t["since_attempt"] >= tc.n_min)

        def apply_members(t, should, attr, tbin, children=None):
            """The members' ``apply_splits`` at once, gated on any split
            landing (an identity when none does); the split leaves'
            statistics are cleared in place."""
            def split(t):
                trees, _ = htree._apply_splits_impl(
                    {**t, "stats": stats}, should, attr, tbin, tci,
                    child_counts=children)
                trees.pop("stats")
                return trees
            return gate(should.any(), split, lambda t: t, t)

        def split_all(t):
            # the decision's rows are independent: one pass over the pool
            should, battr, bbin = htree._decide_splits_impl(flat(t), tci)
            t = dict(t)
            t["since_attempt"] = torch.where(due_of(t), 0.0,
                                             t["since_attempt"])
            return apply_members(t, should.reshape(M, N),
                                 battr.reshape(M, N), bbin.reshape(M, N))

        def split_gathered(t):
            due = due_of(t)
            idx, s_k, a_k, b_k, left_k, right_k = htree.gather_decide_tile(
                flat(t), due.reshape(MN), K, tci, with_children=True)

            def scat(val):
                return htree.scatter_rows(MN, idx, val).reshape(
                    (M, N) + val.shape[1:])

            t = dict(t)
            t["since_attempt"] = torch.where(due, 0.0, t["since_attempt"])
            return apply_members(t, scat(s_k), scat(a_k), scat(b_k),
                                 (scat(left_k), scat(right_k)))

        if not ec.gate_members:
            small = split_all(small)
        elif ec.split_check == "pool":
            small = htree.gated_check(due_of(small).sum(), K, split_gathered,
                                      split_all, lambda t: t, small)
        else:
            small = gate(due_of(small).any(), split_all, lambda t: t, small)
        return {**small, "stats": stats}

    # ---------------------------------------------------- prequential run

    def run(self, state, x_stream, y_stream):
        """Step over the micro-batches [T, B, m] / [T, B] of a stream;
        returns (final state, metrics stacked to [T]).  The caller's
        ``state`` is not modified."""
        return scan(self.step, tree_clone(state), x_stream, y_stream)


__all__ = ["DETECTORS", "EnsembleConfig", "OzaEnsemble"]
