"""Predict-only fast paths over a published snapshot.

Port of ``repro/serving/predict.py``.  The prequential step interleaves
predict and train; serving traffic wants the predict half alone.
``make_predict_fn(learner)`` returns ``f(state, x) -> pred`` for the
learner's family, made of exactly the read path of its training step: no
statistics scatter, no split or expansion check, no PRNG draw:

  * VHT: ``htree.predict``, the ``tree_route`` kernel with one tree and a
    class-count read;
  * OzaBag/OzaBoost: ``htree.route_members`` (one ``tree_route`` launch
    over the M trees) and the step's majority vote, ``htree.vote``;
  * AMRules, VAMR and HAMR: the coverage product, the first covering rule
    and the head mean (the drift statistics and expansions never run);
  * CluStream: the nearest macro centroid (``clustream.assign``);
  * a ``LearnerFleet`` of VHT or CluStream: ``f(state, x, tenant) ->
    pred``, row i answered by tenant ``tenant[i]``'s model.  For VHT the
    rows go through their tenants' trees in one ``tree_route_rows``
    launch (a tree per row), then a class-count read; for CluStream each
    row takes its tenant's macro centroids.

Each is op for op its training step's predict section, so a snapshot
published at a chunk boundary answers the next batch as the training loop
itself predicts it, bit for bit.  On a CUDA state the kernels launch (and
a failed build or launch raises); on a CPU state their plain versions
run.  Nothing in a predict function reads the device from the host.

The JAX package returns ``jax.jit`` of the function.  Here the function
runs eagerly, ``jit`` or not: a server batch is a few launches (two to
five kernels and the indexing around them), and a captured graph would
read fixed buffers while the snapshot changes at every chunk.

``reference_predict`` is the oracle of the tests: the plain versions
(``tree_route_ref``, the broadcast distances), written out apart from the
fast path; for a fleet it slices each row's tenant out and answers the
rows one at a time.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.tree_route.ops import tree_route_rows
from repro_torch.kernels.tree_route.ref import tree_route_ref
from repro_torch.ml import amrules as _amrules
from repro_torch.ml import clustream as _clustream
from repro_torch.ml import htree as _htree
from repro_torch.ml.amrules import AMRules, HAMR
from repro_torch.ml.clustream import CluStream
from repro_torch.ml.ensemble import OzaEnsemble
from repro_torch.ml.fleet import LearnerFleet
from repro_torch.ml.vht import VHT

i32 = torch.int32


def _vht_predict(tc):
    def predict(state, xbin):
        return _htree.predict(state, xbin, tc)[0]
    return predict


def _ensemble_predict(tc):
    def predict(state, xbin):
        trees = state["trees"]
        leaf = _htree.route_members(trees, xbin, tc)           # [M, B]
        return _htree.vote(trees, leaf, tc.n_classes)[1].to(i32)
    return predict


def _amrules_predict(rc):
    R = rc.max_rules

    def predict(state, xbin):
        cov = _amrules.coverage(state, xbin, rc)
        first = _amrules.first_cover(cov, rc)
        covered = first < R
        head_mean = state["head_sum"] / torch.clamp(state["head_n"], min=1.0)
        d_mean = state["d_sum"] / torch.clamp(state["d_n"], min=1.0)
        return torch.where(covered, head_mean[torch.clamp(first, max=R - 1)],
                           d_mean)
    return predict


def _clustream_predict():
    def predict(state, x):
        return _clustream.assign(state["macro"], x).to(i32)
    return predict


def _fleet_vht_predict(tc):
    def predict(state, xbin, tenant):
        trees = state["tenant"]
        leaf = tree_route_rows(trees["split_attr"], trees["split_bin"],
                               trees["children"], xbin, tenant,
                               max_depth=tc.max_depth)           # [R]
        counts = trees["class_counts"][tenant.long(), leaf.long()]
        return torch.argmax(counts, dim=-1).to(i32)
    return predict


def _fleet_clustream_predict():
    def predict(state, x, tenant):
        macro = state["tenant"]["macro"][tenant.long()]          # [R, k, d]
        d2 = _clustream.pairwise_d2(x[:, None, :], macro)       # [R, 1, k]
        return torch.argmin(d2[:, 0], -1).to(i32)
    return predict


def _refuse(learner):
    raise TypeError(
        f"no predict-only fast path for {type(learner).__name__}; expected "
        "VHT, OzaEnsemble, AMRules/VAMR/HAMR, CluStream, or a LearnerFleet")


def make_predict_fn(learner, *, jit: bool = True):
    """The predict-only fast path of ``learner``'s family: ``f(state, x)
    -> pred`` for a learner state (a published ``Snapshot.state``) and a
    batch of model inputs (binned int32 attributes for the tree and rule
    families, float32 features for CluStream).  For a ``LearnerFleet``,
    ``f(state, x, tenant) -> pred`` with ``tenant`` [B] int32 tenant ids.
    Eager whatever ``jit`` says (module docstring)."""
    del jit
    if isinstance(learner, LearnerFleet):
        if isinstance(learner.learner, VHT):
            return _fleet_vht_predict(learner.learner.tc)
        return _fleet_clustream_predict()
    if isinstance(learner, VHT):
        return _vht_predict(learner.tc)
    if isinstance(learner, OzaEnsemble):
        return _ensemble_predict(learner.tc)
    if isinstance(learner, (AMRules, HAMR)):
        return _amrules_predict(learner.rc)
    if isinstance(learner, CluStream):
        return _clustream_predict()
    _refuse(learner)


def reference_predict(learner, state, x, tenant=None):
    """The oracle's prediction, through the plain versions: the trees
    routed by ``tree_route_ref``, CluStream's distances by broadcasting,
    the documented formula elsewhere.  For a fleet, ``tenant`` names whose
    model answers each row: each row's tenant state is sliced out and the
    row answered alone."""
    if isinstance(learner, LearnerFleet):
        if tenant is None:
            raise ValueError("fleet reference_predict needs tenant ids")
        return torch.stack([
            reference_predict(learner.learner,
                              learner.tenant_state(state, int(t)),
                              x[i][None])[0]
            for i, t in enumerate(torch.as_tensor(tenant).tolist())])
    if isinstance(learner, VHT):
        leaf = tree_route_ref(state["split_attr"][None],
                              state["split_bin"][None],
                              state["children"][None], x,
                              learner.tc.max_depth)[0]
        return torch.argmax(state["class_counts"][leaf.long()], -1).to(i32)
    if isinstance(learner, OzaEnsemble):
        tc, trees = learner.tc, state["trees"]
        leaf = tree_route_ref(trees["split_attr"], trees["split_bin"],
                              trees["children"], x, tc.max_depth)  # [M, B]
        counts = torch.gather(
            trees["class_counts"], 1,
            leaf.long()[:, :, None].expand(-1, -1, tc.n_classes))
        votes = torch.argmax(counts, -1)
        tally = F.one_hot(votes, tc.n_classes).to(torch.float32).sum(0)
        return torch.argmax(tally, -1).to(i32)
    if isinstance(learner, (AMRules, HAMR)):
        return _amrules_predict(learner.rc)(state, x)
    if isinstance(learner, CluStream):
        d2 = _clustream.pairwise_d2(x, state["macro"], impl="onehot")
        return torch.argmin(d2, -1).to(i32)
    _refuse(learner)


__all__ = ["make_predict_fn", "reference_predict"]
