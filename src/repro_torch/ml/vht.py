"""Vertical Hoeffding Tree (paper section 6), in PyTorch.

Port of ``repro/ml/vht.py``.  Variants (the paper's experimental arms):

  local  -- split_delay=0: decisions applied within the step (== sequential
            VFDT).
  wok    -- split_delay=D>0, buffer_size=0: instances that reach a leaf
            with a pending split decision are DROPPED (load shedding).
  wk(z)  -- split_delay=D>0, buffer_size=z: such instances still update
            statistics downstream AND are buffered; when the split is
            applied the buffer is replayed through the new tree.

The VHT step is one eager function; the same logic is also exposed as a
Topology (ModelAggregatorProcessor + LocalStatisticProcessor wired with key
grouping) so it runs on the LocalEngine and the StreamEngine.  The paper's
horizontal baseline, ``ShardingEnsemble``, is here too.

``step`` updates ``state["stats"]`` in place (see ``htree.update_stats``);
``run`` clones the state first, so the caller's state is left as it was.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.pytree import scan, tree_clone
from repro_torch.core.topology import Processor, Topology, TopologyBuilder
from repro_torch.device import resolve_device
from repro_torch.kernels.vht_stats.ops import stats_update
from repro_torch.ml import htree
from repro_torch.ml.htree import TreeConfig

f32 = torch.float32
i32 = torch.int32


@dataclasses.dataclass(frozen=True)
class VHTConfig:
    tree: TreeConfig

    @property
    def variant(self) -> str:
        if self.tree.split_delay == 0:
            return "local"
        return f"wk({self.tree.buffer_size})" if self.tree.buffer_size else "wok"


class VHT:
    """VHT learner: a state dict of tensors + an eager step."""

    def __init__(self, cfg: VHTConfig, device=None):
        self.cfg = cfg
        self.tc = cfg.tree
        self.device = device

    def init(self, key=None):
        return htree.init_tree(self.tc, self.device)

    # -------------------------------------------------------------- step

    def step(self, state, xbin, y):
        """Prequential micro-batch step: test then train.

        Returns (state, metrics) with metrics = {correct, seen, dropped,
        n_nodes}, each a 0-dim f32 tensor on the state's device.  F trees
        stacked on a leading axis (a fleet's tenants, ``ml.fleet``; the
        shards of ``ShardingEnsemble``) step at once on their own batches,
        xbin [F, B, m] and y [F, B], each kernel launched once for all of
        them; the metrics are then [F], and row f of the state and of the
        metrics is tree f's own step, bit for bit.
        """
        tc = self.tc
        lead, B = y.shape[:-1], y.shape[-1]
        pred, leaf = htree.predict(state, xbin, tc)
        correct = (pred == y).to(f32).sum(-1)

        pending_here = torch.gather(state["pending"], -1, leaf.long())
        dropped = torch.zeros(lead, dtype=f32, device=y.device)
        if tc.split_delay == 0:
            w = torch.ones(y.shape, dtype=f32, device=y.device)
        elif tc.buffer_size:
            # wk(z): buffered instances still train downstream -> none dropped
            w = torch.ones(y.shape, dtype=f32, device=y.device)
            state = self._buffer_add(state, xbin, y, pending_here)
        else:
            w = torch.where(pending_here, 0.0, 1.0)      # wok: shed load
            dropped = pending_here.to(f32).sum(-1)

        state = htree.update_stats(state, leaf, xbin, y, w, tc)

        # countdown + apply matured split decisions (the feedback loop)
        state, applied = self._apply_pending(state)
        # trigger new decisions on current statistics (LS compute + MA recv)
        should, battr, bbin = htree.decide_splits(state, tc)
        state = dict(state)
        # reset the grace-period counter on every attempted leaf
        attempted = (state["split_attr"] < 0) & (state["since_attempt"] >= tc.n_min)
        state["since_attempt"] = torch.where(attempted, 0.0,
                                             state["since_attempt"])
        if tc.split_delay == 0:
            state, _ = htree.apply_splits(state, should, battr, bbin, tc)
        else:
            state["pending"] = state["pending"] | should
            state["pending_attr"] = torch.where(should, battr,
                                                state["pending_attr"])
            state["pending_bin"] = torch.where(should, bbin,
                                               state["pending_bin"])
            state["pending_timer"] = torch.where(
                should, tc.split_delay, state["pending_timer"])
        if tc.buffer_size:
            state = self._replay_if(state, applied)
        metrics = {"correct": correct,
                   "seen": torch.full(lead, B, dtype=f32, device=y.device),
                   "dropped": dropped,
                   "n_nodes": state["n_nodes"].to(f32)}
        return state, metrics

    def _apply_pending(self, state):
        """Count down the pending decisions and apply the matured ones ->
        (state, whether a split landed: 0-dim, or [F] for F trees)."""
        tc = self.tc
        if tc.split_delay == 0:
            return state, torch.zeros(state["pending"].shape[:-1],
                                      dtype=torch.bool,
                                      device=state["pending"].device)
        state = dict(state)
        timer = torch.where(state["pending"], state["pending_timer"] - 1,
                            state["pending_timer"])
        mature = state["pending"] & (timer <= 0)
        state["pending_timer"] = timer
        state, did = htree.apply_splits(
            state, mature, state["pending_attr"], state["pending_bin"], tc)
        state["pending"] = state["pending"] & ~mature
        return state, did.any(-1)

    # ---------------------------------------------------- wk(z) buffering

    def _buffer_add(self, state, xbin, y, mask):
        tc = self.tc
        state = dict(state)
        Z = tc.buffer_size
        B = y.shape[-1]
        dev = y.device
        # compact the masked instances to the front (stable, as jnp.argsort
        # is), then write a window
        order = torch.argsort((~mask).to(i32), dim=-1, stable=True)
        xs = torch.gather(xbin, -2, order[..., None].expand_as(xbin))
        ys = torch.gather(y, -1, order)
        k = torch.clamp(mask.sum(-1, dtype=i32), max=Z)
        ar = torch.arange(B, dtype=i32, device=dev)
        idx = (state["buf_n"][..., None] + ar) % Z
        take = ar < k[..., None]
        # each ring's scratch row Z, its rings flattened (htree.fold)
        write_idx = htree.fold(torch.where(take, idx, Z), Z + 1).long()

        def padded(buf):
            return torch.cat([buf, torch.zeros_like(buf[..., :1])], -1)

        bx = torch.cat([state["buf_x"], torch.zeros_like(
            state["buf_x"][..., :1, :])], -2)
        by = padded(state["buf_y"])
        bv = padded(state["buf_valid"])
        bx.view(-1, tc.n_attrs)[write_idx] = xs.reshape(-1, tc.n_attrs)
        by.view(-1)[write_idx] = ys.reshape(-1)
        bv.view(-1).index_fill_(0, write_idx, True)   # a scalar, not a host tensor
        # contiguous, as the kernels take the ring (the replay routes it)
        state["buf_x"] = bx[..., :Z, :].contiguous()
        state["buf_y"] = by[..., :Z].contiguous()
        state["buf_valid"] = bv[..., :Z].contiguous()
        state["buf_n"] = (state["buf_n"] + k) % max(Z, 1)
        return state

    def _replay_if(self, state, applied):
        """Replay the buffer through the new tree when a split landed."""
        tc = self.tc
        state = dict(state)
        leaf = htree.route(state, state["buf_x"], tc)
        applied = applied[..., None]
        w = torch.where(state["buf_valid"] & applied, 1.0, 0.0)
        state = htree.update_stats(state, leaf, state["buf_x"],
                                   state["buf_y"], w, tc)
        state["buf_valid"] = torch.where(
            applied, torch.zeros_like(state["buf_valid"]), state["buf_valid"])
        return state

    # ---------------------------------------------------- prequential run

    def run(self, state, xbin_stream, y_stream):
        """Step over the micro-batches [T, B, m] / [T, B] of a stream;
        returns (final state, metrics stacked to [T]).  The caller's
        ``state`` is not modified."""
        return scan(self.step, tree_clone(state), xbin_stream, y_stream)


# ---------------------------------------------------------------------------
# horizontal parallelism baseline (paper: 'sharding')
# ---------------------------------------------------------------------------

class ShardingEnsemble:
    """p independent Hoeffding trees on stream shards; majority vote.

    Memory grows p-fold (each tree tracks ALL attributes) -- the blow-up the
    paper demonstrates at 20k dense attributes.  The vote routes the whole
    batch through the p trees in one ``tree_route`` launch; member i then
    trains on the i-th of p equal shards of the batch (the remainder of
    ``B // p`` is not trained on) through the VHT step of the p trees at
    once, with ``split_delay=0, buffer_size=0``.  The members' statistics
    are updated in place."""

    def __init__(self, tc: TreeConfig, p: int, device=None):
        self.tc = dataclasses.replace(tc, split_delay=0, buffer_size=0)
        self.p = p
        self.device = device
        self._vht = VHT(VHTConfig(self.tc), device)

    def init(self, key=None):
        one = htree.init_tree(self.tc, self.device)
        return {k: torch.stack([v] * self.p) for k, v in one.items()}

    def step(self, states, xbin, y):
        B, p = y.shape[0], self.p
        leaf = htree.route_members(states, xbin, self.tc)       # [p, B]
        _, pred = htree.vote(states, leaf, self.tc.n_classes)
        correct = (pred == y).to(f32).sum()
        # shuffle-group training: shard the batch across the ensemble
        n = (B // p) * p
        xs = xbin[:n].reshape(p, B // p, -1)
        ys = y[:n].reshape(p, B // p)
        states, _ = self._vht.step(states, xs, ys)
        return states, {"correct": correct,
                        "seen": torch.full((), B, dtype=f32, device=y.device),
                        "dropped": torch.zeros((), dtype=f32, device=y.device),
                        "n_nodes": states["n_nodes"].to(f32).sum()}

    def run(self, states, xbin_stream, y_stream):
        """As ``VHT.run``: the caller's ``states`` is not modified."""
        return scan(self.step, tree_clone(states), xbin_stream, y_stream)


# ---------------------------------------------------------------------------
# Topology wiring (the paper's Figure 2 as platform objects)
# ---------------------------------------------------------------------------

class ModelAggregatorProcessor(Processor):
    """Holds the tree structure; sorts instances; applies split feedback."""

    name = "model-aggregator"

    def __init__(self, cfg: VHTConfig, device=None):
        self.cfg = cfg
        self.tc = cfg.tree
        self.device = device

    def init_state(self, key=None):
        st = htree.init_tree(self.tc, self.device)
        # MA holds everything except the big statistics tensor
        st.pop("stats")
        return st

    def process(self, state, inputs):
        tc = self.tc
        out = {}
        # split feedback from the statistics (local-result events); the
        # child class distributions ride along in the event, so no
        # statistics tensor (or cumsum over one) is needed here
        fb = inputs.get("local-result")
        if fb is not None:
            should = fb["should"] & (state["split_attr"] < 0)
            state, _ = htree.apply_splits(
                state, should, fb["attr"], fb["bin"], tc,
                child_counts=(fb["left"], fb["right"]))
            state = dict(state)
            state["class_counts"] = torch.where(
                should[:, None], fb["left"] + fb["right"],
                state["class_counts"])
            out["drop"] = {"leaf_mask": should}
        src = inputs.get("__source__")
        if src is not None:
            xbin, y = src["x"], src["y"]
            leaf = htree.route(state, xbin, tc)
            lf = leaf.long()
            pred = torch.argmax(state["class_counts"][lf], -1).to(i32)
            ones = torch.ones(lf.shape, dtype=f32, device=lf.device)
            state = dict(state)
            state["n_total"] = state["n_total"].index_add(0, lf, ones)
            state["since_attempt"] = state["since_attempt"].index_add(0, lf, ones)
            attempt = state["since_attempt"] >= tc.n_min
            state["since_attempt"] = torch.where(attempt, 0.0,
                                                 state["since_attempt"])
            # attribute events (key-grouped on (leaf, attr)) + compute events
            out["attribute"] = {"leaf": leaf, "x": xbin, "y": y}
            out["compute"] = {"attempt_mask": attempt,
                              "n_total": state["n_total"]}
            out["prediction"] = {"pred": pred, "y": y}
        return state, out


class LocalStatisticProcessor(Processor):
    """Key-grouped statistics: updates n_ijk, answers compute events.
    Its ``stats`` tensor is updated in place."""

    name = "local-statistic"

    def __init__(self, cfg: VHTConfig, device=None):
        self.cfg = cfg
        self.tc = cfg.tree
        self.device = device

    def init_state(self, key=None):
        tc = self.tc
        return {"stats": torch.zeros(
            (tc.max_nodes, tc.n_attrs, tc.n_bins, tc.n_classes), dtype=f32,
            device=resolve_device(self.device))}

    def process(self, state, inputs):
        tc = self.tc
        out = {}
        attr_ev = inputs.get("attribute")
        if attr_ev is not None:
            y = attr_ev["y"]
            w = torch.ones(y.shape[0], dtype=f32, device=y.device)
            state = {"stats": stats_update(state["stats"], attr_ev["leaf"],
                                           attr_ev["x"], y, w)}
        comp = inputs.get("compute")
        if comp is not None:
            N, C = tc.max_nodes, tc.n_classes
            dev = comp["n_total"].device

            def answer_rows(stats_rows, n_total_rows, mask_rows):
                """Split criterion over a row subset (Alg. 3): gains +
                Hoeffding test + child class distributions."""
                gains = htree.split_gains(stats_rows, tc)
                k, m, bins = gains.shape
                top2, idx2 = htree.top_k(gains.reshape(k, m * bins), 2)
                ga, gb = top2[:, 0], top2[:, 1]
                battr, bbin = idx2[:, 0] // bins, idx2[:, 0] % bins
                eps = htree.hoeffding_bound(n_total_rows, tc)
                ok = (ga > 0) & ((ga - gb > eps) | (eps < tc.tau))
                should = mask_rows & ok
                left, right = htree.child_counts_from_stats(stats_rows,
                                                            battr, bbin)
                return should, battr, bbin, left, right

            def full(stats):
                s, a, b, le, ri = answer_rows(stats, comp["n_total"],
                                              comp["attempt_mask"])
                return {"should": s, "attr": a, "bin": b,
                        "left": le, "right": ri}

            def idle(stats):
                return {"should": torch.zeros(N, dtype=torch.bool, device=dev),
                        "attr": torch.zeros(N, dtype=i32, device=dev),
                        "bin": torch.zeros(N, dtype=i32, device=dev),
                        "left": torch.zeros((N, C), dtype=f32, device=dev),
                        "right": torch.zeros((N, C), dtype=f32, device=dev)}

            if tc.gate_splits:
                # the gain reduction only runs when a leaf exhausted its
                # grace period, and only over the (few) due rows when they
                # fit the check tile; an all-False answer is exact
                # otherwise because only attempted leaves can split
                K = min(tc.check_tile, N)

                def gathered(stats):
                    idx = htree.due_topk(comp["attempt_mask"],
                                         comp["n_total"], K)
                    rows = idx.long()
                    s, a, b, le, ri = answer_rows(
                        stats[rows], comp["n_total"][rows],
                        comp["attempt_mask"][rows])
                    return {"should": htree.scatter_rows(N, idx, s),
                            "attr": htree.scatter_rows(N, idx, a),
                            "bin": htree.scatter_rows(N, idx, b),
                            "left": htree.scatter_rows(N, idx, le),
                            "right": htree.scatter_rows(N, idx, ri)}

                out["local-result"] = htree.gated_check(
                    comp["attempt_mask"].sum(), K, gathered, full, idle,
                    state["stats"])
            else:
                out["local-result"] = full(state["stats"])
        drop = inputs.get("drop")
        if drop is not None:
            state = {"stats": state["stats"].masked_fill_(
                drop["leaf_mask"][:, None, None, None], 0.0)}
        return state, out


def build_vht_topology(cfg: VHTConfig, device=None) -> Topology:
    """Figure 2: S -> MA -> (attribute: key grouping) -> LS -> (local-result)
    -> MA, with compute/drop broadcast (all grouping)."""
    b = TopologyBuilder("vht")
    ma = b.add_processor(ModelAggregatorProcessor(cfg, device), entry=True)
    ls = b.add_processor(LocalStatisticProcessor(cfg, device),
                         parallelism=cfg.tree.n_attrs)
    b.create_stream("attribute", ma)
    b.connect_key("attribute", ls)
    b.create_stream("compute", ma)
    b.connect_all("compute", ls)
    b.create_stream("drop", ma)
    b.connect_all("drop", ls)
    b.create_stream("local-result", ls)
    b.connect_key("local-result", ma)
    b.create_stream("prediction", ma)
    return b.build()
