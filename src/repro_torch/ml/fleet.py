"""Multi-tenant learner fleets: F independent learners of one family as
packed ``[F, ...]`` state, every tenant advanced by one step.

Port of ``repro/ml/fleet.py`` for the families VHT and CluStream.  The
JAX package vmaps the family step over the fleet axis; the port cannot
vmap a step whose kernels and conds are its own, so the families' own
steps take the tenant axis as a leading axis of their state, and every
kernel launches once a step for all F tenants, whatever F is:

  * VHT (``VHT.step`` on trees ``[F, N, ...]``, as the ensembles hold
    ``[M, N, ...]``): each tenant's batch goes through its own tree in one
    ``tree_route_batched`` launch; the statistics of all tenants take one
    ``vht_stats`` launch, the tenant axis folded into the leaf axis
    (``stats`` viewed as ``[F * N, m, bins, C]``); the split check
    gathers the due leaves of every tenant into one pooled ``split_gain``
    tile of up to ``check_tile`` leaves a tenant, with the full pass over
    the ``[F * N]`` pool as its fallback, gated on any tenant due (see
    ``ml.htree``);
  * CluStream (``CluStream.step`` and its boundary hook on cluster
    features ``[F, K, ...]``, clock ``[F]``): every segment reduction
    (the CF scatter x | x^2, the 1 | t | t^2 sums, the ssq batch sum, the
    k-means' sums) is one launch of the kernel's tenant form,
    ``segment_sum_tenant``.

A gate of the single learner (a ``lax.cond``, which the JAX package's
vmap turns into a select of both branches) runs when any tenant takes
it, and the rows of the tenants that do not take it stay as they are.

Semantics, as in the JAX package:

  * ``init(key)`` splits the key into ``tenant_keys``; tenant f's row is
    bit for bit ``learner.init(tenant_keys(key)[f])``;
  * ``step(state, *args)`` takes per-tenant micro-batches stacked on the
    fleet axis (``x: [F, B, ...]``; the payload leaves of a stream are
    ``[T, F, B, ...]``, see ``stack_payloads``) and returns metrics with
    an ``[F]`` leaf per key, which ``MetricAccumulator`` keeps as
    per-tenant columns;
  * the carry keeps a per-tenant ``cursor`` ([F] int32), advanced only on
    real steps (the chunked driver does not run a padded step);
  * row f of the state and column f of the metrics equal tenant f's
    learner run alone: bit for bit for VHT (integer routing and weights,
    per-row gains) and for CluStream's cluster features; CluStream's
    macro centroids and ssq come out of batched float32 products, which
    may round otherwise than the single learner's.

``stack``/``unstack`` convert between F separate states and the packed
one; the packed state is a plain dict, so ``CheckpointManager`` round-
trips it and kill/resume stays bit for bit.  The JAX package's fleets of
``OzaEnsemble``, ``AMRules``/``VAMR`` and ``HAMR`` and its
``state_sharding`` are not ported: they raise, naming the ROADMAP items
that own them.
"""

from __future__ import annotations

import torch

from repro_torch.core import prng
from repro_torch.core.pytree import tree_map
from repro_torch.ml import clustream as _clustream
from repro_torch.ml.amrules import AMRules, HAMR
from repro_torch.ml.clustream import CluStream
from repro_torch.ml.ensemble import OzaEnsemble
from repro_torch.ml.vht import VHT

i32 = torch.int32

#: learner families a fleet stacks in the port
FLEET_FAMILIES = (VHT, CluStream)
# the JAX package's other fleet families (VAMR subclasses AMRules)
_QUEUED = (OzaEnsemble, AMRules, HAMR)


def stack_payloads(payloads):
    """Zip F per-tenant stream payloads (leaves ``[T, B, ...]``) into one
    fleet payload (leaves ``[T, F, B, ...]``): the step axis stays leading,
    so ``ChunkedStream`` chunks a fleet stream as a single one."""
    payloads = list(payloads)
    if not payloads:
        raise ValueError("need at least one tenant payload")
    return tree_map(lambda *xs: torch.stack(xs, dim=1), *payloads)


def _structure(tree):
    return tree_map(lambda _: None, tree)


class LearnerFleet:
    """F independent learners of one family as packed ``[F, ...]`` state
    (module docstring)."""

    def __init__(self, learner, n_tenants: int):
        if isinstance(learner, LearnerFleet):
            raise TypeError("fleets do not nest: pass the base learner")
        if isinstance(learner, _QUEUED):
            raise TypeError(
                f"no fleet support for {type(learner).__name__} in the "
                "port yet: fleets of OzaEnsemble, AMRules/VAMR and HAMR "
                "are ROADMAP section 1 item 8")
        if not isinstance(learner, FLEET_FAMILIES):
            raise TypeError(
                f"no fleet support for {type(learner).__name__}; expected "
                "VHT or CluStream")
        if int(n_tenants) < 1:
            raise ValueError(f"n_tenants must be >= 1, got {n_tenants}")
        self.learner = learner
        self.n_tenants = int(n_tenants)
        self.device = learner.device
        # the chunk-boundary hook only where the family has one (CluStream
        # in boundary mode), as the learner itself advertises it
        if getattr(learner, "boundary", None) is not None:
            self.boundary = self._boundary

    # ------------------------------------------------------------- state

    def tenant_keys(self, key):
        """The per-tenant keys ``init`` uses, ``split(key, F)``: tenant
        f's own run must start from row f for fleet-vs-separate parity."""
        return prng.split(key, self.n_tenants)

    def init(self, key=None):
        """Each tenant's ``learner.init`` from its key, stacked.  ``key``
        defaults to ``prng.PRNGKey(0)`` on the learner's device."""
        key = prng.PRNGKey(0, self.device) if key is None else key
        states = [self.learner.init(k) for k in self.tenant_keys(key)]
        tenant = tree_map(lambda *xs: torch.stack(xs), *states)
        dev = next(iter(tenant.values())).device
        return {"tenant": tenant,
                "cursor": torch.zeros((self.n_tenants,), dtype=i32,
                                      device=dev)}

    # -------------------------------------------------------------- step

    def step(self, state, *args):
        """One fleet step on per-tenant micro-batches stacked on the fleet
        axis (``x: [F, B, ...]``, ``y: [F, B]``).  Returns metrics with
        ``[F]`` leaves, one column per tenant."""
        tenant, metrics = self.learner.step(state["tenant"], *args)
        return {"tenant": tenant, "cursor": state["cursor"] + 1}, metrics

    def _boundary(self, state):
        return {"tenant": self.learner.boundary(state["tenant"]),
                "cursor": state["cursor"]}

    # ------------------------------------------------------------- merge

    def merge(self, states):
        """Merge shard-local fleet states tenant by tenant: CluStream's
        additive CF merge on the packed leaves (elementwise, so one call
        for every tenant); the per-tenant cursors add."""
        states = list(states)
        if not isinstance(self.learner, CluStream):
            raise TypeError(
                f"{type(self.learner).__name__} has no merge; fleet merge "
                "is defined only for families with a shard reduction")
        merged = _clustream.merge([s["tenant"] for s in states])
        cursor = sum((s["cursor"] for s in states[1:]), states[0]["cursor"])
        return {"tenant": merged, "cursor": cursor}

    # ----------------------------------------------------- stack/unstack

    def stack(self, states, *, cursor=None):
        """Pack F separate per-tenant states into one fleet state."""
        states = list(states)
        if len(states) != self.n_tenants:
            raise ValueError(f"expected {self.n_tenants} tenant states, "
                             f"got {len(states)}")
        ref = _structure(states[0])
        for f, s in enumerate(states[1:], 1):
            if _structure(s) != ref:
                raise ValueError(
                    f"tenant {f} state structure differs from tenant 0 "
                    "(fleets stack one family with one config)")
        tenant = tree_map(lambda *xs: torch.stack(xs), *states)
        dev = next(iter(tenant.values())).device
        cursor = (torch.zeros((self.n_tenants,), dtype=i32, device=dev)
                  if cursor is None
                  else torch.as_tensor(cursor, dtype=i32, device=dev))
        return {"tenant": tenant, "cursor": cursor}

    def unstack(self, state):
        """The inverse: F separate per-tenant states (the cursor stays at
        ``state['cursor']``)."""
        return [self.tenant_state(state, f) for f in range(self.n_tenants)]

    def tenant_state(self, state, f: int):
        """One tenant's family state out of the packed fleet state."""
        if not 0 <= int(f) < self.n_tenants:
            raise ValueError(f"tenant {f} outside [0, {self.n_tenants})")
        return tree_map(lambda leaf: leaf[int(f)], state["tenant"])

    # ----------------------------------------------------------- sharding

    def state_sharding(self):
        """The JAX package shards the fleet axis over a mesh; the port has
        no distributed runtime yet."""
        raise NotImplementedError(
            "LearnerFleet.state_sharding belongs to the distributed "
            "runtime: ROADMAP section 1 items 7 and 10")


__all__ = ["FLEET_FAMILIES", "LearnerFleet", "stack_payloads"]
