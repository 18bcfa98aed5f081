"""Snapshot publication: the hand-off from training to serving.

Port of ``repro/serving/snapshot.py``.  The chunked training loop and the
model server share one model, but the server must never read a model that
training writes: a compiled step advances its state buffers in place at
every step.  ``SnapshotPublisher`` stands between the two:

  * the training loop calls ``publish(chunk_index, state)`` at chunk
    boundaries (``ChunkedPrequentialEvaluation(publisher=...)``);
  * ``publish`` validates the candidate before a reader can see it: it is
    rejected when its structure would not round-trip through a checkpoint
    manifest (``checkpoint.manager._encode_structure``) or when a float
    leaf is not finite (``runtime.chaos.carry_all_finite``, the training
    rollback's check); a rejected snapshot leaves the last good one in
    place and counts in ``rejected_snapshots``;
  * an accepted snapshot is double-buffered: its leaves are cloned on the
    device into a back buffer that no step writes, and installed by one
    reference flip, so a reader holding an earlier ``Snapshot`` keeps a
    whole model.  The finite check reads the clone, on the stream the
    clone was made on, so a snapshot is complete on the device before a
    reader on another stream can see it;
  * a circuit breaker opens after ``breaker_threshold`` rejections in a
    row and closes at the next accepted snapshot;
  * staleness is counted in chunks: ``observe`` advances the train cursor
    also when nothing is published, so a stalled publisher shows as
    ``staleness()`` past ``max_staleness_chunks`` and ``degraded()``.

With ``async_publish`` the validation, the copy and the flip run on a
worker thread in publication order, at most ``max_pending`` queued;
``flush`` waits for them.  An accepted snapshot is also saved to
``checkpoint`` when one is given.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any

import numpy as np
import torch

from repro_torch.checkpoint.manager import _encode_structure, _flatten
from repro_torch.core.pytree import tree_map
from repro_torch.core.worker import OrderedWorker
from repro_torch.runtime.chaos import carry_all_finite


@dataclasses.dataclass(frozen=True)
class Snapshot:
    """One published model version; its tensors are never written."""

    state: Any          # the model state (the back buffer's copy)
    chunk_index: int    # the chunk boundary it was taken at
    version: int        # the publish counter, from 1
    published_at: float # the publisher's clock at the flip


def model_state_of(carry):
    """The model state in an engine carry.

    The chunked engines carry ``{"states": {proc: state}, "feedback": ...}``;
    for a bare learner (one processor) that is the learner's state.  A tree
    of another shape is returned as it is (a caller publishing a state
    directly)."""
    if isinstance(carry, dict) and isinstance(carry.get("states"), dict):
        states = carry["states"]
        if len(states) == 1:
            return next(iter(states.values()))
        return states
    return carry


def tenant_state_of(state, tenant: int):
    """One tenant's model out of a published fleet snapshot (its packed
    ``{"tenant": [F, ...]}`` leaves sliced at ``tenant``).  Raises for a
    state that is not a fleet's."""
    if not (isinstance(state, dict) and "tenant" in state):
        raise TypeError(
            "not a fleet snapshot state (no packed 'tenant' leaves); "
            "single-learner snapshots ARE the model state already")
    return tree_map(lambda leaf: leaf[int(tenant)], state["tenant"])


def _copy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    return np.array(x, copy=True)


class SnapshotPublisher:
    """Validated, double-buffered snapshot publication with a circuit
    breaker and a staleness limit.

    One thread publishes (the training loop, or its drain thread) and any
    number read.  Counters and the flip change under one lock;
    ``current()`` returns the installed ``Snapshot``, which never changes,
    so a reader holds no lock while it predicts."""

    def __init__(self, *, max_staleness_chunks: int = 4,
                 breaker_threshold: int = 3, checkpoint=None, clock=time.monotonic,
                 async_publish: bool = False, max_pending: int = 2):
        self.max_staleness_chunks = int(max_staleness_chunks)
        self.breaker_threshold = max(1, int(breaker_threshold))
        self.checkpoint = checkpoint
        self._clock = clock
        self._lock = threading.Lock()
        self._current: Snapshot | None = None
        self.train_cursor = -1         # newest chunk boundary observed
        self.published = 0
        self.rejected_snapshots = 0
        self.consecutive_rejections = 0
        self.breaker_open = False
        self.breaker_trips = 0
        self.events: list[tuple] = []
        self.async_publish = bool(async_publish)
        self.max_pending = max(1, int(max_pending))
        self._worker = OrderedWorker("snapshot-publish", self.max_pending)

    # --------------------------------------------------------- validation

    @staticmethod
    def _layout(state) -> str | None:
        """"empty" or "structure" when ``state`` cannot be published
        whatever its values; None otherwise."""
        if not _flatten(state)[0]:
            return "empty"
        if _encode_structure(state) is None:
            return "structure"      # the manifest would not round-trip
        return None

    @classmethod
    def validate(cls, state) -> str | None:
        """Why ``state`` would be rejected, or None when it is
        publishable."""
        reason = cls._layout(state)
        if reason is None and not carry_all_finite(state):
            reason = "non_finite"
        return reason

    # -------------------------------------------------------------- write

    def observe(self, chunk_index: int):
        """Record that training finished chunk ``chunk_index``, whether or
        not anything is published: a stalled publisher then shows as
        growing staleness."""
        with self._lock:
            self.train_cursor = max(self.train_cursor, int(chunk_index))

    def publish(self, chunk_index: int, state) -> bool:
        """Validate ``state`` and install it as the snapshot of chunk
        boundary ``chunk_index``; True when readers can see it.  With
        ``async_publish`` the call returns True at once ("queued"; bar the
        ``max_pending`` limit) and the worker validates and installs;
        ``flush()`` waits for it."""
        self.observe(chunk_index)
        if self.async_publish:
            self._worker.submit(self._publish_sync, int(chunk_index), state)
            return True
        return self._publish_sync(chunk_index, state)

    def flush(self):
        """Wait until every queued publication is installed or rejected."""
        self._worker.flush()

    def close(self):
        """``flush`` and stop the worker (a later publish starts
        another)."""
        self._worker.close()

    def _reject(self, chunk_index: int, reason: str) -> bool:
        with self._lock:
            self.rejected_snapshots += 1
            self.consecutive_rejections += 1
            self.events.append(("reject", int(chunk_index), reason))
            if (self.consecutive_rejections >= self.breaker_threshold
                    and not self.breaker_open):
                self.breaker_open = True
                self.breaker_trips += 1
                self.events.append(("breaker_open", int(chunk_index)))
        return False

    def _publish_sync(self, chunk_index: int, state) -> bool:
        reason = self._layout(state)
        if reason is not None:
            return self._reject(chunk_index, reason)
        # the back buffer: a copy on the device, outside the lock (readers
        # keep serving the old snapshot meanwhile), which no later step
        # writes; the finite check reads the copy, so it is complete once
        # the check returns
        state = tree_map(_copy, state)
        if not carry_all_finite(state):
            return self._reject(chunk_index, "non_finite")
        with self._lock:
            version = self.published + 1
            self._current = Snapshot(state=state,
                                     chunk_index=int(chunk_index),
                                     version=version,
                                     published_at=self._clock())
            self.published = version
            self.consecutive_rejections = 0
            if self.breaker_open:
                self.breaker_open = False
                self.events.append(("breaker_close", int(chunk_index)))
        if self.checkpoint is not None:
            self.checkpoint.save(int(chunk_index), state)
        return True

    # --------------------------------------------------------------- read

    def current(self) -> Snapshot | None:
        with self._lock:
            return self._current

    def staleness(self) -> int:
        """Chunks of training the snapshot is behind (every chunk observed,
        before the first snapshot)."""
        with self._lock:
            if self._current is None:
                return self.train_cursor + 1
            return max(0, self.train_cursor - self._current.chunk_index)

    def degraded(self) -> bool:
        """True when the server should stop claiming freshness: no snapshot
        yet, the staleness limit passed, or the breaker open."""
        with self._lock:
            if self.breaker_open or self._current is None:
                return True
            return (self.train_cursor - self._current.chunk_index
                    > self.max_staleness_chunks)

    def status(self) -> dict:
        with self._lock:
            cur = self._current
            stale = (self.train_cursor + 1 if cur is None
                     else max(0, self.train_cursor - cur.chunk_index))
            return {
                "published": self.published,
                "rejected_snapshots": self.rejected_snapshots,
                "consecutive_rejections": self.consecutive_rejections,
                "breaker_open": self.breaker_open,
                "breaker_trips": self.breaker_trips,
                "train_cursor": self.train_cursor,
                "snapshot_chunk": None if cur is None else cur.chunk_index,
                "snapshot_version": 0 if cur is None else cur.version,
                "pending_publishes": self._worker.pending,
                "staleness_chunks": stale,
                "degraded": (self.breaker_open or cur is None
                             or stale > self.max_staleness_chunks),
            }


__all__ = ["Snapshot", "SnapshotPublisher", "model_state_of",
           "tenant_state_of"]
