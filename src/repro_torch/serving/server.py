"""The online model server: micro-batching, admission control, deadlines
and truthful degradation.

Port of ``repro/serving/server.py``.  ``ModelServer`` answers predict
requests from the newest snapshot a ``SnapshotPublisher`` has installed,
while the training loop keeps publishing: SAMOA's model aggregator feeding
its evaluators, recast as a serving system.

  * Micro-batching under a bounded wait: a dispatcher thread collects up
    to ``max_batch`` requests, or what came within ``max_wait_ms`` of the
    batch's first, and answers them with one predict call
    (``serving.predict``).  A batch is padded to exactly ``max_batch``
    rows with copies of its last real row (never zeros or NaN), so the
    kernels always see one shape; the padded answers are dropped.
  * Admission control: the queue holds at most ``queue_limit`` requests;
    beyond that ``submit`` answers ``overloaded`` at once.  Before the
    first snapshot it answers ``unavailable``.
  * Deadlines: a request whose deadline (default ``deadline_ms``) passed
    while it was queued is shed when its batch forms.
  * Truthful accounting: every request ends in exactly one of
    ``answered | shed | overloaded | unavailable``, and
    ``status()["accounting_ok"]`` checks ``submitted == answered + shed +
    rejected + pending``.
  * Degradation: each answer carries its snapshot's version and chunk,
    its staleness in chunks and the publisher's ``degraded`` flag.
  * Tenant routing: a server over a ``LearnerFleet`` takes ``tenant=`` with
    every request and answers it from that tenant's model; a batch mixes
    tenants and goes through one predict call (``serving.predict``'s fleet
    path), and each answer's meta names its tenant.

On the card the dispatcher predicts on a CUDA stream of its own, so a
batch does not queue behind the training chunks on the default stream;
its one host read per batch, the predictions, waits for that stream
alone.  A snapshot's tensors are complete before it is installed (the
publisher's finite check reads them on the stream that copied them); the
dispatcher holds the ``Snapshot`` until its host read has returned, so no
tensor it reads is freed while the read is in flight.
A process that trains and serves for long should freeze what it made at
start-up (``gc.freeze()``): a full collection of the garbage collector
walks every object the process tracks while it holds the interpreter
lock, and on a large heap that stops the dispatcher past its deadlines.
``clock`` (default ``time.monotonic``) times the batching window, the
deadlines and the latencies; ``poll()`` forms and answers one batch in
the caller's thread, for a server made with ``start=False``.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Any

import numpy as np
import torch

from repro_torch.checkpoint.manager import _flatten
from repro_torch.ml.fleet import LearnerFleet
from repro_torch.serving.predict import make_predict_fn


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_batch: int = 32          # micro-batch flush size
    max_wait_ms: float = 2.0     # micro-batch flush age
    queue_limit: int = 128       # admission bound (pending requests)
    deadline_ms: float = 100.0   # default per-request deadline


#: the terminal states of a request
ANSWERED, SHED, OVERLOADED, UNAVAILABLE = \
    "answered", "shed", "overloaded", "unavailable"


class Request:
    """One predict request: a handle the caller waits on.

    ``status`` is ``"pending"`` until the server resolves it to one of the
    four terminal states; ``result(timeout)`` blocks until then.  An
    answered request carries ``pred`` and ``meta`` (snapshot version and
    chunk, staleness in chunks, degraded flag, latency, batch size)."""

    __slots__ = ("x", "deadline", "submitted_at", "status", "pred", "meta",
                 "tenant", "_done")

    def __init__(self, x, deadline: float, submitted_at: float,
                 tenant: int | None = None):
        self.x = x
        self.tenant = tenant
        self.deadline = deadline
        self.submitted_at = submitted_at
        self.status = "pending"
        self.pred: Any = None
        self.meta: dict = {}
        self._done = threading.Event()

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: float | None = None) -> "Request":
        if not self._done.wait(timeout):
            raise TimeoutError("request not resolved within timeout")
        return self


class ModelServer:
    """Serve predictions from published snapshots (module docstring)."""

    def __init__(self, learner, publisher, config: ServeConfig = None, *,
                 start: bool = True, clock=time.monotonic):
        self.publisher = publisher
        self.cfg = config if config is not None else ServeConfig()
        if self.cfg.max_batch < 1 or self.cfg.queue_limit < 1:
            raise ValueError("max_batch and queue_limit must be >= 1")
        self._fn = make_predict_fn(learner)
        # a fleet's requests carry a tenant id, which routes each row
        self._fleet = learner if isinstance(learner, LearnerFleet) else None
        self._clock = clock
        self._q: queue.Queue = queue.Queue(maxsize=self.cfg.queue_limit)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._closed = False     # the admission gate; see stop()
        self._thread: threading.Thread | None = None
        self._cuda_stream = None     # the dispatcher's, made at first use
        # submitted == answered + shed + rejected_overloaded
        #              + rejected_unavailable + pending
        self.submitted = 0
        self.answered = 0
        self.shed = 0
        self.rejected_overloaded = 0
        self.rejected_unavailable = 0
        self.batches = 0
        self.max_queue_depth = 0
        self.degraded_answers = 0
        if start:
            self.start()

    # ------------------------------------------------------------ control

    def start(self):
        if self._thread is not None:
            return
        self._stop.clear()
        with self._lock:
            self._closed = False
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="repro-serve-dispatch")
        self._thread.start()

    def stop(self, *, drain: bool = True, timeout: float = 60.0):
        """Stop dispatching.  ``drain=True`` first serves what is queued
        (for up to ``timeout`` seconds); whatever is still queued then
        resolves ``shed``, never left pending."""
        if self._thread is not None and drain:
            deadline = time.monotonic() + timeout
            while not self._q.empty() and time.monotonic() < deadline:
                time.sleep(0.001)
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        # admission closes before the last drain, under the lock submit
        # enqueues under: a racing request is either in the queue (and
        # resolved below) or sees the gate closed, never left behind
        with self._lock:
            self._closed = True
        while True:
            try:
                r = self._q.get_nowait()
            except queue.Empty:
                break
            self._finish(r, SHED, reason="server_stopped")

    # ------------------------------------------------------------- submit

    def submit(self, x, *, deadline_ms: float | None = None,
               tenant: int | None = None) -> Request:
        """Admit one request (``x``: one instance's model input, no batch
        axis).  Never blocks: a full queue answers ``overloaded`` at once,
        no snapshot yet or a stopped server ``unavailable``.  A server over
        a ``LearnerFleet`` requires ``tenant``, the id of the tenant whose
        model answers; the request is refused (``ValueError``) before any
        accounting without one, with one out of range, or with one on a
        server of a single learner."""
        if self._fleet is not None:
            if tenant is None:
                raise ValueError(
                    "this server serves a LearnerFleet: submit(..., "
                    "tenant=<id>) is required to route the request")
            if not 0 <= int(tenant) < self._fleet.n_tenants:
                raise ValueError(
                    f"tenant {tenant} outside [0, {self._fleet.n_tenants})")
            tenant = int(tenant)
        elif tenant is not None:
            raise ValueError("tenant routing requires a LearnerFleet")
        now = self._clock()
        dl = self.cfg.deadline_ms if deadline_ms is None else deadline_ms
        r = Request(np.asarray(x), now + dl / 1e3, now, tenant=tenant)
        with self._lock:
            self.submitted += 1
        if self.publisher.current() is None:
            self._finish(r, UNAVAILABLE, reason="no_snapshot")
            return r
        verdict = None
        with self._lock:
            if self._closed:
                verdict = (UNAVAILABLE, "server_stopped")
            else:
                try:
                    self._q.put_nowait(r)
                    self.max_queue_depth = max(self.max_queue_depth,
                                               self._q.qsize())
                except queue.Full:
                    verdict = (OVERLOADED, "queue_full")
        if verdict is not None:
            self._finish(r, verdict[0], reason=verdict[1])
        return r

    # ---------------------------------------------------------- dispatch

    def _loop(self):
        while not self._stop.is_set():
            self.poll(timeout=0.02)

    def poll(self, timeout: float = 0.0) -> int:
        """Form one micro-batch, as the dispatcher does, and answer it:
        the first request waited for up to ``timeout`` seconds, then up to
        ``max_batch`` of them or what comes within ``max_wait_ms`` by the
        server's clock.  Returns the batch's size (0: nothing came)."""
        try:
            first = (self._q.get(timeout=timeout) if timeout > 0
                     else self._q.get_nowait())
        except queue.Empty:
            return 0
        batch = [first]
        wait_s = self.cfg.max_wait_ms / 1e3
        opened = self._clock()
        while len(batch) < self.cfg.max_batch:
            left = wait_s - (self._clock() - opened)
            if left <= 0:
                break
            try:
                batch.append(self._q.get(timeout=left))
            except queue.Empty:
                break
        self._serve_batch(batch)
        return len(batch)

    def _predict(self, snap, xs, tenants=None):
        """The predictions for the rows ``xs`` (numpy; for a fleet, with
        their tenant ids ``tenants``) from ``snap``, read on the host."""
        dev = next(x.device for x in _flatten(snap.state)[0]
                   if isinstance(x, torch.Tensor))

        def run():
            args = [torch.from_numpy(xs).to(dev)]
            if tenants is not None:
                args.append(torch.from_numpy(tenants).to(dev))
            return self._fn(snap.state, *args)

        if dev.type != "cuda":
            return run().numpy()
        if self._cuda_stream is None:
            self._cuda_stream = torch.cuda.Stream(dev)
        with torch.cuda.stream(self._cuda_stream):
            return run().cpu().numpy()

    def _serve_batch(self, batch):
        now = self._clock()
        live = []
        for r in batch:
            if now > r.deadline:
                self._finish(r, SHED, reason="deadline_expired")
            else:
                live.append(r)
        if not live:
            return
        snap = self.publisher.current()
        if snap is None:
            for r in live:
                self._finish(r, UNAVAILABLE, reason="no_snapshot")
            return
        xs = np.stack([r.x for r in live])
        tenants = (None if self._fleet is None else
                   np.asarray([r.tenant for r in live], np.int32))
        pad = self.cfg.max_batch - xs.shape[0]
        if pad:
            # a real row, never zeros or NaN: the padded rows go through
            # the same predict, and their answers are dropped
            xs = np.concatenate([xs, np.repeat(xs[-1:], pad, axis=0)], 0)
            if tenants is not None:
                tenants = np.concatenate([tenants,
                                          np.repeat(tenants[-1:], pad)])
        preds = self._predict(snap, np.ascontiguousarray(xs), tenants)
        stale = max(0, self.publisher.train_cursor - snap.chunk_index)
        degraded = self.publisher.degraded()
        done = self._clock()
        with self._lock:
            self.batches += 1
        for i, r in enumerate(live):
            r.pred = preds[i]
            r.meta = {
                "snapshot_version": snap.version,
                "snapshot_chunk": snap.chunk_index,
                "staleness_chunks": stale,
                "degraded": degraded,
                "latency_ms": (done - r.submitted_at) * 1e3,
                "batch_size": len(live),
            }
            if r.tenant is not None:
                r.meta["tenant"] = r.tenant
            self._finish(r, ANSWERED)
            if degraded:
                with self._lock:
                    self.degraded_answers += 1

    def _finish(self, r: Request, status: str, *, reason: str | None = None):
        r.status = status
        if reason is not None:
            r.meta = dict(r.meta, reason=reason)
        with self._lock:
            if status == ANSWERED:
                self.answered += 1
            elif status == SHED:
                self.shed += 1
            elif status == OVERLOADED:
                self.rejected_overloaded += 1
            elif status == UNAVAILABLE:
                self.rejected_unavailable += 1
        r._done.set()

    # ------------------------------------------------------------- status

    def status(self) -> dict:
        with self._lock:
            resolved = (self.answered + self.shed + self.rejected_overloaded
                        + self.rejected_unavailable)
            pending = self.submitted - resolved
            out = {
                "submitted": self.submitted,
                "answered": self.answered,
                "shed": self.shed,
                "rejected_overloaded": self.rejected_overloaded,
                "rejected_unavailable": self.rejected_unavailable,
                "pending": pending,
                "batches": self.batches,
                "max_queue_depth": self.max_queue_depth,
                "degraded_answers": self.degraded_answers,
                "queue_limit": self.cfg.queue_limit,
                "accounting_ok": pending >= 0,
            }
        out.update({f"publisher_{k}": v
                    for k, v in self.publisher.status().items()})
        return out


__all__ = ["ServeConfig", "Request", "ModelServer", "ANSWERED", "SHED",
           "OVERLOADED", "UNAVAILABLE"]
