"""PrequentialEvaluation -- the paper's canonical Task (section 4).

Port of ``repro/core/evaluation.py``: "a classification task where each
instance is used for testing first, and then for training."  Wires a
stream source, any learner exposing ``init``/``step``, and an evaluator
that accumulates interleaved test-then-train metrics.
``PrequentialEvaluation`` runs a stream of batches;
``ChunkedPrequentialEvaluation`` runs a ``ChunkedStream`` on the chunked
runtime, with mid-stream checkpoints that resume bit for bit, a finite
check with rollback, snapshot publishing for a model server, and its
metrics reduced through a ``MetricAccumulator``; its pipelined driver (the
default) dispatches chunk k+1 while the card runs chunk k.  The JAX
package's supervisor, elastic re-place and compile cache are not ported.
"""

from __future__ import annotations

import dataclasses
import inspect
import threading
import time
from typing import Any

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.compiled import compile_step
from repro_torch.core.pytree import tree_leaves, tree_map
from repro_torch.core.topology import Task
from repro_torch.core.worker import OrderedWorker
from repro_torch.runtime.chaos import carry_finite_flag
from repro_torch.serving.snapshot import model_state_of


def stack_outputs(outs):
    """Normalize engine ``run_stream`` outputs to ONE stacked tree.

    ``LocalEngine`` returns a list of per-step output dicts; the
    ``StreamEngine`` returns a tree stacked on a leading step axis."""
    if isinstance(outs, list):
        if not outs:
            return {}
        return tree_map(lambda *xs: torch.stack(xs), *outs)
    return outs


def unstack_outputs(outs):
    """Inverse of ``stack_outputs``: a stacked tree becomes the
    LocalEngine-shaped list of per-step output dicts."""
    if isinstance(outs, list):
        return outs
    leaves = tree_leaves(outs)
    if not leaves:
        return []
    n = leaves[0].shape[0]
    return [tree_map(lambda x: x[i], outs) for i in range(n)]


@dataclasses.dataclass
class PrequentialResult:
    metric: float            # accuracy (classification) or MAE (regression)
    throughput: float        # instances / second
    curve: list              # per-batch metric
    extra: dict


def _init(learner):
    """``learner.init(PRNGKey(0))``, the key on the learner's device (its
    ``device``, the card when that is None), as the JAX package gives a
    keyed learner its key; ``init()`` for an init that takes none."""
    if not inspect.signature(learner.init).parameters:
        return learner.init()
    return learner.init(prng.PRNGKey(0, getattr(learner, "device", None)))


def _sync(t):
    if isinstance(t, torch.Tensor) and t.is_cuda:
        torch.cuda.synchronize(t.device)


class PrequentialEvaluation(Task):
    """Test-then-train over ``stream`` (an iterable of (x, y) batches).

    The learner's step is compiled (``core.compiled.compile_step``), as the
    JAX package runs ``jax.jit(learner.step)``: on the card one captured
    CUDA graph replayed per batch, on the CPU its capturable form run
    eagerly.  ``compiled=False`` runs ``learner.step`` as it is.  As in the
    JAX package, the first batch is run but left out of the metric, the
    curve and the clock: there it pays for the capture (and for building
    the kernels), and the per-batch metric reads stay.  A batch of another
    shape (a short last batch) is captured anew, as ``jax.jit`` traces
    again.  The learner's ``init`` is given ``PRNGKey(0)``."""

    def __init__(self, learner, stream, *, n_batches: int | None = None,
                 compiled: bool = True):
        self.learner = learner
        self.stream = stream
        self.n_batches = n_batches
        self.compiled = compiled

    def run(self) -> PrequentialResult:
        state = _init(self.learner)
        step = None if self.compiled else self.learner.step
        curve = []
        correct = abse = seen = 0.0
        t0 = None
        for i, (x, y) in enumerate(self.stream):
            if self.n_batches is not None and i >= self.n_batches:
                break
            if step is None:
                step = compile_step(self.learner.step, state, x, y)
            state, m = step(state, x, y)
            if i == 0:
                _sync(m["seen"])
                t0 = time.perf_counter()
                continue
            c = float(m.get("correct", 0.0))
            a = float(m.get("abs_err", 0.0))
            s = float(m["seen"])
            correct += c
            abse += a
            seen += s
            curve.append((c or -a) / s if s else 0.0)
        dt = max(time.perf_counter() - (t0 or time.perf_counter()), 1e-9)
        metric = (correct / seen) if correct else (abse / seen)
        return PrequentialResult(
            metric=metric, throughput=seen / dt, curve=curve,
            extra={"state": state})


def _host(v):
    """A metric leaf as a float64 numpy array (a device read for a CUDA
    tensor; none for a host tensor)."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.asarray(v, np.float64)


def _stage_to_host(tree):
    """(``tree`` with each CUDA leaf's copy into pinned host memory
    enqueued on the current stream, the event recorded after the copies,
    or None when no leaf was on the card).  Waiting on that event waits
    for the work enqueued before it, not for what is enqueued later."""
    on_card = []

    def put(x):
        if not (isinstance(x, torch.Tensor) and x.is_cuda):
            return x
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host.copy_(x, non_blocking=True)
        on_card.append(x.device)
        return host

    out = tree_map(put, tree)
    if not on_card:
        return out, None
    ready = torch.cuda.Event()
    ready.record(torch.cuda.current_stream(on_card[0]))
    return out, ready


class MetricAccumulator:
    """Streaming prequential metric reduction with deferred folding.

    Consumes one chunk's stacked metrics at a time (only ``[chunk_len]``
    scalars ever cross to the host) and keeps running sums and the
    per-batch curve.  Leaves are ``[steps]`` for a single learner, or
    ``[steps, F]`` for a ``LearnerFleet``: then every sum is an ``[F]``
    column per tenant, each curve entry an ``[F]`` row, and no tenant's
    metrics mix.  ``update`` does not synchronize: the chunk's metric
    leaves are kept, device tensors or host copies still being written
    (with the event after which they are complete), and folded, in arrival
    order, the first time a reader needs the numbers (``metric``,
    ``curve``, ``seen``, ``state()``).  The fold is a float64 numpy
    reduction.  ``state()`` / ``load()`` round-trip exactly, so a
    mid-stream checkpoint reproduces the uninterrupted run's final
    metrics.  Thread-safe: the pipelined driver updates it while its drain
    thread flushes forks for checkpoints."""

    def __init__(self):
        # floats for a single learner; [F] float64 columns for a fleet
        self._correct = 0.0
        self._abs_err = 0.0
        self._seen = 0.0
        self._curve: list = []
        self._pending: list = []    # unfolded (metrics dict, ready event)
        self._lock = threading.Lock()

    def update(self, metrics, ready=None):
        """Record one chunk's stacked metrics dict; no host sync here.
        ``ready`` is the CUDA event after which host copies in ``metrics``
        are complete (``_stage_to_host``); the fold waits on it alone.  A
        step of zero weight (in a fleet: a tenant's column) carries the
        prior curve value forward instead of dividing by zero."""
        with self._lock:
            self._pending.append((metrics, ready))

    def _fold(self, metrics, ready):
        if ready is not None:
            ready.synchronize()
        seen = _host(metrics["seen"])
        zeros = np.zeros_like(seen)
        corr = _host(metrics.get("correct", zeros))
        abse = _host(metrics.get("abs_err", zeros))
        signed = np.where(corr > 0, corr, -abse)
        if seen.ndim > 1:                   # [steps, F]: tenant columns
            self._correct = self._correct + corr.sum(axis=0)
            self._abs_err = self._abs_err + abse.sum(axis=0)
            self._seen = self._seen + seen.sum(axis=0)
            prev = (self._curve[-1] if self._curve
                    else np.zeros(seen.shape[1:], np.float64))
            for t in range(seen.shape[0]):
                prev = np.where(seen[t] > 0,
                                signed[t] / np.maximum(seen[t], 1e-9), prev)
                self._curve.append(prev)
            return
        self._correct = float(self._correct + corr.sum())
        self._abs_err = float(self._abs_err + abse.sum())
        self._seen = float(self._seen + seen.sum())
        prev = self._curve[-1] if self._curve else 0.0
        for t in range(seen.shape[0]):
            if seen[t] > 0:
                prev = float(signed[t] / np.maximum(seen[t], 1e-9))
            self._curve.append(prev)

    def flush(self):
        """Fold every pending chunk (in update order): the one place metric
        values cross to the host."""
        with self._lock:
            for m, ready in self._pending:
                self._fold(m, ready)
            self._pending.clear()
        return self

    def fork(self):
        """An accumulator of exactly the chunks updated so far, without a
        flush: the folded numbers and the pending list are copied.  The
        pipelined driver gives forks to its drain thread, so a checkpoint
        written chunks behind the dispatch records its own chunk's
        metrics."""
        out = MetricAccumulator()
        with self._lock:
            out._correct = self._correct
            out._abs_err = self._abs_err
            out._seen = self._seen
            out._curve = list(self._curve)
            out._pending = list(self._pending)
        return out

    @property
    def correct(self):
        return self.flush()._correct

    @property
    def abs_err(self):
        return self.flush()._abs_err

    @property
    def seen(self):
        return self.flush()._seen

    @property
    def curve(self) -> list:
        return self.flush()._curve

    @property
    def metric(self):
        """Running metric: accuracy when correct-counts flowed, MAE
        otherwise; 0.0 before any weight.  A float for a single learner,
        an ``[F]`` vector for a fleet, whose zero-weight columns read 0.0,
        never NaN."""
        self.flush()
        if np.ndim(self._seen) == 0:
            if not self._seen:
                return 0.0
            return self._correct / self._seen if self._correct \
                else self._abs_err / self._seen
        num = np.where(np.asarray(self._correct) > 0, self._correct,
                       self._abs_err)
        return np.where(np.asarray(self._seen) > 0,
                        num / np.maximum(self._seen, 1e-9), 0.0)

    def state(self):
        """Checkpointable tree of the accumulator (float64 numpy)."""
        self.flush()
        return {"correct": np.asarray(self._correct, np.float64),
                "abs_err": np.asarray(self._abs_err, np.float64),
                "seen": np.asarray(self._seen, np.float64),
                "curve": np.asarray(self._curve, np.float64)}

    def load(self, state):
        def num(v):
            v = np.asarray(v, np.float64)
            return float(v) if v.ndim == 0 else v

        with self._lock:
            self._correct = num(state["correct"])
            self._abs_err = num(state["abs_err"])
            self._seen = num(state["seen"])
            curve = np.asarray(state["curve"], np.float64)
            self._curve = ([float(v) for v in curve] if curve.ndim <= 1
                           else list(curve))
            self._pending = []
        return self


def _metrics_only(outs):
    """The chunk outputs the evaluation keeps: the metrics stream."""
    return {"metrics": outs["metrics"]}


@dataclasses.dataclass
class _ChunkTicket:
    """One chunk dispatched and not yet drained: what the drain thread needs
    to finish the chunk's host-side work in order."""

    index: int
    ready: Any            # CUDA event after the chunk's host copies, or None
    flag: Any             # the chunk's finite flag (a host copy), or None
    carry: Any            # the carry after the chunk (the engine's copy)
    outs: Any             # the chunk's outputs, when on_chunk takes them
    chunk: Any            # the Chunk, when on_chunk takes it
    pub_state: Any        # the model state to publish, or None
    acc_fork: Any         # a MetricAccumulator fork for a checkpoint due


class _ChunkDrain:
    """Ordered completion: the host-side work of each chunk (its finite
    check, snapshot publish, checkpoint and ``on_chunk``), in chunk order.

    Pipelined, it runs on one worker thread, with at most ``window`` chunks
    dispatched and not drained (``submit`` waits beyond that).  A ticket
    waits on its own chunk's event, never on the device: the chunks
    dispatched after it keep running.  On the card the work of a ticket
    runs on a CUDA stream of the drain's own.  Work enqueued on the default
    stream would queue behind the chunks dispatched since, and the
    publisher's validation, a host read, would then wait for all of them.
    The host has waited on the chunk's event before, so the ticket's
    tensors are complete; the drain waits for its stream before it drops
    the ticket, so no tensor it read or copied is freed while its stream
    still uses it.  A non-finite flag marks ``poisoned_at`` and every later
    ticket is discarded unprocessed (its checkpoint is not written, its
    snapshot not published); an error raised by a ticket's work is raised
    again on the main loop at the next submit or flush.

    Synchronous (``window`` None), it runs each ticket in the dispatch
    loop as it is submitted, on the current stream; the loop has checked
    the chunk's flag before, and an error is raised at once."""

    def __init__(self, ev, window: int | None):
        self.ev = ev
        self.poisoned_at: int | None = None
        self._worker = (None if window is None
                        else OrderedWorker("chunk-drain", window))
        self._stream = None

    def submit(self, ticket: _ChunkTicket):
        if self._worker is None:
            self._complete(ticket)
        else:
            self._worker.submit(self._process, ticket)

    def flush(self):
        """Wait until every ticket submitted is drained or discarded."""
        if self._worker is not None:
            self._worker.flush()

    def stop(self):
        if self._worker is not None:
            self._worker.stop()

    def has_event(self) -> bool:
        return self.poisoned_at is not None or (
            self._worker is not None and self._worker.failed())

    def _process(self, t: _ChunkTicket):
        if self.poisoned_at is not None:
            return                      # discarded: the run rolls back
        if t.ready is None:
            self._complete(t)
            return
        t.ready.synchronize()           # this chunk's work, nothing later
        if self._stream is None:
            self._stream = torch.cuda.Stream(t.ready.device)
        with torch.cuda.stream(self._stream):
            self._complete(t)
        self._stream.synchronize()

    def _complete(self, t: _ChunkTicket):
        ev = self.ev
        if t.flag is not None and not bool(t.flag):
            self.poisoned_at = t.index
            return
        if t.pub_state is not None:
            ev.publisher.publish(t.index, t.pub_state)
        if t.acc_fork is not None:
            ev._save(t.index, t.carry, t.acc_fork)
        if ev.on_chunk is not None:
            ev.on_chunk(t.outs, t.chunk, t.carry)


# options of the JAX package's evaluation that belong to modules not
# ported yet: the supervisor and elastic re-place (ROADMAP section 1, item
# 6) and distribution (item 10)
_UNPORTED = ("supervisor", "host", "remesh", "chips_per_host",
             "model_parallel", "compile_cache_dir")


class ChunkedPrequentialEvaluation(Task):
    """Prequential task on the chunked stream runtime.

    Drives the port's ``JitEngine``'s chunked runtime one chunk at a time
    (the JAX package's ``engine`` option is not taken: ``LocalEngine`` has
    no chunked driver, so ``JitEngine`` is the one value): metrics reduce
    per chunk through a ``MetricAccumulator`` (no ``[T, ...]`` output tree
    is kept), and a ``CheckpointManager`` (``checkpoint``) snapshots the
    resumable state -- the engine carry (states and feedback), the chunk
    cursor, the stream key and the accumulator -- every
    ``checkpoint_every`` chunks.  ``run(resume=True)`` picks up a killed
    run mid-stream bit for bit: the resumed run's final carry and metrics
    equal the uninterrupted run's.  Each chunk goes through its own
    ``engine.run_stream_chunked`` call; the engine keeps its compiled
    steps, so this costs nothing, and after a rollback the same graphs
    replay on the restored carry.  ``on_chunk(outs, chunk, carry)`` is
    called after each chunk, with the chunk's full outputs.  The stream key
    is ``PRNGKey(0)`` on the learner's device.

    Fault tolerance and serving (each off unless given):

      * ``injector`` (``runtime.chaos.FaultInjector``): its kill, poison
        and delay hooks fire at their chunks;
      * ``check_finite`` (default: on when a checkpoint or an injector is
        given): after each chunk, whether every float leaf of the carry is
        finite; when one is not, the run rolls back to the newest
        checkpoint (or to the initial state from the saved key) and, by
        ``poison_policy``, retries the chunk up to ``max_poison_retries``
        times (``"retry"``) or skips it (``"skip"``); each decision lands
        in the report (``result.extra["report"]``: ``events``,
        ``rollbacks``, ``skipped_chunks``);
      * ``publisher`` (``serving.SnapshotPublisher``, or the chaos proxy):
        the model state after each chunk that passed the finite check is
        published, at the chunk boundary, for a ``ModelServer``.

    ``pipeline`` (default on, as in the JAX package): the host dispatches
    chunk k+1 while the card runs chunk k, and blocks only at stream end,
    at the first chunk (the timestamp that leaves the capture out of the
    clock), at a kill site or a rollback, or when ``max_inflight_chunks``
    chunks are dispatched and not drained.  The finite check becomes a
    flag computed on the card and copied to the host with the chunk's
    metrics behind one event; checkpoints, publishes and ``on_chunk`` run
    in chunk order on a drain thread, which waits on each chunk's event
    alone.  Results are bit for bit the synchronous driver's
    (``pipeline=False``): metrics, curve, carry, checkpoint manifests, and
    the order of kills and poisons.

    The throughput leaves out the first chunk, where the steps are
    captured and the kernels built, as ``PrequentialEvaluation`` leaves out
    its first batch.  The JAX package's ``supervisor``, ``host``,
    ``remesh``, ``chips_per_host``, ``model_parallel`` and
    ``compile_cache_dir`` raise a ``TypeError``: they belong to ROADMAP
    section 1 items 6 and 10, not ported yet."""

    def __init__(self, learner, stream, *, checkpoint=None,
                 checkpoint_every: int = 1, on_chunk=None, injector=None,
                 publisher=None, check_finite: bool | None = None,
                 poison_policy: str = "retry", max_poison_retries: int = 1,
                 pipeline: bool | None = None,
                 max_inflight_chunks: int = 2, **unported):
        from repro_torch.core.engines import JitEngine
        for name in unported:
            if name in _UNPORTED:
                raise TypeError(
                    f"ChunkedPrequentialEvaluation: {name!r} belongs to the "
                    "supervisor, elastic re-place and distribution (ROADMAP "
                    "section 1, items 6 and 10), which the port does not "
                    "have yet")
            raise TypeError(f"ChunkedPrequentialEvaluation got an "
                            f"unexpected keyword argument {name!r}")
        if poison_policy not in ("retry", "skip"):
            raise ValueError(f"unknown poison_policy {poison_policy!r}")
        self.learner = learner
        self.stream = stream
        self.engine = JitEngine()
        self.checkpoint = checkpoint
        self.checkpoint_every = max(1, int(checkpoint_every))
        self.key = prng.PRNGKey(0, getattr(learner, "device", None))
        self.on_chunk = on_chunk
        self.injector = injector
        self.publisher = publisher
        self.check_finite = check_finite
        self.poison_policy = poison_policy
        self.max_poison_retries = max(0, int(max_poison_retries))
        self.pipeline = pipeline
        self.max_inflight_chunks = max(1, int(max_inflight_chunks))
        self.report: dict = {}

    def _save(self, chunk_index: int, carry, acc: MetricAccumulator):
        cursor = chunk_index + 1          # next chunk to run
        self.checkpoint.save(cursor, {
            "carry": carry,
            "cursor": np.int64(cursor),
            "key": self.key,
            "metrics": acc.state(),
        })

    def _restore(self):
        """(carry, cursor, acc) from the newest intact checkpoint, the
        carry and key on the key's device; None when nothing is on disk.
        The writer is joined first: a save still being written counts."""
        if self.checkpoint is None:
            return None
        self.checkpoint.wait()
        if self.checkpoint.latest_step() is None:
            return None
        dev = self.key.device
        blob, _ = self.checkpoint.restore_structured()
        carry = tree_map(lambda a: torch.from_numpy(a).to(dev), blob["carry"])
        self.key = torch.from_numpy(blob["key"]).to(dev)
        acc = MetricAccumulator().load(blob["metrics"])
        return carry, int(blob["cursor"]), acc

    def _rollback(self, poison_chunk: int, skip: set, retries: dict,
                  report: dict, key0):
        """A non-finite carry after ``poison_chunk``: retry it or skip it,
        then go back to the newest checkpoint (or to the initial state when
        there is none).  Returns (carry, cursor, acc)."""
        n = retries.get(poison_chunk, 0)
        if self.poison_policy == "retry" and n < self.max_poison_retries:
            retries[poison_chunk] = n + 1
            decision = "retry"
        else:
            skip.add(poison_chunk)
            report["skipped_chunks"].append(poison_chunk)
            decision = "skip"
        restored = self._restore()
        if restored is not None:
            carry, cursor, acc = restored
        else:
            self.key = key0
            carry = self.engine.init(self.learner, key0)
            cursor = self.stream.start_chunk
            acc = MetricAccumulator()
        report["rollbacks"] += 1
        report["events"].append(("poison", poison_chunk, decision, cursor))
        return carry, cursor, acc

    def _prologue(self, resume: bool):
        """A new report; resume or init.  Returns (report, carry, start
        chunk, acc, instances already seen, whether to check finiteness)."""
        report = {"events": [], "skipped_chunks": [], "rollbacks": 0}
        self.report = report
        acc = MetricAccumulator()
        carry = None
        start = self.stream.start_chunk
        if resume:
            restored = self._restore()
            if restored is not None:
                carry, start, acc = restored
                report["events"].append(("resume", start))
        if carry is None:
            carry = self.engine.init(self.learner, self.key)
        check = self.check_finite
        if check is None:       # on when a recovery can act on it
            check = self.checkpoint is not None or self.injector is not None
        return report, carry, start, acc, float(np.sum(acc.seen)), check

    def _epilogue(self, carry, acc, report, *, t0, timed, seen0, start,
                  end) -> PrequentialResult:
        """Final fence, throughput, the checkpoint writer joined, the
        publisher settled, the source's retries reported."""
        _sync(tree_leaves(carry)[0])
        t_end = time.perf_counter()
        wall = max(t_end - t0, 1e-9)
        seen_total = float(np.sum(acc.seen))
        if len(timed) == 0 or seen_total == timed[0][1]:
            thr = (seen_total - seen0) / wall     # single-chunk stream
        else:
            thr = (seen_total - timed[0][1]) / max(t_end - timed[0][0], 1e-9)
        if self.checkpoint is not None:
            self.checkpoint.wait()
        report["source_retries"] = list(self.stream.retry_events)
        # the events are a ring buffer; the count stays exact
        report["source_retry_count"] = int(self.stream.retry_count)
        report["source_retries_dropped"] = int(
            self.stream.retry_events_dropped)
        if self.publisher is not None:
            self.publisher.flush()
            report["snapshots"] = self.publisher.status()
        return PrequentialResult(
            metric=acc.metric, throughput=thr, curve=acc.curve,
            extra={"carry": carry, "seen": acc.seen,
                   "chunks": end - start, "wall_s": wall,
                   "report": report})

    def _dispatch(self, chunk, carry):
        """Chunk ``chunk`` on the engine from ``carry``, with the injector's
        delay before it and its poison after: (carry, outputs)."""
        inj = self.injector
        if inj is not None:
            inj.maybe_delay(chunk.index)
        carry, outs = self.engine.run_stream_chunked(
            self.learner, carry, [chunk],
            reduce_outputs=_metrics_only if self.on_chunk is None else None)
        if inj is not None:
            # "this chunk's compute blew up": the NaN lands in the carry
            # after the chunk, where the finite check must catch it
            carry = inj.maybe_poison(chunk.index, carry)
        return carry, outs

    def run(self, *, resume: bool = True) -> PrequentialResult:
        """Drive the stream from the newest checkpoint (``resume``) or from
        the start; returns the metric, the throughput, the curve and, in
        ``extra``, the final carry and a report.

        One loop serves both drivers.  Pipelined, the loop does not wait on
        a chunk's results: each chunk's finite flag and metrics are copied
        to pinned host memory behind one event, and a ``_ChunkTicket``
        takes its checkpoint, publish and ``on_chunk`` to the drain thread.
        Synchronous, the loop reads the flag after each chunk and drains
        the ticket in place.  The ticket's carry is the copy
        ``run_stream_chunked`` returns, which no later chunk writes (the
        compiled steps advance buffers of their own), so the drain reads
        the chunk's own state.  Both drivers make the same chunk calls,
        fold in the same order and fail in the same order, so their results
        are bit for bit alike."""
        key0 = self.key
        report, carry, start, acc, seen0, check = self._prologue(resume)
        inj = self.injector
        pipelined = self.pipeline is None or bool(self.pipeline)
        timed: list = []
        skip: set[int] = set()
        retries: dict[int, int] = {}
        end = self.stream.n_chunks
        cursor = start
        t0 = time.perf_counter()
        drain = _ChunkDrain(self, self.max_inflight_chunks if pipelined
                            else None)
        try:
            while cursor < end:
                poisoned_here = None
                it = iter(self.stream.starting_at(cursor))
                try:
                    for chunk in it:
                        if drain.has_event():
                            break       # a poison or an error: fence
                        if chunk.index in skip:
                            report["events"].append(("skip", chunk.index))
                            cursor = chunk.index + 1
                            continue
                        carry, outs = self._dispatch(chunk, carry)
                        flag = carry_finite_flag(carry) if check else None
                        kill_here = (inj is not None and not inj.killed
                                     and inj.kill_at_chunk is not None
                                     and chunk.index == int(inj.kill_at_chunk))
                        if kill_here or (flag is not None and not pipelined):
                            # a fence (the synchronous driver's at every
                            # chunk that is checked): drain first, so that
                            # the checkpoints on disk are the synchronous
                            # run's, then in its order an earlier poison,
                            # this chunk's finite check, the kill
                            drain.flush()
                            if drain.poisoned_at is not None:
                                break
                            if flag is not None and not bool(flag):
                                poisoned_here = chunk.index
                                break
                            flag = None
                            if kill_here:
                                inj.maybe_kill(chunk.index)
                        metrics, ready = outs["metrics"], None
                        if pipelined:
                            (metrics, flag), ready = _stage_to_host(
                                (metrics, flag))
                        acc.update(metrics, ready)
                        if not timed:
                            # the capture left out of the clock: the one
                            # device-wide wait of the loop
                            _sync(tree_leaves(carry)[0])
                            timed.append((time.perf_counter(),
                                          float(np.sum(acc.seen))))
                        save_due = (self.checkpoint is not None and
                                    (chunk.index + 1)
                                    % self.checkpoint_every == 0)
                        with_chunk = self.on_chunk is not None
                        drain.submit(_ChunkTicket(
                            index=chunk.index, ready=ready, flag=flag,
                            carry=carry, outs=outs if with_chunk else None,
                            chunk=chunk if with_chunk else None,
                            pub_state=(model_state_of(carry)
                                       if self.publisher is not None
                                       else None),
                            # forked before the next dispatch: the
                            # checkpoint holds the chunks up to this one
                            acc_fork=acc.fork() if save_due else None))
                        cursor = chunk.index + 1
                finally:
                    close = getattr(it, "close", None)
                    if close is not None:
                        close()     # stop the producer thread now
                drain.flush()
                poisoned = drain.poisoned_at
                if poisoned is None:
                    poisoned = poisoned_here
                if poisoned is not None:
                    # what was dispatched past the poison is discarded:
                    # the rollback replaces the carry, cursor and metrics
                    carry, cursor, acc = self._rollback(
                        poisoned, skip, retries, report, key0)
                    drain.poisoned_at = None
        finally:
            drain.stop()
        return self._epilogue(carry, acc, report, t0=t0, timed=timed,
                              seen0=seen0, start=start, end=end)
