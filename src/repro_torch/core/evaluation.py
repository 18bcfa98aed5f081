"""PrequentialEvaluation -- the paper's canonical Task (section 4).

Port of ``repro/core/evaluation.py``: "a classification task where each
instance is used for testing first, and then for training."  Wires a
stream source, any learner exposing ``init``/``step``, and an evaluator
that accumulates interleaved test-then-train metrics.
``PrequentialEvaluation`` runs a stream of batches;
``ChunkedPrequentialEvaluation`` runs a ``ChunkedStream`` on the chunked
runtime, with mid-stream checkpoints that resume bit for bit, and reduces
its metrics through a ``MetricAccumulator``.  Its synchronous driver is
ported; the JAX package's pipelined driver and its fault-tolerance hooks
(finite check and rollback, supervisor, elastic re-place, snapshot
publishing) are not yet.
"""

from __future__ import annotations

import dataclasses
import inspect
import time

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.compiled import compile_step
from repro_torch.core.pytree import tree_leaves, tree_map
from repro_torch.core.topology import Task


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
    tensor)."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.asarray(v, np.float64)


class MetricAccumulator:
    """Streaming prequential metric reduction with deferred folding.

    Consumes one chunk's stacked metrics at a time (only ``[chunk_len]``
    scalars ever cross to the host) and keeps running sums and the
    per-batch curve.  ``update`` does not synchronize: the chunk's metric
    leaves stay device tensors and are folded, in arrival order, the first
    time a reader needs the numbers (``metric``, ``curve``, ``seen``,
    ``state()``).  The fold is a float64 numpy reduction.  ``state()`` /
    ``load()`` round-trip exactly, so a mid-stream checkpoint reproduces
    the uninterrupted run's final metrics."""

    def __init__(self):
        self._correct = 0.0
        self._abs_err = 0.0
        self._seen = 0.0
        self._curve: list = []
        self._pending: list = []       # unfolded per-chunk metric dicts

    def update(self, metrics):
        """Record one chunk's stacked metrics dict; no host sync here.  A
        step of zero weight carries the prior curve value forward instead
        of dividing by zero."""
        self._pending.append(metrics)

    def _fold(self, metrics):
        seen = _host(metrics["seen"])
        zeros = np.zeros_like(seen)
        corr = _host(metrics.get("correct", zeros))
        abse = _host(metrics.get("abs_err", zeros))
        self._correct = float(self._correct + corr.sum())
        self._abs_err = float(self._abs_err + abse.sum())
        self._seen = float(self._seen + seen.sum())
        signed = np.where(corr > 0, corr, -abse)
        prev = self._curve[-1] if self._curve else 0.0
        for t in range(seen.shape[0]):
            if seen[t] > 0:
                prev = float(signed[t] / np.maximum(seen[t], 1e-9))
            self._curve.append(prev)

    def flush(self):
        """Fold every pending chunk (in update order): the one place metric
        values cross to the host."""
        for m in self._pending:
            self._fold(m)
        self._pending.clear()
        return self

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
    def metric(self) -> float:
        """Running metric: accuracy when correct-counts flowed, MAE
        otherwise; 0.0 before any weight."""
        self.flush()
        if not self._seen:
            return 0.0
        return self._correct / self._seen if self._correct \
            else self._abs_err / self._seen

    def state(self):
        """Checkpointable tree of the accumulator (float64 numpy)."""
        self.flush()
        return {"correct": np.asarray(self._correct, np.float64),
                "abs_err": np.asarray(self._abs_err, np.float64),
                "seen": np.asarray(self._seen, np.float64),
                "curve": np.asarray(self._curve, np.float64)}

    def load(self, state):
        self._correct = float(state["correct"])
        self._abs_err = float(state["abs_err"])
        self._seen = float(state["seen"])
        self._curve = [float(v) for v in np.asarray(state["curve"],
                                                    np.float64)]
        self._pending = []
        return self


def _metrics_only(outs):
    """The chunk outputs the evaluation keeps: the metrics stream."""
    return {"metrics": outs["metrics"]}


class ChunkedPrequentialEvaluation(Task):
    """Prequential task on the chunked stream runtime (the JAX package's
    synchronous driver, ``pipeline=False``).

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
    steps, so this costs nothing.  ``on_chunk(outs, chunk, carry)`` is
    called after each chunk, with the chunk's full outputs.  The stream key
    is ``PRNGKey(0)`` on the learner's device.

    The throughput leaves out the first chunk, where the steps are
    captured and the kernels built, as ``PrequentialEvaluation`` leaves out
    its first batch."""

    def __init__(self, learner, stream, *, checkpoint=None,
                 checkpoint_every: int = 1, on_chunk=None):
        from repro_torch.core.engines import JitEngine
        self.learner = learner
        self.stream = stream
        self.engine = JitEngine()
        self.checkpoint = checkpoint
        self.checkpoint_every = max(1, int(checkpoint_every))
        self.key = prng.PRNGKey(0, getattr(learner, "device", None))
        self.on_chunk = on_chunk
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
        carry and key on the key's device; None when nothing is on disk."""
        if self.checkpoint is None or self.checkpoint.latest_step() is None:
            return None
        dev = self.key.device
        blob, _ = self.checkpoint.restore_structured()
        carry = tree_map(lambda a: torch.from_numpy(a).to(dev), blob["carry"])
        self.key = torch.from_numpy(blob["key"]).to(dev)
        acc = MetricAccumulator().load(blob["metrics"])
        return carry, int(blob["cursor"]), acc

    def _prologue(self, resume: bool, report: dict):
        """Resume or init.  Returns (carry, start chunk, acc, instances
        already seen)."""
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
        return carry, start, acc, float(np.sum(acc.seen))

    def _epilogue(self, carry, acc, report, *, t0, timed, seen0, start,
                  end) -> PrequentialResult:
        """Final fence, throughput, the checkpoint writer joined, the
        source's retries reported."""
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
        return PrequentialResult(
            metric=acc.metric, throughput=thr, curve=acc.curve,
            extra={"carry": carry, "seen": acc.seen,
                   "chunks": end - start, "wall_s": wall,
                   "report": report})

    def run(self, *, resume: bool = True) -> PrequentialResult:
        """Drive the stream from the newest checkpoint (``resume``) or from
        the start; returns the metric, the throughput, the curve and, in
        ``extra``, the final carry and a report."""
        report = {"events": []}
        self.report = report
        carry, start, acc, seen0 = self._prologue(resume, report)
        reducer = _metrics_only if self.on_chunk is None else None
        timed: list = []
        end = self.stream.n_chunks
        t0 = time.perf_counter()
        it = iter(self.stream.starting_at(start))
        try:
            for chunk in it:
                carry, outs = self.engine.run_stream_chunked(
                    self.learner, carry, [chunk], reduce_outputs=reducer)
                acc.update(outs["metrics"])
                if not timed:
                    _sync(tree_leaves(carry)[0])
                    timed.append((time.perf_counter(),
                                  float(np.sum(acc.seen))))
                if self.checkpoint is not None \
                        and (chunk.index + 1) % self.checkpoint_every == 0:
                    self._save(chunk.index, carry, acc)
                if self.on_chunk is not None:
                    self.on_chunk(outs, chunk, carry)
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                close()     # stop the producer thread now
        return self._epilogue(carry, acc, report, t0=t0, timed=timed,
                              seen0=seen0, start=start, end=end)
