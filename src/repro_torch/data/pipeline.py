"""Streaming data pipeline: generator -> micro-batches on the device, and
the chunked stream source.

Port of ``repro/data/pipeline.py`` without its sharding arguments.
``StreamPipeline``'s generator samples on the device, so there is no host
prefetch thread: each batch is a few asynchronous kernel launches.
``ChunkedStream`` is the bounded-memory source of the chunked runtime: an
iterator of fixed-shape ``[chunk_len, ...]`` payload chunks (the last one
zero-padded, with its valid length), made by a producer thread one or two
chunks ahead.  The producer stages a chunk that lies in host memory on the
card: pinned, copied on a side stream of its own, which the consuming
stream waits on before it reads the chunk.
"""

from __future__ import annotations

import collections
import dataclasses
import queue
import threading
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.pytree import tree_leaves, tree_map
from repro_torch.data.generators import bin_numeric
from repro_torch.device import resolve_device


PREFETCH = 2            # chunks a producer stages ahead of the consumer
RETRIES = 3             # default retries of a chunk's fetch before it is lost
BACKOFF_S = 0.05        # default first retry's backoff; doubles per attempt
BACKOFF_CAP_S = 5.0     # ... up to this
RETRY_EVENTS_CAP = 256  # default retry events kept (the count stays exact)


class StreamPipeline:
    """Prequential micro-batch stream of (x, y), x binned to ``n_bins``
    when that is not 0, drawn from a ``torch.Generator`` seeded with
    ``seed`` on ``device``.  With ``classification`` (the default) a
    generator's ``sample_classification`` is taken where it has one."""

    def __init__(self, gen, batch: int, n_batches: int, *, n_bins: int = 0,
                 seed: int = 0, classification: bool = True, device=None):
        self.gen = gen
        self.batch = batch
        self.n_batches = n_batches
        self.n_bins = n_bins
        self.seed = seed
        self.classification = classification
        self.device = device

    def __iter__(self):
        g = torch.Generator(device=resolve_device(self.device))
        g.manual_seed(self.seed)
        sample = getattr(self.gen, "sample_classification", None)
        if not self.classification or sample is None:
            sample = self.gen.sample
        for _ in range(self.n_batches):
            x, y = sample(g, self.batch)
            if self.n_bins:
                x = bin_numeric(x, self.n_bins)
            yield x, y


    def materialize(self):
        """Stack the whole stream: (x [T, B, ...], y [T, B])."""
        xs, ys = [], []
        for x, y in self:
            xs.append(x)
            ys.append(y)
        return torch.stack(xs), torch.stack(ys)


class TransientSourceError(RuntimeError):
    """A retryable stream-source failure (a dropped connection, a
    throttled broker): ``ChunkedStream`` retries the fetch with capped
    exponential backoff before declaring the chunk lost."""


class StreamSourceError(RuntimeError):
    """A chunk could not be produced: the transient-retry budget ran out.
    Carries the failing chunk index."""

    def __init__(self, chunk_index: int, attempts: int, cause):
        super().__init__(
            f"stream source failed on chunk {chunk_index} after "
            f"{attempts} attempt{'s' if attempts != 1 else ''}: {cause!r}")
        self.chunk_index = int(chunk_index)
        self.attempts = int(attempts)


# the source errors a fetch is retried on
TRANSIENT = (TransientSourceError, ConnectionError, TimeoutError)


@dataclasses.dataclass
class Chunk:
    """One fixed-shape slice of a stream.

    ``payload`` leaves have leading dimension ``chunk_len`` (the last chunk
    of a stream whose length the chunk size does not divide is zero-padded
    up to it); ``valid`` is the ``[chunk_len]`` bool mask of real steps and
    ``length`` their count.  ``ready`` is the CUDA event the chunk's copy
    to the card recorded (None when nothing was copied): ``wait()`` makes
    the current stream wait on it before the chunk is read."""

    index: int          # chunk position in the stream
    payload: Any        # tree, leaves [chunk_len, ...]
    valid: Any          # [chunk_len] bool, True for real steps
    length: int         # number of valid (un-padded) steps
    ready: Any = None

    @property
    def chunk_len(self) -> int:
        return int(tree_leaves(self.payload)[0].shape[0])

    @property
    def padded(self) -> bool:
        return self.length < self.chunk_len

    def wait(self) -> "Chunk":
        """Order the current stream after the chunk's copy to the card; the
        staged tensors are then in use on that stream too."""
        if self.ready is not None:
            current = torch.cuda.current_stream(self.ready.device)
            current.wait_event(self.ready)
            for t in tree_leaves((self.payload, self.valid)):
                t.record_stream(current)
            self.ready = None
        return self


def _as_tensor(x):
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))


def _pad_chunk(index: int, payload, chunk_len: int) -> Chunk:
    """Zero-pad a raw (possibly short, final) payload up to chunk_len."""
    payload = tree_map(_as_tensor, payload)
    length = int(tree_leaves(payload)[0].shape[0])
    if length > chunk_len:
        raise ValueError(f"chunk {index} has {length} steps > {chunk_len}")
    if length == 0:
        # an all-padding chunk would feed fabricated zeros through the
        # feedback-priming step of a fresh stream; require >= 1 real step
        raise ValueError(f"chunk {index} has 0 steps")
    if length < chunk_len:
        pad = chunk_len - length
        payload = tree_map(lambda x: torch.cat(
            [x, x.new_zeros((pad,) + tuple(x.shape[1:]))], 0), payload)
    dev = tree_leaves(payload)[0].device
    valid = torch.arange(chunk_len, device=dev) < length
    return Chunk(index=index, payload=payload, valid=valid, length=length)


def _stage(chunk: Chunk, device, side) -> Chunk:
    """The chunk's leaves that are not on ``device`` copied there.  To the
    card: from pinned memory, on the ``side`` stream, whose event the
    chunk carries."""
    if device.type != "cuda":
        return dataclasses.replace(chunk, payload=tree_map(
            lambda x: x.to(device), chunk.payload), valid=chunk.valid.to(
                device))
    with torch.cuda.stream(side):
        def put(x):
            if x.device == device:
                return x
            return x.pin_memory().to(device, non_blocking=True)
        payload, valid = tree_map(put, (chunk.payload, chunk.valid))
        ready = torch.cuda.Event()
        ready.record(side)
    return dataclasses.replace(chunk, payload=payload, valid=valid,
                               ready=ready)


class ChunkedStream:
    """Bounded-memory stream source: fixed-shape payload chunks, prefetched.

    Materializing the whole stream as a stacked ``[T, ...]`` tree caps T at
    device memory; a ChunkedStream yields ``Chunk``s of ``chunk_len`` steps
    instead.  A producer thread fetches chunk k+1 and stages it on
    ``device`` while chunk k runs, so the card holds ``PREFETCH`` chunks of
    payload beyond the one in use.

    Two constructions:

      * ``ChunkedStream(payloads, chunk_len)`` -- split an already stacked
        payload tree (or list of per-step payloads) into chunks;
      * ``ChunkedStream.from_fn(fn, n_chunks, chunk_len)`` -- ``fn(i)``
        produces chunk i's raw payload (leaves ``[<=chunk_len, ...]``) on
        demand, so the full stream never exists anywhere.

    ``device`` is where chunks go (``None``: the card); ``to_device=False``
    leaves them where the source made them.  ``starting_at(k)`` is a view
    beginning at chunk k (mid-stream resume).  Each ``__iter__`` starts a
    producer, which the iterator stops and joins when it ends, is closed
    or is dropped.  A fetch that raises one of ``TRANSIENT`` is retried up
    to ``retries`` times (default ``RETRIES``), after a backoff doubling
    from ``backoff`` (``BACKOFF_S``) up to ``backoff_cap``
    (``BACKOFF_CAP_S``) with a jitter that is the same for the same (chunk,
    attempt); then the chunk is lost (``StreamSourceError``).  Each retry
    is logged in ``retry_events`` as (chunk, attempt, slept s, error): a
    ring buffer of the newest ``retry_events_cap`` events, while
    ``retry_count`` stays exact and ``retry_events_dropped`` counts the
    events pushed out.  ``starting_at`` views share the buffer and both
    counts.
    """

    def __init__(self, payloads=None, chunk_len: int = 0, *,
                 fetch: Callable[[int], Any] | None = None,
                 n_chunks: int | None = None, device=None,
                 to_device: bool = True, retries: int | None = None,
                 backoff: float | None = None,
                 backoff_cap: float | None = None,
                 retry_events_cap: int = RETRY_EVENTS_CAP):
        if chunk_len < 1:
            raise ValueError(f"chunk_len must be >= 1, got {chunk_len}")
        if retry_events_cap < 1:
            raise ValueError(
                f"retry_events_cap must be >= 1, got {retry_events_cap}")
        self.chunk_len = int(chunk_len)
        self.start_chunk = 0
        self.device = device
        self.to_device = to_device
        self.retries = max(0, int(RETRIES if retries is None else retries))
        self.backoff = float(BACKOFF_S if backoff is None else backoff)
        self.backoff_cap = float(BACKOFF_CAP_S if backoff_cap is None
                                 else backoff_cap)
        self.retry_events: collections.deque = collections.deque(
            maxlen=int(retry_events_cap))
        # one cell and one lock that starting_at views share with the
        # stream, so that the append and both counts move together
        self._retry_stats = {"count": 0, "dropped": 0}
        self._retry_lock = threading.Lock()
        if fetch is not None:
            if n_chunks is None:
                raise ValueError("from_fn streams need n_chunks")
            self._fetch = fetch
            self.n_chunks = int(n_chunks)
        else:
            if hasattr(payloads, "__next__"):
                payloads = list(payloads)
            if isinstance(payloads, list):
                payloads = tree_map(lambda *xs: torch.stack(
                    [_as_tensor(x) for x in xs]), *payloads)
            t = int(tree_leaves(payloads)[0].shape[0])
            self.n_chunks = -(-t // self.chunk_len)
            cl = self.chunk_len
            self._fetch = lambda i, _p=payloads: tree_map(
                lambda x: x[i * cl:(i + 1) * cl], _p)

    @classmethod
    def from_fn(cls, fn: Callable[[int], Any], n_chunks: int,
                chunk_len: int, **kw) -> "ChunkedStream":
        """Generator-backed stream: ``fn(chunk_index)`` -> raw payload of
        up to ``chunk_len`` steps.  Nothing is materialized beyond the
        prefetch window."""
        return cls(fetch=fn, n_chunks=n_chunks, chunk_len=chunk_len, **kw)

    def starting_at(self, chunk: int) -> "ChunkedStream":
        """A view of the same stream beginning at `chunk` (resume)."""
        out = ChunkedStream.__new__(ChunkedStream)
        out.__dict__.update(self.__dict__)
        if not (0 <= chunk <= self.n_chunks):
            raise ValueError(f"start chunk {chunk} outside "
                             f"[0, {self.n_chunks}]")
        out.start_chunk = int(chunk)
        return out

    def _fetch_retry(self, i: int):
        attempt = 0
        while True:
            try:
                return self._fetch(i)
            except TRANSIENT as e:
                attempt += 1
                if attempt > self.retries:
                    raise StreamSourceError(i, attempt, e) from e
                delay = min(self.backoff * (2 ** (attempt - 1)),
                            self.backoff_cap)
                rng = np.random.default_rng((int(i) + 1) * 1_000_003
                                            + attempt)
                delay *= float(rng.uniform(0.5, 1.0))
                with self._retry_lock:
                    if len(self.retry_events) == self.retry_events.maxlen:
                        self._retry_stats["dropped"] += 1
                    self.retry_events.append((int(i), attempt, delay,
                                              repr(e)))
                    self._retry_stats["count"] += 1
                time.sleep(delay)

    def _produce(self, q, stop, device):
        def put(item) -> bool:
            # a bounded put that gives up when the consumer stopped, so the
            # thread never blocks on a full queue
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        try:
            side = (torch.cuda.Stream(device)
                    if device is not None and device.type == "cuda" else None)
            for i in range(self.start_chunk, self.n_chunks):
                if stop.is_set():
                    return
                chunk = _pad_chunk(i, self._fetch_retry(i), self.chunk_len)
                if device is not None:
                    chunk = _stage(chunk, device, side)
                if not put(chunk):
                    return
            put(None)
        except Exception as e:  # raised again on the consumer's side
            put(e)

    def __iter__(self):
        device = resolve_device(self.device) if self.to_device else None
        if device is not None and device.type == "cuda" \
                and device.index is None:
            # "cuda" names the current card: a payload already there is
            # taken as it is, not staged through pinned memory
            device = torch.device("cuda", torch.cuda.current_device())
        q: queue.Queue = queue.Queue(maxsize=PREFETCH)
        stop = threading.Event()
        t = threading.Thread(target=self._produce, args=(q, stop, device),
                             name="chunked-stream", daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item.wait()
        finally:
            stop.set()
            t.join()

    @property
    def retry_count(self) -> int:
        """Retried fetches, all of them (the ring buffer keeps the newest
        ``retry_events_cap``)."""
        with self._retry_lock:
            return self._retry_stats["count"]

    @property
    def retry_events_dropped(self) -> int:
        """Retry events pushed out of the ring buffer."""
        with self._retry_lock:
            return self._retry_stats["dropped"]

    def __len__(self):
        return self.n_chunks - self.start_chunk
