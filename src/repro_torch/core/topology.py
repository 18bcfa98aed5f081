"""The paper's platform layer: Topology / Processor / Stream / groupings.

Port of ``repro/core/topology.py``.  An algorithm is a directed graph of
Processors connected by Streams (section 4 of the paper).  A Processor is a
container for user code with a functional signature; a Stream has one
source and many destinations, each subscribing with a *grouping* (key /
shuffle / all).  A TopologyBuilder wires user code to the platform and
performs the bookkeeping.

Events are dicts of tensors (micro-batched), and processors are
``process(state, events) -> (state, emissions)`` functions.  Cycles are
allowed -- on the StreamEngine, feedback edges deliver their events at the
NEXT engine step, which gives the bounded-staleness semantics used by
VHT's split feedback loop.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Callable


class Grouping(enum.Enum):
    KEY = "key"          # route by key -> model-axis sharding
    SHUFFLE = "shuffle"  # spread uniformly -> data-axis sharding
    ALL = "all"          # broadcast -> replication


@dataclasses.dataclass
class ContentEvent:
    """A message flowing on a stream: named payload of tensors (micro-batch).

    `key` optionally names the field used for key grouping.
    """
    payload: Any
    key: str | None = None


class Processor:
    """Base class: user code container.

    Subclasses implement ``init_state(key)`` and
    ``process(state, inputs) -> (state, {out_stream: payload})`` where
    `inputs` is a dict {in_stream_name: payload-or-None}.
    """

    name: str = "processor"

    # Optional chunk-boundary hook: ``boundary(state) -> state``, run between
    # chunks by the chunked driver (``JitEngine.run_stream_chunked``,
    # ``LocalEngine.run_stream`` of a ChunkedStream); the drivers that are
    # not chunked refuse a topology that sets one.
    boundary: Callable | None = None

    def init_state(self, key):  # pragma: no cover - interface
        return {}

    def process(self, state, inputs):  # pragma: no cover - interface
        raise NotImplementedError

    def state_sharding(self):
        """Sharding hints for a sharded engine.  The port runs on one card
        and has no sharded engine yet, so there are none: ``None``."""
        return None


@dataclasses.dataclass
class Stream:
    name: str
    source: str                       # processor name
    destinations: list[tuple[str, Grouping]] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Topology:
    name: str
    processors: dict[str, Processor]
    streams: dict[str, Stream]
    entry: str                        # name of the source processor
    parallelism: dict[str, int]

    def feedback_edges(self) -> set[str]:
        """Streams that close a cycle (delivered next step)."""
        order = {n: i for i, n in enumerate(self._topo_order())}
        fb = set()
        for s in self.streams.values():
            for dst, _ in s.destinations:
                if order.get(dst, 0) <= order.get(s.source, 0):
                    fb.add(s.name)
        return fb

    def _topo_order(self) -> list[str]:
        """Kahn order ignoring back edges (stable, entry first)."""
        out: list[str] = [self.entry]
        seen = {self.entry}
        frontier = [self.entry]
        while frontier:
            nxt = []
            for src in frontier:
                for s in self.streams.values():
                    if s.source != src:
                        continue
                    for dst, _ in s.destinations:
                        if dst not in seen:
                            seen.add(dst)
                            out.append(dst)
                            nxt.append(dst)
            frontier = nxt
        for n in self.processors:
            if n not in seen:
                out.append(n)
        return out

    def order(self) -> list[str]:
        return self._topo_order()


class TopologyBuilder:
    """Connects user code to the platform (paper section 4)."""

    def __init__(self, name: str = "topology"):
        self._name = name
        self._procs: dict[str, Processor] = {}
        self._streams: dict[str, Stream] = {}
        self._par: dict[str, int] = {}
        self._entry: str | None = None

    def add_processor(self, proc: Processor, *, name: str | None = None,
                      parallelism: int = 1, entry: bool = False):
        name = name or proc.name
        if name in self._procs:
            raise ValueError(f"duplicate processor {name!r}")
        self._procs[name] = proc
        self._par[name] = parallelism
        if entry or self._entry is None:
            self._entry = name
        return name

    def create_stream(self, name: str, source: str) -> str:
        if name in self._streams:
            raise ValueError(f"duplicate stream {name!r}")
        if source not in self._procs:
            raise ValueError(f"unknown source {source!r}")
        self._streams[name] = Stream(name=name, source=source)
        return name

    def connect_via(self, stream: str, dest: str, grouping: Grouping):
        if dest not in self._procs:
            raise ValueError(f"unknown destination {dest!r}")
        self._streams[stream].destinations.append((dest, grouping))
        return self

    # sugar matching the paper's snippet
    def connect_key(self, stream, dest):
        return self.connect_via(stream, dest, Grouping.KEY)

    def connect_shuffle(self, stream, dest):
        return self.connect_via(stream, dest, Grouping.SHUFFLE)

    def connect_all(self, stream, dest):
        return self.connect_via(stream, dest, Grouping.ALL)

    def build(self) -> Topology:
        entry = self._entry or next(iter(self._procs))
        return Topology(
            name=self._name,
            processors=dict(self._procs),
            streams=dict(self._streams),
            entry=entry,
            parallelism=dict(self._par),
        )


class Task:
    """Execution entity (paper section 4): a Topology + evaluation logic.

    ``PrequentialEvaluation`` in repro_torch.core.evaluation is the
    canonical one.
    """

    def topology(self) -> Topology:  # pragma: no cover - interface
        raise NotImplementedError


class LearnerProcessor(Processor):
    """Adapts any learner (``init(key?) -> state``,
    ``step(state, x[, y]) -> (state, metrics)``) to the platform, so the
    engines run its stream exactly like a hand-wired topology.  Payloads
    are ``{"x": ..., "y": ...}`` dicts (``y`` optional, e.g. clustering);
    metrics emit on the task-level "metrics" stream.
    """

    def __init__(self, learner, name: str | None = None):
        self.learner = learner
        self.name = name or type(learner).__name__.lower()
        # chunk-boundary hook: delegate iff the learner has one, so the
        # chunked driver's `boundary is None` fast path stays cheap for
        # learners without boundary-phase work
        fn = getattr(learner, "boundary", None)
        if fn is not None:
            self.boundary = fn

    def init_state(self, key):
        return self.learner.init(key)

    def process(self, state, inputs):
        src = inputs.get("__source__")
        if src is None:
            return state, {}
        args = [src[k] for k in ("x", "y") if k in src]
        state, metrics = self.learner.step(state, *args)
        return state, {"metrics": metrics}


def build_learner_topology(learner, name: str | None = None) -> Topology:
    """Single-processor topology around a learner -- the bridge that lets
    the engines run any learner's stream, not just the hand-built VHT
    graph."""
    proc = LearnerProcessor(learner, name=name)
    b = TopologyBuilder(proc.name)
    b.add_processor(proc, entry=True)
    b.create_stream("metrics", proc.name)
    return b.build()
