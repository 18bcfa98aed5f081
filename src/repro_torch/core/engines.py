"""Execution engines: the DSPE-adapter layer of the paper, in PyTorch.

Port of three engines of ``repro/core/engines.py``; the same Topology runs
on each:

  LocalEngine   -- one micro-batch at a time, feedback delivered within the
                   same step until quiescence (split feedback delay D = 0):
                   the paper's 'local' sequential engine.
  StreamEngine  -- the semantics of the JAX package's monolithic
                   ``JitEngine.step``/``run_stream``: feedback edges are
                   carried and delivered at the NEXT step (delay D = 1), and
                   the first step, with no feedback yet, primes the carry.
                   PyTorch runs it eagerly, step by step; the outputs are
                   stacked on a leading step axis as the JAX scan stacks
                   them.
  JitEngine     -- the same semantics with each step after the first one
                   captured CUDA graph (``core.compiled``): the port's
                   counterpart of the JAX ``JitEngine``.  ``StreamEngine``
                   stays as its eager reference.

Each accepts a Topology or a bare learner (``init``/``step``), which is
wrapped in a one-processor topology.  ``run_stream`` clones the states it
is given first, because processors update large tensors in place.

The chunked stream runtime: ``JitEngine.run_stream_chunked`` drives the
same steps chunk by chunk from a ``data.pipeline.ChunkedStream`` and fires
the processors' ``boundary`` hooks between chunks (one compiled boundary
step); ``LocalEngine.run_stream`` takes a ``ChunkedStream`` too, as the
eager oracle.  Every other driver refuses a topology with boundary hooks,
which it would never fire.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.core import prng
from repro_torch.core.compiled import compile_step
from repro_torch.core.pytree import tree_clone, tree_leaves, tree_map
from repro_torch.core.topology import Topology, build_learner_topology
from repro_torch.data.pipeline import ChunkedStream


def _as_topology(topology) -> Topology:
    if isinstance(topology, Topology):
        return topology
    return build_learner_topology(topology)


def _init_states(topology: Topology, key):
    """Each processor's state from its own key, ``split(key, n)[i]`` as the
    JAX package gives them, or from ``None`` (its default) for none."""
    procs = topology.processors.items()
    if key is None:
        return {n: p.init_state(None) for n, p in procs}
    keys = prng.split(key, len(topology.processors))
    return {n: p.init_state(k) for (n, p), k in zip(procs, keys)}


def _unstack_payloads(payloads):
    """A list (or iterator) is a per-step payload sequence; a dict of
    tensors is taken as stacked on a leading step axis."""
    if hasattr(payloads, "__next__"):
        payloads = list(payloads)
    if isinstance(payloads, list):
        return payloads
    n = tree_leaves(payloads)[0].shape[0]
    return [tree_map(lambda x: x[i], payloads) for i in range(n)]


def _require_no_boundaries(topology: Topology):
    """A topology with chunk-boundary hooks on a driver that is not chunked
    would never fire them (boundary-mode CluStream's macro centroids would
    stay at init): fail loudly instead."""
    names = [n for n, p in topology.processors.items()
             if p.boundary is not None]
    if names:
        raise ValueError(
            f"processors {names} have chunk-boundary hooks, which only "
            "fire on the chunked driver: pass a ChunkedStream or "
            "chunk_len= to run_stream (or use a boundary-free config, "
            "e.g. CluStream macro_impl='step')")


def _boundary_hooks(topology: Topology) -> dict:
    return {n: p.boundary for n, p in topology.processors.items()
            if p.boundary is not None}


def _apply_boundaries(hooks: dict, states):
    """Each processor's ``boundary`` hook applied to its state."""
    states = dict(states)
    for name, hook in hooks.items():
        states[name] = hook(states[name])
    return states


def _close_iter(it):
    """Stop a chunk iterator now (its producer thread with it), not when
    it is collected."""
    close = getattr(it, "close", None)
    if close is not None:
        close()


def _concat_outputs(segments):
    """Per-chunk outputs, each stacked on a leading step axis, as one."""
    if not segments:
        return {}
    if len(segments) == 1:
        return segments[0]
    return tree_map(lambda *xs: torch.cat(xs, 0), *segments)


def _live_steps(chunk):
    """The chunk's real (un-padded) steps, one payload each."""
    return [tree_map(lambda x: x[i], chunk.payload)
            for i in range(chunk.length)]


class LocalEngine:
    """Sequential reference engine (paper: the local execution engine).

    Feedback loops are iterated to quiescence inside each step: split
    decisions reach the model before the next micro-batch (delay 0).
    """

    def __init__(self, max_feedback_iters: int = 4):
        self.max_feedback_iters = max_feedback_iters

    def init(self, topology, key=None):
        return _init_states(_as_topology(topology), key)

    def run_stream(self, topology, states, payloads):
        """Eager per-step loop.  Returns (states, list of per-step
        outputs); ``repro_torch.core.evaluation.stack_outputs`` stacks the
        list.  ``states`` is cloned first and left as it was.

        A ``ChunkedStream`` is taken too: its real steps run eagerly and
        the processors' ``boundary`` hooks fire between chunks, the eager
        oracle of the chunked driver."""
        topology = _as_topology(topology)
        states = tree_clone(states)
        outs = []
        if isinstance(payloads, ChunkedStream):
            hooks = _boundary_hooks(topology)
            it = iter(payloads)
            try:
                for chunk in it:
                    for payload in _live_steps(chunk):
                        states, out = self.step(topology, states, payload)
                        outs.append(out)
                    states = _apply_boundaries(hooks, states)
            finally:
                _close_iter(it)
            return states, outs
        _require_no_boundaries(topology)
        for payload in _unstack_payloads(payloads):
            states, out = self.step(topology, states, payload)
            outs.append(out)
        return states, outs

    def step(self, topology, states, source_payload):
        topology = _as_topology(topology)
        order = topology.order()
        inboxes: dict[str, dict] = {n: {} for n in topology.processors}
        inboxes[topology.entry]["__source__"] = source_payload
        outputs: dict[str, Any] = {}
        for _ in range(self.max_feedback_iters):
            progressed = False
            for name in order:
                inbox = inboxes[name]
                if not inbox:
                    continue
                proc = topology.processors[name]
                states[name], emits = proc.process(states[name], inbox)
                inboxes[name] = {}
                progressed = True
                for stream_name, payload in (emits or {}).items():
                    if payload is None:
                        continue
                    stream = topology.streams.get(stream_name)
                    if stream is None:
                        outputs[stream_name] = payload  # task-level sink
                        continue
                    sunk = False
                    for dst, _ in stream.destinations:
                        inboxes[dst][stream_name] = payload
                        sunk = True
                    if not sunk:
                        outputs[stream_name] = payload
            if not progressed:
                break
        return states, outputs


class StreamEngine:
    """Whole-topology step with feedback edges delivered next step
    (bounded staleness D = 1, the deterministic analogue of DSPE queueing
    delay): the eager counterpart of the JAX package's ``JitEngine``
    (``step`` and the monolithic ``run_stream``)."""

    def init(self, topology, key=None):
        states = _init_states(_as_topology(topology), key)
        return {"states": states, "feedback": None}

    def step(self, topology, carry, source_payload):
        topology = _as_topology(topology)
        fb_edges = topology.feedback_edges()
        inboxes: dict[str, dict] = {n: {} for n in topology.processors}
        inboxes[topology.entry]["__source__"] = source_payload
        # deliver last step's feedback first
        for stream_name, payload in (carry["feedback"] or {}).items():
            for dst, _ in topology.streams[stream_name].destinations:
                inboxes[dst][stream_name] = payload
        states = dict(carry["states"])
        outputs: dict[str, Any] = {}
        feedback: dict[str, Any] = {}
        for name in topology.order():
            proc = topology.processors[name]
            states[name], emits = proc.process(states[name], inboxes[name])
            for stream_name, payload in (emits or {}).items():
                if payload is None:
                    continue
                if stream_name in fb_edges:
                    feedback[stream_name] = payload
                    continue
                stream = topology.streams.get(stream_name)
                if stream is None or not stream.destinations:
                    outputs[stream_name] = payload
                    continue
                for dst, _ in stream.destinations:
                    inboxes[dst][stream_name] = payload
        return {"states": states, "feedback": feedback}, outputs

    def run_stream(self, topology, carry, payloads):
        """Run every micro-batch of ``payloads`` (a list of per-step
        payloads, or a dict stacked on a leading step axis).  Returns
        (carry, outputs stacked on the leading axis), as the JAX
        ``JitEngine.run_stream`` does.  ``carry`` is cloned first and left
        as it was."""
        topology = _as_topology(topology)
        _require_no_boundaries(topology)
        carry = tree_clone(carry)
        outs = []
        for payload in _unstack_payloads(payloads):
            carry, out = self.step(topology, carry, payload)
            outs.append(out)
        if not outs:
            return carry, {}
        return carry, tree_map(lambda *xs: torch.stack(xs), *outs)


class JitEngine:
    """The JAX package's ``JitEngine``: the whole topology step with
    feedback edges delivered next step.  The first step, with no feedback
    yet, runs eagerly and primes the carry, as the JAX engine's
    ``_prime_first_step`` runs it through its plain jitted step.  Every
    later step replays one captured topology step (``core.compiled.
    compile_step``, captured at the first of them and kept per topology),
    whose gates are conds on the device; on the CPU that step runs eagerly
    in its capturable form.

    ``step`` returns the captured step's own carry, which the next step of
    the same topology advances in place (what ``donate_argnums`` does in
    the JAX engine); ``run_stream`` and ``run_stream_chunked`` return a
    copy.

    The chunked runtime (``run_stream_chunked``, or ``run_stream`` given a
    ``ChunkedStream`` or ``chunk_len``): a chunk is its real steps, each a
    replay of the captured step (a padded tail chunk replays only its real
    steps, as JAX's masked scan makes its padded steps no-ops), then, where
    a processor has a ``boundary`` hook, one replay of the compiled
    boundary step (captured at the first boundary, kept per topology)."""

    def __init__(self):
        self._eager = StreamEngine()
        # id -> (the object, so the id stays its own, and what it maps to)
        self._topologies: dict[int, tuple] = {}
        self._compiled: dict[int, tuple] = {}
        self._boundaries: dict[int, tuple] = {}

    def _topology(self, topology) -> Topology:
        if isinstance(topology, Topology):
            return topology
        if id(topology) not in self._topologies:
            self._topologies[id(topology)] = (
                topology, build_learner_topology(topology))
        return self._topologies[id(topology)][1]

    def init(self, topology, key=None):
        return self._eager.init(self._topology(topology), key)

    def step(self, topology, carry, source_payload):
        topology = self._topology(topology)
        if carry["feedback"] is None:
            return self._eager.step(topology, carry, source_payload)
        entry = self._compiled.get(id(topology))
        if entry is None:
            entry = (topology, compile_step(
                lambda c, p: self._eager.step(topology, c, p),
                carry, source_payload))
            self._compiled[id(topology)] = entry
        return entry[1](carry, source_payload)

    def _boundary(self, topology, carry):
        """The processors' ``boundary`` hooks on ``carry``, as one compiled
        step; the carry as it is when no processor has one."""
        hooks = _boundary_hooks(topology)
        if not hooks:
            return carry
        entry = self._boundaries.get(id(topology))
        if entry is None:
            entry = (topology, compile_step(lambda c: (
                {"states": _apply_boundaries(hooks, c["states"]),
                 "feedback": c["feedback"]}, {}), carry))
            self._boundaries[id(topology)] = entry
        return entry[1](carry)[0]

    def run_stream(self, topology, carry, payloads, *, chunk_len=None,
                   on_chunk=None, collect_outputs: bool = True):
        """Every micro-batch of ``payloads`` (a list of per-step payloads,
        or a dict stacked on a leading step axis).  Returns (carry, outputs
        stacked on the leading axis), as the JAX ``JitEngine.run_stream``
        does; ``carry`` is cloned first and left as it was.

        A ``ChunkedStream``, or ``chunk_len`` (which cuts the payloads into
        one, where they lie), goes through ``run_stream_chunked`` with
        ``on_chunk`` and ``collect_outputs``; without either, those two
        knobs raise rather than being ignored."""
        if chunk_len is not None and not isinstance(payloads, ChunkedStream):
            payloads = ChunkedStream(payloads, chunk_len, to_device=False)
        if isinstance(payloads, ChunkedStream):
            return self.run_stream_chunked(
                topology, carry, payloads, on_chunk=on_chunk,
                collect_outputs=collect_outputs)
        if on_chunk is not None or not collect_outputs:
            raise ValueError(
                "on_chunk / collect_outputs are chunked-runtime knobs: "
                "pass a ChunkedStream or chunk_len, or drop them -- the "
                "monolithic run would ignore the reduction and keep the "
                "full [T, ...] outputs")
        topology = self._topology(topology)
        _require_no_boundaries(topology)
        carry = tree_clone(carry)
        outs = []
        for payload in _unstack_payloads(payloads):
            carry, out = self.step(topology, carry, payload)
            outs.append(tree_clone(out))
        carry = tree_clone(carry)
        if not outs:
            return carry, {}
        return carry, tree_map(lambda *xs: torch.stack(xs), *outs)

    def run_stream_chunked(self, topology, carry, chunks, *, on_chunk=None,
                           collect_outputs: bool = True,
                           reduce_outputs=None):
        """The chunked stream runtime: the stream's steps chunk by chunk,
        bit for bit the monolithic ``run_stream`` (the same eager first
        step and captured steps) with the ``boundary`` hooks between
        chunks.  ``chunks`` is a ``ChunkedStream`` or any iterable of
        ``Chunk``s.  After each chunk (and its boundary) the driver calls
        ``on_chunk(outputs, chunk, carry)``, the chunk's outputs stacked
        on a leading step axis, its padding dropped; ``carry`` there is the
        engine's own, which the next chunk advances.
        ``collect_outputs=False`` keeps no outputs (returns None for them)
        instead of concatenating a ``[T, ...]`` result.  ``reduce_outputs``
        maps a step's outputs to what is kept of them (a selection, such
        as only the metrics), applied step by step.  ``carry`` is cloned
        first and left as it was; returns (a copy of the final carry,
        outputs)."""
        topology = self._topology(topology)
        carry = tree_clone(carry)
        segments = []
        it = iter(chunks)
        try:
            for chunk in it:
                outs = []
                for payload in _live_steps(chunk):
                    carry, out = self.step(topology, carry, payload)
                    if reduce_outputs is not None:
                        out = reduce_outputs(out)
                    outs.append(tree_clone(out))
                carry = self._boundary(topology, carry)
                seg = tree_map(lambda *xs: torch.stack(xs), *outs)
                if on_chunk is not None:
                    on_chunk(seg, chunk, carry)
                if collect_outputs:
                    segments.append(seg)
        finally:
            _close_iter(it)
        carry = tree_clone(carry)
        return carry, _concat_outputs(segments) if collect_outputs else None
