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
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.compiled import compile_step
from repro_torch.core.pytree import tree_clone, tree_leaves, tree_map
from repro_torch.core.topology import Topology, build_learner_topology


def _as_topology(topology) -> Topology:
    if isinstance(topology, Topology):
        return topology
    return build_learner_topology(topology)


def _init_states(topology: Topology, key):
    return {n: p.init_state(key) for n, p in topology.processors.items()}


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
    """Chunk-boundary hooks fire only on a chunked driver, which the port
    does not have yet: fail loudly instead of never firing them."""
    names = [n for n, p in topology.processors.items()
             if p.boundary is not None]
    if names:
        raise ValueError(
            f"processors {names} have chunk-boundary hooks, which only fire "
            "on a chunked driver; repro_torch has none yet")


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
        list.  ``states`` is cloned first and left as it was."""
        topology = _as_topology(topology)
        _require_no_boundaries(topology)
        states = tree_clone(states)
        outs = []
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
    """The JAX package's ``JitEngine`` (``step`` and the monolithic
    ``run_stream``): the whole topology step with feedback edges delivered
    next step.  The first step, with no feedback yet, runs eagerly and
    primes the carry, as the JAX engine's ``_prime_first_step`` runs it
    through its plain jitted step.  Every later step replays one captured
    topology step (``core.compiled.compile_step``, captured at the first of
    them and kept per topology), whose gates are conds on the device; on
    the CPU that step runs eagerly in its capturable form.

    ``step`` returns the captured step's own carry, which the next step of
    the same topology advances in place (what ``donate_argnums`` does in
    the JAX engine); ``run_stream`` returns a copy."""

    def __init__(self):
        self._eager = StreamEngine()
        # id -> (the object, so the id stays its own, and what it maps to)
        self._topologies: dict[int, tuple] = {}
        self._compiled: dict[int, tuple] = {}

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

    def run_stream(self, topology, carry, payloads, *, chunk_len=None,
                   on_chunk=None, collect_outputs: bool = True):
        """Every micro-batch of ``payloads`` (a list of per-step payloads,
        or a dict stacked on a leading step axis).  Returns (carry, outputs
        stacked on the leading axis), as the JAX ``JitEngine.run_stream``
        does; ``carry`` is cloned first and left as it was.  The chunked
        runtime's knobs (``chunk_len``, ``on_chunk``, ``collect_outputs``)
        are not ported yet and raise."""
        if chunk_len is not None or on_chunk is not None or not collect_outputs:
            raise NotImplementedError(
                "chunk_len, on_chunk and collect_outputs belong to the "
                "chunked runtime (ChunkedStream, run_stream_chunked), which "
                "repro_torch does not have yet")
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
