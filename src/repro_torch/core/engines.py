"""Execution engines: the DSPE-adapter layer of the paper, in PyTorch.

Port of two engines of ``repro/core/engines.py``; the same Topology runs on
both:

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

Both accept a Topology or a bare learner (``init``/``step``), which is
wrapped in a one-processor topology.  ``run_stream`` clones the states it
is given first, because processors update large tensors in place.
"""

from __future__ import annotations

from typing import Any

import torch

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
