"""PrequentialEvaluation -- the paper's canonical Task (section 4).

Port of the monolithic part of ``repro/core/evaluation.py``: "a
classification task where each instance is used for testing first, and
then for training."  Wires a stream source, any learner exposing
``init``/``step``, and an evaluator that accumulates interleaved
test-then-train metrics.
"""

from __future__ import annotations

import dataclasses
import inspect
import time

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
