"""Compiled steps: the port's counterpart of ``jax.jit`` and ``lax.cond``.

The JAX package runs each step as one compiled program (``JitEngine``,
``jax.jit(learner.step)`` in ``PrequentialEvaluation``, the serve step),
and its gates are ``lax.cond``s that run on the device.  Here:

  compile_step(fn, state, *payload)
      captures ``fn(state, *payload) -> (state, outputs)`` into a
      ``torch.cuda.CUDAGraph`` on the card, one graph per payload
      signature (as ``jax.jit`` keeps one program per signature).  The
      state lives in static buffers that the graphs share, the payload in
      buffers of each graph's own.  A call copies the payload (and any
      state leaf that is not the step's own buffer) in and replays the
      graph; the graph ends by copying every carried leaf the step
      replaced back into its buffer, so a replay advances the state in
      place, as ``donate_argnums`` lets XLA do.  It returns the step's own
      state and outputs, which the next call overwrites.  On the CPU there
      is nothing to capture: the step runs eagerly in the same capturable
      form.
  cond(pred, true_fn, false_fn, operand)
      inside a capture, a conditional node of the graph (``csrc/
      graph_cond.cu``): the predicate is read on the device and only the
      branch taken runs.  On the CPU it reads the predicate, the one place
      in a capturable step that may.
  gate(pred, true_fn, false_fn, operand)
      ``cond`` in a capturable step; in an eager one, a host read of the
      predicate picks the branch.

A step is in its capturable form while it runs under ``compile_step``:
``capturable()`` is then true, and the gates of ``ml.htree`` and
``ml.amrules`` go through ``cond`` instead of reading the device.  Outside
it they keep their host reads, which cost the eager step a sync each.

PyTorch's own ``torch.cond`` goes through ``torch.compile``, which the port
does not use, and the installed PyTorch has no Python entry point for
conditional nodes; hence the binding.  A branch body is captured on a
stream of its own into the node's body graph, and the caching allocator
serves that stream from a memory pool of its own, which lives as long as
the graph.  A failed capture or node raises; nothing falls back to eager.
"""

from __future__ import annotations

import contextlib
import contextvars
import ctypes
import gc
import weakref

import torch

from repro_torch.core.pytree import tree_clone, tree_leaves, tree_map
from repro_torch.kernels import _build

_CAPTURE: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_capture", default=None)
_PTR = ctypes.c_void_p


def capturable() -> bool:
    """True while a step runs in its capturable form (under a step of
    ``compile_step``): its gates then take ``cond``."""
    return _CAPTURE.get() is not None


@contextlib.contextmanager
def _capturing(capture):
    token = _CAPTURE.set(capture)
    try:
        yield capture
    finally:
        _CAPTURE.reset(token)


def _read(pred) -> bool:
    return bool(pred)


def cond(pred, true_fn, false_fn, operand):
    """``lax.cond``: ``true_fn(operand)`` where the 0-dim ``pred`` holds,
    else ``false_fn(operand)``.  Both return trees of one structure,
    shapes and dtypes, built of new tensors or of leaves of ``operand``.

    On the CPU it reads ``pred``.  On the card it is called only by a
    capturable step: in the capture, a conditional node whose bodies write
    one set of outputs; in the warm-up before it, both branches, so that
    every kernel of both has run once before the capture, and the result
    chosen on the device."""
    if pred.device.type != "cuda":
        return true_fn(operand) if _read(pred) else false_fn(operand)
    capture = _CAPTURE.get()
    if capture is None:
        raise RuntimeError("cond on a CUDA tensor runs only inside a step "
                           "of compile_step")
    if not torch.cuda.is_current_stream_capturing():
        return tree_map(lambda a, b: torch.where(pred, a, b),
                        true_fn(operand), false_fn(operand))
    return capture.cond(pred, true_fn, false_fn, operand)


def gate(pred, true_fn, false_fn, operand):
    """A gate that a step takes in either form: ``cond`` in its capturable
    form; eagerly, the branch a host read of the 0-dim ``pred`` picks
    (one sync on the card)."""
    if capturable():
        return cond(pred, true_fn, false_fn, operand)
    return true_fn(operand) if _read(pred) else false_fn(operand)


def _check_like(a, b, what):
    if a.shape != b.shape or a.dtype != b.dtype:
        raise ValueError(f"{what}: {b.dtype} of shape {tuple(b.shape)} where "
                         f"{a.dtype} of shape {tuple(a.shape)} is held")


def _flat(tree, path=()):
    """{path: leaf} of a tree of dicts, lists and tuples; dict keys sorted,
    so that the order in which a dict was built does not matter."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], (*path, k)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, (*path, i)))
        return out
    return {} if tree is None else {path: tree}


class _Capture:
    """What the conds of one capture need: the device, a stream and a
    memory pool for each depth of nested bodies, and the pools begun, to
    release with the graph."""

    def __init__(self, device):
        self.device = device
        self.depth = 0
        self.streams: dict[int, torch.cuda.Stream] = {}
        self.pools: dict[int, tuple] = {}
        self.begun: list[tuple] = []

    def cond(self, pred, true_fn, false_fn, operand):
        pred = pred.reshape(()).to(torch.bool)
        open_ = _build.function("graph_cond", "graph_cond_open", (_PTR,) * 3)
        bodies = (_PTR * 2)()
        _build.check(open_(torch.cuda.current_stream(self.device).cuda_stream,
                           pred.data_ptr(), bodies), "graph_cond_open")
        ptrs = {t.untyped_storage().data_ptr() for t in tree_leaves(operand)
                if isinstance(t, torch.Tensor)}

        def taken():
            # a leaf of operand passed through would be overwritten by the
            # other body's copy: the true body's outputs are its own
            return tree_map(lambda t: t.clone() if
                            t.untyped_storage().data_ptr() in ptrs else t,
                            true_fn(operand))

        out = self._body(bodies[0], taken)

        def other():
            def put(o, a):
                _check_like(o, a, "cond's false branch")
                o.copy_(a)
            tree_map(put, out, false_fn(operand))

        self._body(bodies[1], other)
        return out

    def _body(self, graph, fn):
        """Capture fn() on this depth's stream into the body ``graph``, its
        allocations from this depth's pool."""
        d = self.depth
        if d not in self.streams:
            self.streams[d] = torch.cuda.Stream(self.device)
            self.pools[d] = torch.cuda.graph_pool_handle()
        stream, pool = self.streams[d], self.pools[d]
        begin = _build.function("graph_cond", "graph_body_begin", (_PTR,) * 2)
        end = _build.function("graph_cond", "graph_body_end", (_PTR,))
        with torch.cuda.stream(stream):
            _build.check(begin(stream.cuda_stream, graph), "graph_body_begin")
            torch._C._cuda_beginAllocateCurrentStreamToPool(
                self.device.index, pool)
            self.begun.append(pool)
            self.depth += 1
            out = fn()
            self.depth -= 1
            torch._C._cuda_endAllocateToPool(self.device.index, pool)
            _build.check(end(stream.cuda_stream), "graph_body_end")
        return out


def _release(graph, device, pools):
    graph.reset()
    for pool in pools:
        torch._C._cuda_releasePool(device.index, pool)


class _Eager:
    """A step on the CPU: its capturable form, run eagerly."""

    def __init__(self, fn):
        self.fn = fn

    def __call__(self, state, *payload):
        with _capturing(_Capture(None)):
            return self.fn(state, *payload)


def _signature(flat):
    """What a captured graph is specific to: each leaf's path, shape and
    dtype."""
    return tuple((path, tuple(t.shape), t.dtype) for path, t in flat.items())


def _copy_in(held, tree, what):
    """Copy the leaves of ``tree`` into the buffers ``held`` ({path:
    buffer}), raising, with the leaf's path, on another structure, shape
    or dtype."""
    flat = _flat(tree)
    if flat.keys() != held.keys():
        raise ValueError(f"{what} has another structure than the "
                         "captured step's")
    for path, buf in held.items():
        t = flat[path]
        if t is not buf:
            _check_like(buf, t, f"{what} leaf {path}")
            buf.copy_(t)


class _Step:
    """A step compiled on the card (see ``compile_step``): the state in
    static buffers, and one captured graph per payload signature, all of
    which advance those buffers."""

    def __init__(self, fn, state, payload, device):
        self.fn, self.device = fn, device
        self.state = tree_clone(state)
        self._state = _flat(self.state)
        self.graphs: dict[tuple, _Graph] = {}
        self._graph(payload)

    def _graph(self, payload):
        sig = _signature(_flat(payload))
        if sig not in self.graphs:
            self.graphs[sig] = _Graph(self, payload)
        return self.graphs[sig]

    def copy_back(self, new):
        """The graph's last nodes: every state leaf the step replaced, into
        its buffer.  A new leaf that lives in another buffer is copied out
        first, so that no copy reads a buffer already overwritten."""
        flat = _flat(new)
        if flat.keys() != self._state.keys():
            raise ValueError("the step returned a state of another structure "
                             f"({sorted(flat)} against {sorted(self._state)})")
        held = {t.untyped_storage().data_ptr() for t in self._state.values()}
        todo = []
        for path, buf in self._state.items():
            t = flat[path]
            _check_like(buf, t, f"state leaf {path}")
            if t.data_ptr() == buf.data_ptr() and t.stride() == buf.stride():
                continue                        # updated in place
            if t.untyped_storage().data_ptr() in held:
                t = t.clone()
            todo.append((buf, t))
        for buf, t in todo:
            buf.copy_(t)

    def __call__(self, state, *payload):
        _copy_in(self._state, state, "state")
        graph = self._graph(payload)
        _copy_in(graph.inputs, payload, "payload")
        graph.graph.replay()
        return self.state, graph.out


@contextlib.contextmanager
def _collector_paused():
    """The cyclic garbage collector off for a capture (``torch.cuda.graph``
    collects once before it begins).  A collection in the capturing thread
    would run the finalizers of the graphs it frees (an engine and its
    steps form a cycle), and a graph reset during a capture invalidates
    the capture."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


class _Graph:
    """One capture of a step, for one payload signature: its payload in
    static buffers of its own, its state in the step's."""

    def __init__(self, step, payload):
        device = step.device
        self.payload = tree_clone(payload)
        self.inputs = _flat(self.payload)
        capture = _Capture(device)
        main = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(main)
        with _capturing(capture):
            # the warm-up: builds the kernels, fills what is made at first
            # use and launches every kernel once, on a copy of the state
            # (the buffers hold the live state once a graph has run)
            with torch.cuda.stream(side):
                step.fn(tree_clone(step.state), *self.payload)
            main.wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            # thread_local: what other threads call meanwhile (a chunked
            # stream's producer staging the next chunk: pinned memory, a
            # copy on its own stream) does not invalidate this capture;
            # a sync in this thread still does
            with _collector_paused(), torch.cuda.graph(
                    self.graph, stream=side,
                    capture_error_mode="thread_local"):
                new, self.out = step.fn(step.state, *self.payload)
                step.copy_back(new)
        weakref.finalize(self, _release, self.graph, device,
                         capture.begun).atexit = False


def compile_step(fn, state, *payload):
    """``fn(state, *payload) -> (state, outputs)`` as one compiled step,
    for a state of the structure, shapes and dtypes of the example given.
    On the card (when a leaf of the examples is a CUDA tensor) the step is
    captured for the example payload, after one eager warm-up on a side
    stream, and each call with a payload of the same signature (structure,
    shapes and dtypes) replays it: no operation is issued from Python and
    the host reads nothing.  A payload of another signature is captured at
    its first call, as ``jax.jit`` traces again (a short last batch); the
    graphs share the state's buffers.  A state of another signature
    raises, naming the leaf.  The call returns the step's own state
    buffers and outputs, which the next call advances and overwrites.  On
    the CPU the call runs ``fn`` eagerly in its capturable form (``cond``
    reads the predicate there)."""
    cuda = [t for t in tree_leaves((state, payload))
            if isinstance(t, torch.Tensor) and t.is_cuda]
    if not cuda:
        return _Eager(fn)
    device = cuda[0].device
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return _Step(fn, state, payload, device)


__all__ = ["capturable", "compile_step", "cond", "gate"]
