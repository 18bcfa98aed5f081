"""Fault injection for the chunked stream runtime (the chaos layer).

Port of ``repro/runtime/chaos.py``.  ``FaultInjector`` produces, at chunk
indices fixed in advance, the failures a long streaming deployment sees,
so that the tests can hold the recovery machinery to exact semantics:

  * process death after a chunk (``kill_at_chunk``): raised after the
    chunk's compute and before its metrics and checkpoint land, so the
    work since the last checkpoint is lost and a resume replays it
    (``kill_mode="exit"`` leaves by ``os._exit``, which kills the
    asynchronous checkpoint writer too);
  * transient stream-source errors (``flaky_chunks``, through
    ``wrap_fetch``), which ``ChunkedStream`` retries with backoff;
  * a non-finite carry (``poison_at_chunk``): a NaN in one float leaf of
    the carry after that chunk, which the evaluation's finite check must
    catch and roll back;
  * a stalled or poisoned snapshot publisher (``wrap_publisher``);
  * a damaged checkpoint on disk (``corrupt_checkpoint``), which
    ``CheckpointManager`` must skip for the newest intact one.

Nothing here is random: faults fire at the indices given, once each, and
corruption flips the same bytes every time.

``carry_finite_flag`` is the finite check the pipelined driver defers: a
0-dim bool on the carry's device, read by nobody here.
``carry_all_finite`` is its blocking form (one host read).
``poison_carry`` returns a new tree and leaves the caller's tensors as
they are: a compiled step's state leaves are its graph's static buffers,
and a NaN written into them would reach the state a rollback discards.
"""

from __future__ import annotations

import os
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.checkpoint.manager import _flatten
from repro_torch.core.pytree import tree_map
from repro_torch.data.pipeline import TransientSourceError


class SimulatedKill(RuntimeError):
    """An injected process death.  Nothing in the runtime catches it: it
    unwinds the evaluation as a crash would, and leaves only what is on
    disk."""

    def __init__(self, chunk_index: int):
        super().__init__(f"simulated kill at chunk {chunk_index}")
        self.chunk_index = int(chunk_index)


def _inexact(x) -> bool:
    return (isinstance(x, torch.Tensor) and x.numel() > 0
            and (x.is_floating_point() or x.is_complex()))


def carry_finite_flag(carry):
    """Whether every float (or complex) leaf of ``carry`` is finite, as a
    0-dim bool tensor on the leaves' device, with no host read.  Integer
    and bool leaves are finite; a carry without a float leaf is finite.  A
    numpy leaf is checked on the host.

    x * 0 is 0 where x is finite and NaN where it is not, so the 1-norm of
    a leaf times 0 sums no magnitude (it cannot overflow) and is NaN just
    where the leaf holds a NaN or an infinity: a few ``_foreach`` calls for
    the whole carry, where a check leaf by leaf takes three operations a
    leaf from the interpreter."""
    leaves = [torch.from_numpy(np.asarray(x)) if isinstance(
        x, (np.ndarray, np.generic)) else x for x in _flatten(carry)[0]]
    leaves = [x for x in leaves if isinstance(x, torch.Tensor)]
    groups: dict = {}
    for leaf in leaves:
        if _inexact(leaf):
            groups.setdefault(leaf.dtype, []).append(leaf)
    if not groups:
        dev = leaves[0].device if leaves else None
        return torch.ones((), dtype=torch.bool, device=dev)
    norms = [torch.stack(torch._foreach_norm(torch._foreach_mul(g, 0.0), 1))
             for g in groups.values()]
    if len(norms) > 1:
        norms = [torch.cat([n.double() for n in norms])]
    return torch.isfinite(norms[0]).all()


def carry_all_finite(carry) -> bool:
    """``carry_finite_flag`` read on the host (one sync on the card)."""
    return bool(carry_finite_flag(carry))


def poison_carry(carry, value: float = float("nan")):
    """``carry`` with ``value`` in element 0 of its first float leaf (in the
    JAX package's tree order, dict keys sorted), as a new tree: that leaf
    is a copy, every other leaf the caller's own; the caller's tensors are
    not written."""
    leaves = _flatten(carry)[0]
    target = next((x for x in leaves if _inexact(x)), None)
    if target is None:
        raise ValueError("carry has no inexact leaf to poison")

    def poison(x):
        if x is not target:
            return x
        x = x.clone(memory_format=torch.contiguous_format)
        x.view(-1)[0] = value
        return x

    return tree_map(poison, carry)


class FaultInjector:
    """A fault schedule for one evaluation run.

    Each fault fires at most once (``killed`` / ``poisoned`` latch), so a
    rolled-back or resumed run replays the chunk cleanly: the injector
    models a fault that happened, not a cursed chunk.

    kill_at_chunk:   the chunk after whose compute the run dies.
    kill_mode:       "raise": ``SimulatedKill`` unwinds the evaluation;
                     "exit": ``os._exit(kill_exit_code)``.
    poison_at_chunk: the chunk after whose compute the carry gets
                     ``poison_value``.
    flaky_chunks:    chunks whose fetch fails transiently, each
                     ``flaky_failures`` times before it succeeds.
    stall_publish_chunks: chunks whose snapshot publication is dropped
                     (the train cursor still advances), through
                     ``wrap_publisher``.
    poison_snapshot_at_chunk: the chunk whose published snapshot (not the
                     training carry) gets ``poison_snapshot_value`` before
                     validation.
    ``delay_chunk(i, s)`` sleeps ``s`` seconds before chunk i's compute,
    once (a straggler).
    """

    def __init__(self, *, kill_at_chunk: int | None = None,
                 kill_mode: str = "raise", kill_exit_code: int = 113,
                 poison_at_chunk: int | None = None,
                 poison_value: float = float("nan"),
                 flaky_chunks=(), flaky_failures: int = 1,
                 stall_publish_chunks=(),
                 poison_snapshot_at_chunk: int | None = None,
                 poison_snapshot_value: float = float("nan")):
        if kill_mode not in ("raise", "exit"):
            raise ValueError(f"unknown kill_mode {kill_mode!r}")
        self.kill_at_chunk = kill_at_chunk
        self.kill_mode = kill_mode
        self.kill_exit_code = int(kill_exit_code)
        self.poison_at_chunk = poison_at_chunk
        self.poison_value = poison_value
        self.flaky_failures = {int(c): int(flaky_failures)
                               for c in flaky_chunks}
        self.stall_publish_chunks = {int(c) for c in stall_publish_chunks}
        self.poison_snapshot_at_chunk = poison_snapshot_at_chunk
        self.poison_snapshot_value = poison_snapshot_value
        self.killed = False
        self.poisoned = False
        self.snapshot_poisoned = False
        self.stalled_publishes = 0
        self.delay_chunks: dict[int, float] = {}
        self.delays_fired: set[int] = set()

    def maybe_kill(self, chunk_index: int):
        """Die after chunk ``chunk_index``'s compute (before its
        checkpoint)."""
        if self.kill_at_chunk is None or self.killed \
                or int(chunk_index) != int(self.kill_at_chunk):
            return
        self.killed = True
        if self.kill_mode == "exit":
            os._exit(self.kill_exit_code)
        raise SimulatedKill(chunk_index)

    def maybe_poison(self, chunk_index: int, carry):
        """The carry leaving chunk ``chunk_index`` with a NaN (once)."""
        if self.poison_at_chunk is None or self.poisoned \
                or int(chunk_index) != int(self.poison_at_chunk):
            return carry
        self.poisoned = True
        return poison_carry(carry, self.poison_value)

    def delay_chunk(self, index: int, seconds: float):
        """Sleep ``seconds`` before chunk ``index``'s compute, once.
        Chainable."""
        self.delay_chunks[int(index)] = float(seconds)
        return self

    def maybe_delay(self, chunk_index: int):
        i = int(chunk_index)
        s = self.delay_chunks.get(i)
        if s is None or i in self.delays_fired:
            return
        self.delays_fired.add(i)
        time.sleep(s)

    def wrap_publisher(self, publisher):
        """``publisher`` with the serving-side faults: stalled publications
        and poisoned snapshots."""
        return _ChaosPublisher(self, publisher)

    def wrap_fetch(self, fetch):
        """A ``ChunkedStream`` fetch whose scheduled chunks raise
        ``TransientSourceError`` ``flaky_failures`` times, then recover."""
        remaining = dict(self.flaky_failures)

        def flaky(i):
            left = remaining.get(int(i), 0)
            if left > 0:
                remaining[int(i)] = left - 1
                raise TransientSourceError(
                    f"injected transient source failure on chunk {i} "
                    f"({left - 1} more to come)")
            return fetch(i)

        return flaky


class _ChaosPublisher:
    """A publisher proxy that stalls or poisons publications; everything
    but ``publish`` is the real publisher's, so a server reads true
    state."""

    def __init__(self, injector: FaultInjector, publisher):
        self._injector = injector
        self._publisher = publisher

    def publish(self, chunk_index: int, state) -> bool:
        inj = self._injector
        i = int(chunk_index)
        if i in inj.stall_publish_chunks:
            inj.stalled_publishes += 1
            # the chunk was trained, only its publication is lost: the
            # train cursor still moves, so staleness grows
            self._publisher.observe(i)
            return False
        if (inj.poison_snapshot_at_chunk is not None
                and i == int(inj.poison_snapshot_at_chunk)
                and not inj.snapshot_poisoned):
            inj.snapshot_poisoned = True
            state = poison_carry(state, inj.poison_snapshot_value)
        return self._publisher.publish(i, state)

    def __getattr__(self, name):
        return getattr(self._publisher, name)


def request_burst(server, xs, *, deadline_ms: float | None = None):
    """One request per row of ``xs``, submitted back to back: the burst.
    Returns the requests."""
    return [server.submit(x, deadline_ms=deadline_ms) for x in xs]


def corrupt_checkpoint(directory, step: int | None = None, *,
                       mode: str = "tensor"):
    """Damage checkpoint ``step`` (default: the newest) under ``directory``.

    mode="tensor":   rewrite tensors.npz with one byte flipped (readable,
                     the checksum fails);
    mode="truncate": cut the npz in half (unreadable);
    mode="manifest": replace manifest.json with invalid JSON.

    Returns the step."""
    d = Path(directory)
    steps = sorted(int(p.name.split("_")[1]) for p in d.glob("step_*"))
    if not steps:
        raise FileNotFoundError(f"no checkpoints in {d}")
    if step is None:
        step = steps[-1]
    target = d / f"step_{step:010d}"
    if mode == "tensor":
        npz = target / "tensors.npz"
        data = np.load(npz)
        arrs = {k: data[k].copy() for k in data.files}
        a = arrs["t0"].reshape(-1).view(np.uint8)
        a[0] ^= 0xFF
        np.savez(npz, **arrs)
    elif mode == "truncate":
        npz = target / "tensors.npz"
        raw = npz.read_bytes()
        npz.write_bytes(raw[:max(1, len(raw) // 2)])
    elif mode == "manifest":
        (target / "manifest.json").write_text("{corrupt")
    else:
        raise ValueError(f"unknown corruption mode {mode!r}")
    return step


__all__ = ["SimulatedKill", "FaultInjector", "carry_finite_flag",
           "carry_all_finite", "poison_carry", "request_burst",
           "corrupt_checkpoint"]
