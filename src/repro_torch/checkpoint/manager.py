"""Versioned, async checkpointing of trees of tensors.

Port of ``repro/checkpoint/manager.py`` for one process:

  * atomic: written to ``<dir>/tmp.<step>.<pid>``, then renamed to
    ``<dir>/step_<step>``, so a crashed writer never corrupts the latest
    checkpoint; ``tmp.*`` directories that killed writers left behind are
    swept when a manager opens its directory;
  * async: ``save`` enqueues each CUDA leaf's copy into pinned host memory
    on the current stream and returns without a sync; a writer thread
    waits for the copies, serializes and renames, and ``wait()`` joins it
    (before the next save, a restore, or at the end of a run).  A save
    holds a snapshot: the stream runs the copies before anything it is
    given later can overwrite those leaves;
  * versioned: the newest ``keep`` checkpoints stay (0 keeps all);
  * self-describing: a JSON manifest holds the step, each tensor's key
    path, shape and dtype, an md5 checksum of its bytes, and the tree's
    structure, so ``restore_structured`` rebuilds the tree with no
    template; a corrupted or truncated newest checkpoint is skipped in
    favour of the newest intact one.

Storage: one ``tensors.npz`` per checkpoint plus ``manifest.json``, the JAX
package's format (bf16 as its raw 16 bits).  Leaves may be tensors on any
device, numpy arrays or numpy scalars; they come back as numpy arrays, or
as tensors on the device the caller names.  uint32 (the PRNG keys) stays
uint32.  The JAX package's multi-process paths (``host_value``,
``put_global``, ``spans_processes``) belong to the distributed runtime,
which the port does not have yet.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import shutil
import threading
import time
import zipfile
from pathlib import Path

import numpy as np
import torch

logger = logging.getLogger("repro_torch.checkpoint")


def _flatten(tree, path=""):
    """(leaves, key paths) of a tree of dicts (keys sorted, as
    ``jax.tree.flatten`` visits them), lists and tuples; ``None`` is an
    empty node, not a leaf."""
    if tree is None:
        return [], []
    if isinstance(tree, dict):
        leaves, paths = [], []
        for k in sorted(tree):
            sub, subp = _flatten(tree[k], f"{path}[{k!r}]")
            leaves += sub
            paths += subp
        return leaves, paths
    if isinstance(tree, (list, tuple)):
        leaves, paths = [], []
        for i, v in enumerate(tree):
            sub, subp = _flatten(v, f"{path}[{i}]")
            leaves += sub
            paths += subp
        return leaves, paths
    return [tree], [path]


def _encode_structure(tree):
    """JSON encoding of the tree's dict/list/tuple/None containers, each
    leaf replaced by its flatten-order index (dict keys sorted, matching
    ``_flatten``).  None when the tree holds a container that would not
    round-trip: a dict subclass (an OrderedDict iterates in insertion
    order) or a dict key that is not a string."""
    counter = [0]

    def rec(node):
        if node is None:
            return {"t": "none"}
        if isinstance(node, dict):
            if type(node) is not dict or any(not isinstance(k, str)
                                             for k in node):
                return None
            keys = sorted(node)
            kids = [rec(node[k]) for k in keys]
            return None if None in kids else {"t": "dict", "k": keys,
                                              "c": kids}
        if isinstance(node, (list, tuple)):
            if type(node) not in (list, tuple):
                return None
            kids = [rec(v) for v in node]
            kind = "list" if isinstance(node, list) else "tuple"
            return None if None in kids else {"t": kind, "c": kids}
        counter[0] += 1
        return {"t": "leaf", "i": counter[0] - 1}

    return rec(tree)


def _decode_structure(enc, leaves):
    if enc["t"] == "none":
        return None
    if enc["t"] == "dict":
        return {k: _decode_structure(c, leaves)
                for k, c in zip(enc["k"], enc["c"])}
    if enc["t"] == "list":
        return [_decode_structure(c, leaves) for c in enc["c"]]
    if enc["t"] == "tuple":
        return tuple(_decode_structure(c, leaves) for c in enc["c"])
    return leaves[enc["i"]]


def _to_host(x):
    """(a host copy of the leaf, whether it came from the card).  A CUDA
    tensor's copy into pinned memory is only enqueued on the current
    stream."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.is_cuda:
            host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            host.copy_(x, non_blocking=True)
            return host, True
        return x.clone(), False
    return np.array(x, copy=True), False


def _numpy(x):
    if not isinstance(x, torch.Tensor):
        return np.asarray(x)
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view(np.uint16)
    return x.numpy()


def _md5(a):
    return hashlib.md5(np.ascontiguousarray(a).tobytes()).hexdigest()


class CheckpointManager:
    def __init__(self, directory, *, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None
        self.swept_tmp = self._sweep_stale_tmp()

    def _sweep_stale_tmp(self) -> int:
        """Remove ``tmp.*`` directories that killed writers left (a writer
        killed mid-save never reaches the rename).  Safe when a manager
        opens its directory: it owns it, and has not started writing.
        Returns the number swept."""
        swept = 0
        for p in self.dir.glob("tmp.*"):
            if p.is_dir():
                shutil.rmtree(p, ignore_errors=True)
                swept += 1
        return swept

    # ------------------------------------------------------------- save

    def save(self, step: int, tree):
        """Snapshot ``tree`` at ``step``.  Returns at once: the leaves'
        copies to the host are enqueued, and a writer thread, which the
        next ``save`` or ``wait()`` joins, writes them."""
        self.wait()
        leaves, keypaths = _flatten(tree)
        staged = [_to_host(x) for x in leaves]
        done = None
        if any(on_card for _, on_card in staged):
            done = torch.cuda.Event()
            done.record()
        structure = _encode_structure(tree)

        def write():
            if done is not None:
                done.synchronize()
            arrs = [_numpy(h) for h, _ in staged]
            tmp = self.dir / f"tmp.{step}.{os.getpid()}"
            tmp.mkdir(exist_ok=True)
            np.savez(tmp / "tensors.npz",
                     **{f"t{i}": a for i, a in enumerate(arrs)})
            dtypes = [str(x.dtype).removeprefix("torch.")
                      if isinstance(x, torch.Tensor) else str(a.dtype)
                      for x, a in zip(leaves, arrs)]
            manifest = {
                "step": step, "time": time.time(), "n_tensors": len(arrs),
                "keypaths": keypaths, "structure": structure,
                "tensors": [{"key": f"t{i}", "shape": list(a.shape),
                             "dtype": dt, "crc": _md5(a)}
                            for i, (a, dt) in enumerate(zip(arrs, dtypes))],
            }
            (tmp / "manifest.json").write_text(json.dumps(manifest))
            final = self.dir / f"step_{step:010d}"
            if final.exists():
                shutil.rmtree(final)
            os.rename(tmp, final)
            self._gc()

        def guarded():
            try:
                write()
            except Exception as e:      # raised again by the next wait()
                self._error = e

        self._thread = threading.Thread(target=guarded,
                                        name="checkpoint-writer", daemon=True)
        self._thread.start()

    def wait(self):
        """Join the writer; raise what it failed with."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            e, self._error = self._error, None
            raise RuntimeError(f"async checkpoint write failed: {e}") from e

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(self.dir / f"step_{s:010d}", ignore_errors=True)

    # ---------------------------------------------------------- restore

    def all_steps(self):
        out = []
        for p in self.dir.glob("step_*"):
            try:
                out.append(int(p.name.split("_")[1]))
            except (IndexError, ValueError):
                pass
        return sorted(out)

    def latest_step(self):
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _load_step(self, step: int):
        d = self.dir / f"step_{step:010d}"
        manifest = json.loads((d / "manifest.json").read_text())
        data = np.load(d / "tensors.npz")
        return manifest, data

    def _restore_with_fallback(self, step: int | None, attempt):
        """``attempt(s)`` on the steps to try, newest first: a step that
        is named is tried alone; with ``step=None`` a corrupted or
        unreadable checkpoint falls back to the newest intact one.  When
        none is intact the newest one's error is raised."""
        self.wait()
        if step is not None:
            return attempt(step)
        steps = list(reversed(self.all_steps()))
        if not steps:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        first_err = None
        for s in steps:
            try:
                return attempt(s)
            except (OSError, ValueError, KeyError, zipfile.BadZipFile) as e:
                first_err = first_err or e
                logger.warning(
                    "checkpoint step_%010d unusable (%s: %s); falling back "
                    "to the newest intact checkpoint", s, type(e).__name__, e)
        raise first_err

    @staticmethod
    def _leaf(data, manifest, i: int, device):
        a = data[f"t{i}"]
        meta = manifest["tensors"][i]
        if _md5(a) != meta["crc"]:
            raise IOError(f"checksum mismatch on tensor {i} "
                          f"({manifest['keypaths'][i]})")
        if device is None:
            return a
        t = torch.from_numpy(np.array(a, copy=True))
        if meta["dtype"] == "bfloat16":
            t = t.view(torch.bfloat16)
        return t.to(device)

    def restore_structured(self, step: int | None = None, *, device=None):
        """Restore with no template: the manifest's structure rebuilds the
        dict/list/tuple tree.  Leaves come back as numpy arrays, bit for
        bit (bf16 as its uint16 bits), or, with ``device``, as tensors
        there.  Returns (tree, step)."""
        return self._restore_with_fallback(
            step, lambda s: self._restore_structured_at(s, device))

    def _restore_structured_at(self, step: int, device):
        manifest, data = self._load_step(step)
        structure = manifest.get("structure")
        if structure is None:
            raise ValueError(
                f"checkpoint step {step} has no stored structure (a tree "
                "with containers that do not round-trip); use "
                "restore(tree_like) instead")
        leaves = [self._leaf(data, manifest, i, device)
                  for i in range(manifest["n_tensors"])]
        return _decode_structure(structure, leaves), step

    def restore(self, tree_like, step: int | None = None):
        """Restore into the structure of ``tree_like``: each tensor leaf
        comes back as a tensor of that leaf's dtype on its device, any
        other leaf as a numpy array.  Returns (tree, step)."""
        return self._restore_with_fallback(
            step, lambda s: self._restore_at(tree_like, s))

    def _restore_at(self, tree_like, step: int):
        manifest, data = self._load_step(step)
        leaves, paths = _flatten(tree_like)
        if len(leaves) != manifest["n_tensors"]:
            raise ValueError(
                f"checkpoint has {manifest['n_tensors']} tensors, "
                f"the tree has {len(leaves)}")
        vals = []
        for i, ref in enumerate(leaves):
            dev = ref.device if isinstance(ref, torch.Tensor) else None
            a = self._leaf(data, manifest, i, dev)
            if tuple(a.shape) != tuple(np.shape(ref)):
                raise ValueError(f"shape mismatch on {paths[i]}: "
                                 f"{tuple(a.shape)} vs {tuple(np.shape(ref))}")
            vals.append(a.to(ref.dtype) if dev is not None else a)
        return _fill(tree_like, iter(vals)), step


def _fill(tree, it):
    """``tree`` with its leaves replaced, in ``_flatten`` order, by the
    next values of ``it``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return type(tree)((k, _fill(tree[k], it)) for k in sorted(tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_fill(v, it) for v in tree)
    return next(it)


__all__ = ["CheckpointManager"]
