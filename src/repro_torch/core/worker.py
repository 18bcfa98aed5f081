"""An ordered background worker: the chunk drain's and the async snapshot
publisher's thread.

``OrderedWorker`` runs the calls submitted to it on one thread, in
submission order, with at most ``window`` of them outstanding (a submit
beyond that waits for the oldest).  A call that raises makes every later
call raise the same error instead of running, until the submitting side
has been given it: ``submit``, ``flush`` and ``close`` raise the first
error again there.  The errors travel as the results of
``concurrent.futures`` futures, so nothing here catches one.
"""

from __future__ import annotations

import collections
import concurrent.futures as futures


def _run(fn, args, prev):
    """Run ``fn(*args)`` unless the call before it failed (it has finished:
    one thread runs the calls in order); then fail with its error."""
    if prev is not None and prev.exception() is not None:
        raise prev.exception()
    fn(*args)


class OrderedWorker:
    def __init__(self, name: str, window: int):
        self.name = name
        self.window = max(1, int(window))
        self._pool: futures.ThreadPoolExecutor | None = None
        self._inflight: collections.deque = collections.deque()

    def submit(self, fn, *args):
        """Queue ``fn(*args)``; waits while ``window`` calls are
        outstanding, and raises an earlier call's error."""
        self._collect(wait=False)
        while len(self._inflight) >= self.window:
            futures.wait([self._inflight[0]])
            self._collect(wait=False)
        if self._pool is None:
            self._pool = futures.ThreadPoolExecutor(
                1, thread_name_prefix=self.name)
        prev = self._inflight[-1] if self._inflight else None
        self._inflight.append(self._pool.submit(_run, fn, args, prev))

    def _collect(self, *, wait: bool):
        """Drop the finished calls at the head of the queue (all of them
        after waiting, with ``wait``); raise the first error among them."""
        if wait:
            futures.wait(list(self._inflight))
        while self._inflight and self._inflight[0].done():
            err = self._inflight.popleft().exception()
            if err is not None:
                self._inflight.clear()    # the later calls failed with it
                raise err

    def failed(self) -> bool:
        """A finished call raised (without waiting for the others)."""
        return any(f.done() and f.exception() is not None
                   for f in list(self._inflight))

    @property
    def pending(self) -> int:
        """Calls submitted and not finished."""
        return sum(not f.done() for f in list(self._inflight))

    def flush(self):
        """Wait for every call submitted; raise the first error."""
        self._collect(wait=True)

    def stop(self):
        """Let the queued calls finish and stop the thread, raising nothing
        (a later submit starts another thread)."""
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None
        self._inflight.clear()

    def close(self):
        """``flush``, then ``stop`` (also when the flush raises)."""
        try:
            self.flush()
        finally:
            self.stop()


__all__ = ["OrderedWorker"]
