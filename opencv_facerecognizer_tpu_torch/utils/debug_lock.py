"""Instrumented locks that record acquisition order: port of
``opencv_facerecognizer_tpu/utils/debug_lock.py``, the dynamic backstop to
the static ``lock-order`` rule of ``tools/ocvf_lint``.

The static checker sees lexical nesting; it cannot see orders that only
happen at run time (callbacks, hooks, locks handed across objects, and
on the card threads that really interleave). A ``LockOrderMonitor``
wraps the stack's real locks in ``DebugLock``s, keeps each thread's
stack of held locks and records every (held, acquired) edge. ``check()``
raises if two locks were ever taken in both orders (the AB/BA deadlock
shape); ``edges()`` feeds the cross-check against the static graph.

Nothing in production imports this: a test or the soak swaps an
instance's lock attributes before its threads start.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Set, Tuple


class LockOrderError(AssertionError):
    """Two locks were observed acquired in both orders (or one was
    re-entered while held) — a latent deadlock."""


class LockOrderMonitor:
    """Shared recorder for a family of DebugLocks.

    ``raise_on_inversion=True`` raises at the acquiring site the moment an
    edge's reverse is already on record — maximal debuggability, but it
    throws inside whatever thread trips it.  The default records silently
    and lets the test call ``check()`` at the end, so supervised serving
    threads (which catch Exception by design) can't eat the signal."""

    def __init__(self, raise_on_inversion: bool = False):
        self._raise = raise_on_inversion
        self._mu = threading.Lock()
        #: (held, acquired) -> observation count
        self._edges: Dict[Tuple[str, str], int] = {}
        self._local = threading.local()

    # ---- held-stack bookkeeping (called by DebugLock) ----

    def _stack(self) -> List[str]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = []
            self._local.stack = stack
        return stack

    def _before_acquire(self, name: str) -> None:
        stack = self._stack()
        if name in stack:
            raise LockOrderError(
                f"DebugLock {name!r} re-entered while already held "
                f"(held stack: {stack}) — this deadlocks a plain Lock")
        if stack:
            edge = (stack[-1], name)
            with self._mu:
                self._edges[edge] = self._edges.get(edge, 0) + 1
                inverted = self._raise and (name, stack[-1]) in self._edges
            if inverted:
                raise LockOrderError(
                    f"lock-order inversion: acquired {name!r} while holding "
                    f"{stack[-1]!r}, but the reverse order is also on record")

    def _after_acquire(self, name: str) -> None:
        self._stack().append(name)

    def _after_release(self, name: str) -> None:
        stack = self._stack()
        # remove the most recent occurrence — releases may be out of LIFO
        # order (Condition.wait releases mid-stack)
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] == name:
                del stack[i]
                return

    # ---- public API ----

    def debug_lock(self, name: str,
                   inner: Optional[threading.Lock] = None) -> "DebugLock":
        return DebugLock(self, name, inner=inner)

    def edges(self) -> Set[Tuple[str, str]]:
        with self._mu:
            return set(self._edges)

    def inversions(self) -> List[Tuple[str, str]]:
        with self._mu:
            return sorted((a, b) for (a, b) in self._edges
                          if a < b and (b, a) in self._edges)

    def check(self) -> None:
        """Raise LockOrderError if any inversion was recorded."""
        bad = self.inversions()
        if bad:
            raise LockOrderError(
                f"lock-order inversions observed at runtime: {bad}")


class DebugLock:
    """Drop-in ``threading.Lock`` replacement reporting to a monitor.

    Also works as the lock behind a ``threading.Condition`` — it exposes
    ``_is_owned`` so the Condition's ownership asserts use the real owner
    thread instead of the acquire(0) probe, and releases are tracked even
    when ``wait()`` drops the lock mid-stack."""

    def __init__(self, monitor: LockOrderMonitor, name: str,
                 inner: Optional[threading.Lock] = None):
        self._monitor = monitor
        self.name = name
        self._inner = inner if inner is not None else threading.Lock()
        self._owner: Optional[int] = None

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        self._monitor._before_acquire(self.name)
        got = self._inner.acquire(blocking, timeout)
        if got:
            self._owner = threading.get_ident()
            self._monitor._after_acquire(self.name)
        return got

    def release(self) -> None:
        self._owner = None
        self._monitor._after_release(self.name)
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def _is_owned(self) -> bool:
        return self._owner == threading.get_ident()

    def __enter__(self) -> "DebugLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<DebugLock {self.name!r} inner={self._inner!r}>"
