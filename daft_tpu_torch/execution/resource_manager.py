"""The memory manager: byte permits for blocking sinks (port of
``daft_tpu/execution/resource_manager.py``).

Reference: src/daft-local-execution/src/resource_manager.rs:9-44, a global
memory manager handing out byte permits. Without a limit every acquire
succeeds at once and nothing spills; under one, the blocking sinks take
permits for what they buffer and spill the rest (``execution/spill.py``).

The limit comes from :func:`memory_limit` or ``MemoryManager(limit_bytes=)``.
The port reads no environment variable: ``DAFT_MEMORY_LIMIT`` waits for the
configuration from the environment (``ExecutionConfig.from_env``, ROADMAP
A.8). Not ported: the permit-wait metrics and the profiler's permit-wait note
(the metrics plane, A.8 / A.9.5; the byte ledger's ``note_stall`` keeps the
stages' stall time), and ``RuntimeStats`` / ``emit_operator_stats``, which
feed the event subscribers (A.9.5).
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Optional


class MemoryManager:
    """Byte-permit gate for blocking sinks: acquire before buffering a morsel,
    release when the buffer drains. A request larger than the limit is
    clamped to it, so a morsel larger than the budget still makes progress.

    Waiters can be woken two ways:

    * ``token`` (a :class:`~daft_tpu_torch.cancellation.CancelToken`): the
      wait wakes the moment the query is cancelled and bounds itself by the
      query's deadline, returning False as a timeout does;
    * :meth:`poison`: the executor's failure path fails every CURRENT waiter
      of its query with the query's error, so a sink thread blocked in
      ``acquire(timeout=None)`` never outlives the query that died around
      it. Waiters that arrive after the poison are untouched.
    """

    def __init__(self, limit_bytes: Optional[int] = None):
        self.limit = limit_bytes
        self._used = 0
        self._cond = threading.Condition()
        self._poison_gen = 0
        self._poison_exc: Optional[BaseException] = None
        self._poison_query: Optional[str] = None

    def acquire(self, nbytes: int, timeout: Optional[float] = None, token=None) -> bool:
        if self.limit is None:
            return True
        request = min(nbytes, self.limit)
        woken = None
        if token is not None:
            # A cancel wakes every waiter; each checks its own token below.
            def woken():
                with self._cond:
                    self._cond.notify_all()

            token.add_listener(woken)
        try:
            with self._cond:
                my_gen = self._poison_gen
                deadline = None if timeout is None else time.monotonic() + timeout
                while self._used + request > self.limit:
                    if self._poison_gen > my_gen and self._poison_exc is not None:
                        # A waiter holding the live token of ANOTHER query is
                        # not this poison's target: its query is healthy.
                        if (token is None or self._poison_query is None
                                or getattr(token, "query_id", "") == self._poison_query):
                            raise self._poison_exc
                        my_gen = self._poison_gen
                    if token is not None and (token.cancelled() or token.expired()):
                        return False
                    remaining = None if deadline is None else deadline - time.monotonic()
                    if remaining is not None and remaining <= 0:
                        return False
                    if token is not None:
                        tok_rem = token.remaining()
                        if tok_rem is not None:
                            remaining = tok_rem if remaining is None else min(remaining, tok_rem)
                    if not self._cond.wait(remaining) and token is None:
                        return False
                self._used += request
                return True
        finally:
            if woken is not None:
                token.remove_listener(woken)

    def poison(self, exc: BaseException, query_id: Optional[str] = None) -> None:
        """Fail the waiters CURRENTLY blocked in :meth:`acquire` with ``exc``
        (the executor's abort path). With ``query_id``, only that query's
        waiters (and waiters without a token) raise: concurrent healthy
        queries keep waiting. Later acquires are unaffected."""
        with self._cond:
            self._poison_gen += 1
            self._poison_exc = exc
            self._poison_query = query_id
            self._cond.notify_all()

    def release(self, nbytes: int) -> None:
        if self.limit is None:
            return
        with self._cond:
            self._used = max(0, self._used - min(nbytes, self.limit))
            self._cond.notify_all()

    def used(self) -> int:
        return self._used

    def available_permits(self) -> Optional[int]:
        """Bytes still grantable (None: no limit). On an idle engine this
        equals ``limit`` after every query, whatever its outcome."""
        if self.limit is None:
            return None
        with self._cond:
            return max(self.limit - self._used, 0)


_GLOBAL: Optional[MemoryManager] = None
_lock = threading.Lock()


def get_memory_manager() -> MemoryManager:
    """THE process memory manager, made on first use."""
    global _GLOBAL
    with _lock:
        if _GLOBAL is None:
            _GLOBAL = MemoryManager()
        return _GLOBAL


@contextmanager
def memory_limit(limit_bytes: Optional[int]):
    """Set the process memory manager's limit for a block of code (None: no
    limit); yields the manager."""
    mm = get_memory_manager()
    old = mm.limit
    mm.limit = limit_bytes
    try:
        yield mm
    finally:
        mm.limit = old
