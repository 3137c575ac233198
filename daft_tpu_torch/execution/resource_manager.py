"""The memory manager: byte permits for blocking sinks (port of
``daft_tpu/execution/resource_manager.py``).

Reference: src/daft-local-execution/src/resource_manager.rs:9-44, a global
memory manager handing out byte permits. Without a limit every acquire
succeeds at once and nothing spills; under one, the blocking sinks take
permits for what they buffer and spill the rest (``execution/spill.py``).

The limit comes from :func:`memory_limit`, ``MemoryManager(limit_bytes=)``
or, for a manager made without one, ``DAFT_MEMORY_LIMIT``, as in the JAX
package. A wait for permits is observed in ``daft_memory_permit_wait_seconds``
and attributed to the profiled operator (``profiling.note_permit_wait``).

``RuntimeStats`` keeps one query's per-operator rows and CPU time
(``DataFrame.metrics()``) and flushes them as ``OperatorStats`` events at the
query's end. The driver's side of a worker's snapshot (the JAX package's
``register_query_stats`` / ``emit_operator_stats``) waits for the
distributed runner that sends it (ROADMAP A.8).
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Dict, Optional


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
        if limit_bytes is None:
            from daft_tpu_torch.config import daft_env

            env = daft_env("DAFT_MEMORY_LIMIT")
            limit_bytes = int(env) if env else None
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
        wait_t0: Optional[float] = None
        try:
            with self._cond:
                my_gen = self._poison_gen
                deadline = None if timeout is None else time.monotonic() + timeout
                while self._used + request > self.limit:
                    if wait_t0 is None:
                        wait_t0 = time.monotonic()
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
            if wait_t0 is not None:
                from daft_tpu_torch import metrics, profiling

                waited = time.monotonic() - wait_t0
                metrics.PERMIT_WAIT.observe(waited)
                profiling.note_permit_wait(waited)

    def poison(self, exc: BaseException, query_id: Optional[str] = None) -> None:
        """Fail the waiters CURRENTLY blocked in :meth:`acquire` with ``exc``
        (the executor's abort path). With ``query_id``, only that query's
        waiters (and waiters without a token) raise: concurrent healthy
        queries keep waiting. Later acquires are unaffected."""
        from daft_tpu_torch import metrics

        metrics.MEMORY_POISON.inc()
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


@dataclass
class OperatorCounters:
    rows_in: int = 0
    rows_out: int = 0
    cpu_ns: int = 0


class RuntimeStats:
    """Per-query operator counters, flushed as OperatorStats events at query
    end (reference: RuntimeStatsManager)."""

    def __init__(self, query_id: str = ""):
        self.query_id = query_id
        self._ops: Dict[str, OperatorCounters] = {}
        self._lock = threading.Lock()

    def record_pull(self, op: str, parent: Optional[str], rows: int, cpu_ns: int) -> None:
        """One pull of ``op``'s stream: its rows out and time and, when the
        pull ran inside ``parent``'s, the same rows in to ``parent`` and the
        time taken out of ``parent``'s (exclusive time). The JAX package's
        executor makes two ``record`` calls for this, each making a counter
        object; here one lock covers both and a counter is made once."""
        with self._lock:
            c = self._counters(op)
            c.rows_out += rows
            c.cpu_ns += cpu_ns
            if parent is not None:
                c = self._counters(parent)
                c.rows_in += rows
                c.cpu_ns -= cpu_ns

    def _counters(self, op: str) -> OperatorCounters:
        c = self._ops.get(op)
        if c is None:
            c = self._ops[op] = OperatorCounters()
        return c

    def flush(self) -> None:
        from daft_tpu_torch.context import get_context
        from daft_tpu_torch.subscribers.events import OperatorStats

        ctx = get_context()
        with self._lock:
            for op, c in self._ops.items():
                ctx.notify(OperatorStats(
                    query_id=self.query_id, operator=op,
                    rows_in=c.rows_in, rows_out=c.rows_out,
                    cpu_us=c.cpu_ns // 1000,
                ))

    def snapshot(self) -> Dict[str, OperatorCounters]:
        with self._lock:
            return dict(self._ops)

    def to_wire(self) -> Dict[str, dict]:
        """Serializable snapshot (the worker->driver stats wire shape)."""
        return {op: {"rows_in": c.rows_in, "rows_out": c.rows_out,
                     "cpu_ns": c.cpu_ns}
                for op, c in self.snapshot().items()}
