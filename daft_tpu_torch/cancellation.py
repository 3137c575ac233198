"""Per-query deadlines and cooperative cancellation (port of the in-process
part of ``daft_tpu/cancellation.py``).

A query gets ONE deadline / cancel token, built by ``DataFrame.collect`` or
``iter_partitions`` from ``timeout=`` or ``ExecutionConfig.query_timeout_s``.
The executor observes it at every morsel boundary (``_cancel_checked`` around
each operator's stream, and each pool worker before it starts a morsel), and
the stage threads find it through a contextvar they inherit
(:func:`cancel_scope`, :func:`iter_with_cancel_scope`). A query-id registry
lets :func:`cancel_query` reach a running query from another thread.

Deadlines are ``time.monotonic`` instants, so a step of the wall clock can
neither expire nor revive a query. On expiry the observing site raises
:class:`~daft_tpu_torch.errors.DaftTimeoutError`; on an explicit cancel,
:class:`~daft_tpu_torch.errors.DaftCancelledError`.

Not ported yet: the wire re-anchoring of a deadline (``_rebuild_deadline``,
``token_for_task``), which goes with the distributed layer (ROADMAP A.8).
"""

from __future__ import annotations

import contextlib
import contextvars
import logging
import threading
import time
from typing import Callable, Dict, Iterator, List, Optional

from daft_tpu_torch.errors import DaftCancelledError, DaftTimeoutError


class Deadline:
    """A monotonic instant by which work must finish; build it with
    :meth:`after`."""

    __slots__ = ("expires_at", "timeout_s")

    def __init__(self, expires_at: float, timeout_s: float):
        self.expires_at = expires_at  # a time.monotonic() instant
        self.timeout_s = timeout_s    # the original budget, for messages

    @staticmethod
    def after(timeout_s: float) -> "Deadline":
        return Deadline(time.monotonic() + timeout_s, timeout_s)

    def remaining(self) -> float:
        """Seconds left (<= 0 once expired)."""
        return self.expires_at - time.monotonic()

    def expired(self) -> bool:
        return self.remaining() <= 0

    def __repr__(self) -> str:
        return f"Deadline(remaining={self.remaining():.3f}s of {self.timeout_s}s)"


class CancelToken:
    """Cooperative cancellation signal, optionally with a deadline.

    Thread-safe. ``cancel()`` is level-triggered and idempotent; listeners
    added with :meth:`add_listener` fire once, outside the token's lock.
    Deadline expiry is passive: waiters bound their blocking call by
    :meth:`remaining`, and every observation point calls :meth:`check`."""

    def __init__(self, deadline: Optional[Deadline] = None, query_id: str = ""):
        self.deadline = deadline
        self.query_id = query_id
        self.reason: Optional[str] = None
        self._event = threading.Event()
        self._listeners: List[Callable[[], None]] = []
        self._lock = threading.Lock()

    # -- signalling -------------------------------------------------------
    def cancel(self, reason: str = "cancelled") -> None:
        with self._lock:
            if self._event.is_set():
                return
            self.reason = reason
            self._event.set()
            listeners = list(self._listeners)
        for cb in listeners:  # outside the lock: callbacks may take locks
            try:
                cb()
            except Exception:  # noqa: BLE001 — one listener must not stop the others
                logging.getLogger("daft_tpu_torch.cancellation").warning(
                    "cancel listener raised", exc_info=True)

    def add_listener(self, cb: Callable[[], None]) -> None:
        """Call ``cb`` when the token is cancelled (at once if it already
        is). Deadline expiry does not fire listeners."""
        with self._lock:
            if not self._event.is_set():
                self._listeners.append(cb)
                return
        cb()

    def remove_listener(self, cb: Callable[[], None]) -> None:
        with self._lock:
            if cb in self._listeners:
                self._listeners.remove(cb)

    # -- observation ------------------------------------------------------
    def cancelled(self) -> bool:
        return self._event.is_set()

    def expired(self) -> bool:
        return self.deadline is not None and self.deadline.expired()

    def remaining(self) -> Optional[float]:
        """Seconds until the deadline, None without one, 0.0 once the
        token is cancelled."""
        if self._event.is_set():
            return 0.0
        if self.deadline is None:
            return None
        return max(self.deadline.remaining(), 0.0)

    def error(self, what: str = "") -> Optional[DaftCancelledError]:
        """The error this token mandates now, or None while it is live."""
        suffix = f" during {what}" if what else ""
        if self._event.is_set():
            return DaftCancelledError(
                f"query {self.query_id or '?'} cancelled ({self.reason}){suffix}")
        if self.expired():
            return DaftTimeoutError(
                f"query {self.query_id or '?'} exceeded its {self.deadline.timeout_s}s "
                f"deadline{suffix}")
        return None

    def check(self, what: str = "") -> None:
        """Raise if cancelled or past the deadline; a no-op otherwise."""
        err = self.error(what)
        if err is not None:
            raise err

    def wait(self, timeout_s: float) -> bool:
        """Sleep up to ``timeout_s`` (clamped to the deadline); True when
        the token fired first."""
        rem = self.remaining()
        if rem is not None:
            timeout_s = min(timeout_s, rem)
        return self._event.wait(max(timeout_s, 0.0))


# --------------------------------------------------------------------- #
# Ambient propagation: contextvar scope + query-id registry               #
# --------------------------------------------------------------------- #
_current: contextvars.ContextVar[Optional[CancelToken]] = \
    contextvars.ContextVar("daft_torch_cancel_token", default=None)

_BY_QUERY: Dict[str, CancelToken] = {}
_registry_lock = threading.Lock()


def current_token() -> Optional[CancelToken]:
    """The token of the current execution scope (None outside a query and
    for a query without a deadline)."""
    return _current.get()


def check_current(what: str = "") -> None:
    """Observe the ambient token, if any."""
    tok = _current.get()
    if tok is not None:
        tok.check(what)


@contextlib.contextmanager
def cancel_scope(token: Optional[CancelToken]) -> Iterator[Optional[CancelToken]]:
    """Make ``token`` the ambient token for a synchronous block."""
    cv_token = _current.set(token)
    try:
        yield token
    finally:
        _current.reset(cv_token)


def iter_with_cancel_scope(gen, token: Optional[CancelToken]):
    """Drain ``gen`` with ``token`` ambient during each resumption only, so
    lazy queries interleaved on one thread keep their own tokens; the token
    is checked before each pull."""
    if token is None:
        yield from gen
        return
    while True:
        token.check("query iteration")
        cv = _current.set(token)
        try:
            try:
                item = next(gen)
            finally:
                _current.reset(cv)
        except StopIteration:
            return
        yield item


def register_query_token(query_id: str, token: CancelToken) -> None:
    with _registry_lock:
        _BY_QUERY[query_id] = token


def unregister_query_token(query_id: str) -> None:
    with _registry_lock:
        _BY_QUERY.pop(query_id, None)


def active_query_token(query_id: str) -> Optional[CancelToken]:
    with _registry_lock:
        return _BY_QUERY.get(query_id)


def cancel_query(query_id: str, reason: str = "user-cancel") -> bool:
    """Cancel a running query by id; False when no such query runs."""
    tok = active_query_token(query_id)
    if tok is None:
        return False
    tok.cancel(reason)
    return True
