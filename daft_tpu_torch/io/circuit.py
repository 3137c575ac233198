"""Per-endpoint IO circuit breakers (port of ``daft_tpu/io/circuit.py``).

When an endpoint fails repeatedly, every queued task re-hitting it burns its
own retry budget against a host that is down. A shared breaker per endpoint
turns that into: after ``failure_threshold`` consecutive transient failures
the circuit **opens** and calls fail fast with :class:`DaftCircuitOpenError`
(classified transient); after a seeded-jitter backoff one **half-open**
probe is let through; a probe success **closes** the circuit, a failure
re-opens it with a doubled delay.

State machines are process-wide (module registry keyed by endpoint) so every
task shares one view of a host's health: one per S3 / GCS endpoint and HTTP
origin, and one ``file://local`` endpoint for local files. Transitions emit
``CircuitOpened`` / ``CircuitClosed`` events through the engine context and
move the registry's ``daft_circuit_state`` gauge and transition counter. Not
ported yet: the fault-injection hook in ``allow`` (the distributed layer's
``maybe_inject``, ROADMAP A.8.5).
"""

from __future__ import annotations

import random
import threading
import time
from typing import Dict, Optional
from urllib.parse import urlsplit

from daft_tpu_torch.errors import DaftCircuitOpenError
from daft_tpu_torch.metrics import record_circuit_state
from daft_tpu_torch.subscribers.events import CircuitClosed, CircuitOpened

_jitter_rng = random.Random()


def seed_circuit_jitter(seed: Optional[int]) -> None:
    """Pin probe-timing jitter (fault replay). ``None`` restores OS seeding."""
    global _jitter_rng
    _jitter_rng = random.Random(seed)


CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

# The JAX package's ``ExecutionConfig`` defaults: consecutive transient
# failures that open a circuit; base and cap of the open -> half-open probe
# delay; probes let through while half-open.
FAILURE_THRESHOLD = 5
OPEN_BASE_S = 1.0
OPEN_CAP_S = 30.0
HALF_OPEN_PROBES = 1


class CircuitBreaker:
    """One endpoint's closed/open/half-open state machine. Thread-safe;
    event notification happens outside the lock."""

    def __init__(self, endpoint: str,
                 failure_threshold: int = FAILURE_THRESHOLD,
                 open_base_s: float = OPEN_BASE_S,
                 open_cap_s: float = OPEN_CAP_S,
                 half_open_probes: int = HALF_OPEN_PROBES):
        self.endpoint = endpoint
        self.failure_threshold = max(int(failure_threshold), 1)
        self.open_base_s = float(open_base_s)
        self.open_cap_s = float(open_cap_s)
        self.half_open_probes = max(int(half_open_probes), 1)
        self._lock = threading.Lock()
        self._state = CLOSED
        self._consecutive_failures = 0
        self._open_count = 0          # consecutive opens (backoff exponent)
        self._probe_at = 0.0          # monotonic instant half-open unlocks
        self._probes_inflight = 0
        self._probe_window_until = 0.0  # half-open quota re-arms after this

    # -- introspection ----------------------------------------------------
    def state(self) -> str:
        with self._lock:
            return self._state

    # -- the three verbs --------------------------------------------------
    def allow(self) -> None:
        """Admission check before an attempt. Raises
        :class:`DaftCircuitOpenError` while the circuit is open (and it is
        not yet probe time); lets ONE probe per ``half_open_probes`` slot
        through once the backoff elapses."""
        became_half_open = False
        try:
            with self._lock:
                if self._state == CLOSED:
                    return
                now = time.monotonic()
                if self._state == OPEN:
                    if now < self._probe_at:
                        wait_s = self._probe_at - now
                        raise DaftCircuitOpenError(
                            f"circuit open for {self.endpoint} "
                            f"({self._consecutive_failures} consecutive "
                            f"failures; probe in {wait_s:.2f}s)",
                            endpoint=self.endpoint)
                    self._state = HALF_OPEN
                    self._probes_inflight = 0
                    became_half_open = True
                # HALF_OPEN: recovery is PROBED, not stampeded — admit only
                # the configured probe quota, fail the rest fast. The quota
                # re-arms once the probe window passes WITHOUT an outcome: a
                # probe whose caller never reports back (cancelled query,
                # non-retryable error, abandoned stream) must not wedge the
                # breaker half-open.
                if self._probes_inflight >= self.half_open_probes:
                    if now < self._probe_window_until:
                        raise DaftCircuitOpenError(
                            f"circuit half-open for {self.endpoint}: probe "
                            f"quota in flight", endpoint=self.endpoint)
                    self._probes_inflight = 0  # probe vanished: re-arm
                self._probes_inflight += 1
                self._probe_window_until = now + max(self.open_base_s, 0.1)
        finally:
            if became_half_open:
                record_circuit_state(self.endpoint, HALF_OPEN)

    def reset(self) -> None:
        """Force back to a pristine CLOSED state (no events)."""
        with self._lock:
            was_closed = self._state == CLOSED
            self._state = CLOSED
            self._consecutive_failures = 0
            self._open_count = 0
            self._probes_inflight = 0
            self._probe_at = 0.0
            self._probe_window_until = 0.0
        if not was_closed:
            record_circuit_state(self.endpoint, CLOSED)

    def record_success(self) -> None:
        closed = False
        with self._lock:
            self._consecutive_failures = 0
            if self._state != CLOSED:
                self._state = CLOSED
                self._open_count = 0
                self._probes_inflight = 0
                closed = True
        if closed:
            record_circuit_state(self.endpoint, CLOSED)
            self._notify_closed()

    def record_failure(self) -> None:
        """Count one transient failure; trip open at the threshold (or
        instantly from half-open — the probe failing IS the evidence)."""
        opened = failures = 0
        with self._lock:
            self._consecutive_failures += 1
            trip = (self._state == HALF_OPEN
                    or (self._state == CLOSED
                        and self._consecutive_failures >= self.failure_threshold))
            if trip:
                self._state = OPEN
                self._open_count += 1
                self._probes_inflight = 0
                delay = min(self.open_base_s * (2 ** (self._open_count - 1)),
                            self.open_cap_s)
                # Full jitter >= 50% (same shape as retry.py backoff): probes
                # from many workers against one recovered host spread out.
                delay *= 0.5 + _jitter_rng.random() / 2
                self._probe_at = time.monotonic() + delay
                opened, failures = delay, self._consecutive_failures
        if opened:
            record_circuit_state(self.endpoint, OPEN)
            self._notify_opened(failures, opened)

    # -- events -----------------------------------------------------------
    def _notify_opened(self, failures: int, open_for_s: float) -> None:
        from daft_tpu_torch.context import get_context

        get_context().notify(CircuitOpened(
            endpoint=self.endpoint, failures=failures, open_for_s=open_for_s))

    def _notify_closed(self) -> None:
        from daft_tpu_torch.context import get_context

        get_context().notify(CircuitClosed(endpoint=self.endpoint))


# --------------------------------------------------------------------- #
# Process-wide registry                                                   #
# --------------------------------------------------------------------- #
_BREAKERS: Dict[str, CircuitBreaker] = {}
_registry_lock = threading.Lock()


def breaker_for(endpoint: str, **overrides) -> CircuitBreaker:
    """The shared breaker for ``endpoint`` (created on first use).
    ``overrides`` apply only at creation — the first caller's view wins,
    which keeps every task sharing ONE state machine per endpoint."""
    with _registry_lock:
        b = _BREAKERS.get(endpoint)
        if b is None:
            b = _BREAKERS[endpoint] = CircuitBreaker(endpoint, **overrides)
        return b


def breaker_for_url(url: str) -> CircuitBreaker:
    """Breaker keyed by the URL's scheme://host[:port] (one per origin)."""
    parts = urlsplit(url if "://" in url else f"https://{url}")
    return breaker_for(f"{parts.scheme}://{parts.netloc}")


def endpoint_of(path: str) -> str:
    """Breaker key for an object path: the origin for URL-shaped paths,
    one shared ``file://local`` endpoint for plain local paths (local disks
    fail together)."""
    if "://" in path:
        parts = urlsplit(path)
        return f"{parts.scheme}://{parts.netloc or 'local'}"
    return "file://local"


def reset_circuit_breakers() -> None:
    """Drop all breaker state (tests). Existing breaker OBJECTS are reset in
    place: a caller that cached its breaker must not keep a tripped one
    while later lookups get a fresh (divergent) state machine."""
    with _registry_lock:
        stale = list(_BREAKERS.values())
        _BREAKERS.clear()
    for b in stale:
        b.reset()
