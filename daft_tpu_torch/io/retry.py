"""Retry policy for IO operations (port of ``daft_tpu/io/retry.py``).

Reference: src/daft-io/src/retry.rs — per-cloud retry with exponential
backoff + full jitter over transient statuses/errors; every retry is counted
in IO stats, and each backoff sleep in the registry's
``daft_io_retry_sleep_seconds``. The same policy object serves ranged reads
and multipart parts.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass
from typing import Callable, Optional, Tuple, Type

from daft_tpu_torch.errors import DaftIOError, DaftTransientError

RETRYABLE_HTTP = (408, 409, 425, 429, 500, 502, 503, 504)

# Backoff jitter draws from a module-owned Random instance, never the global
# `random` module, so a seeded run replays its retry cadence and no hidden
# global draw shifts other samples. seed_retry_jitter() pins it.
_jitter_rng = random.Random()


def seed_retry_jitter(seed: Optional[int]) -> None:
    """Make retry backoff reproducible (fault replay / bisecting flakes).
    ``None`` restores OS-seeded behavior."""
    global _jitter_rng
    _jitter_rng = random.Random(seed)


@dataclass(frozen=True)
class RetryPolicy:
    max_retries: int = 4
    backoff_base_s: float = 0.25
    backoff_cap_s: float = 16.0
    retryable_statuses: Tuple[int, ...] = RETRYABLE_HTTP
    retryable_exceptions: Tuple[Type[BaseException], ...] = (
        DaftTransientError, ConnectionError, TimeoutError, OSError)

    def sleep_s(self, attempt: int, retry_after: Optional[str] = None) -> float:
        if retry_after:
            delay = _parse_retry_after(retry_after)
            if delay is not None:
                return min(delay, self.backoff_cap_s)
        base = min(self.backoff_base_s * (2 ** attempt), self.backoff_cap_s)
        return base * (0.5 + _jitter_rng.random() / 2)  # full jitter, >= 50%


def _parse_retry_after(value: str) -> Optional[float]:
    """Retry-After per RFC 9110: delta-seconds OR an HTTP-date."""
    try:
        delay = float(value)
        return delay if delay >= 0 else None
    except ValueError:
        pass
    import datetime
    from email.utils import parsedate_to_datetime

    try:
        when = parsedate_to_datetime(value)
    except (TypeError, ValueError):
        return None
    if when.tzinfo is None:  # HTTP-dates are GMT
        when = when.replace(tzinfo=datetime.timezone.utc)
    delta = (when - datetime.datetime.now(datetime.timezone.utc)).total_seconds()
    return delta if delta > 0 else 0.0


def policy_from_config(io_config=None, scheme: str = "s3") -> RetryPolicy:
    """Per-cloud policy from IOConfig (num_tries / retry_initial_backoff)."""
    cfg = None
    if io_config is not None:
        cfg = getattr(io_config, {"s3": "s3", "gs": "gcs", "gcs": "gcs",
                                  "az": "azure", "abfs": "azure",
                                  "http": "http", "https": "http",
                                  "hf": "hf"}.get(scheme, "s3"), None)
    if cfg is None:
        return RetryPolicy()
    retries = getattr(cfg, "num_tries", None) or getattr(cfg, "max_retries", None)
    backoff_ms = getattr(cfg, "retry_initial_backoff_ms", None)
    return RetryPolicy(
        max_retries=int(retries) - 1 if retries else RetryPolicy.max_retries,
        backoff_base_s=(backoff_ms / 1000.0) if backoff_ms
        else RetryPolicy.backoff_base_s,
    )


def with_retries(fn: Callable, policy: RetryPolicy, *,
                 describe: str = "io operation",
                 is_retryable: Optional[Callable[[BaseException], bool]] = None,
                 on_retry: Optional[Callable[[], None]] = None,
                 deadline=None, breaker=None):
    """Run ``fn()`` under the policy. ``is_retryable`` may override the
    default exception-class test (e.g. to inspect an HTTP status).

    **Bounded time**: retries never sleep past the remaining budget. The
    budget is ``deadline`` (a :class:`~daft_tpu_torch.cancellation.Deadline`) if
    given, else the ambient query token's deadline (cancellation.py) — and a
    backoff sleep that would overrun it raises the LAST error immediately
    instead of sleeping into certain failure. With a live token, sleeps are
    also interruptible: a user cancel wakes the sleeper, which re-raises
    through the token. The per-attempt cap (``policy_from_config``) is
    unchanged.

    **Circuit breaking**: with a ``breaker``
    (:class:`~daft_tpu_torch.io.circuit.CircuitBreaker`), every attempt passes the
    breaker's admission check first — an open circuit fails fast with
    ``DaftCircuitOpenError`` (never counted as a new failure) — and attempt
    outcomes feed the breaker's state machine. Cancellation errors feed
    neither side: a dead query says nothing about the endpoint's health.
    """
    from daft_tpu_torch.cancellation import current_token
    from daft_tpu_torch.errors import DaftCancelledError, DaftCircuitOpenError

    token = current_token()
    if deadline is None and token is not None:
        deadline = token.deadline
    last: Optional[BaseException] = None
    for attempt in range(policy.max_retries + 1):
        if token is not None:
            token.check(describe)
        if breaker is not None:
            breaker.allow()
        try:
            result = fn()
        except BaseException as e:  # noqa: BLE001
            # Cancellation / interpreter-shutdown signals are NEVER retried,
            # even if a custom is_retryable would claim them (it's only ever
            # consulted for ordinary Exceptions).
            if not isinstance(e, Exception) or isinstance(e, DaftCancelledError):
                raise
            retryable = (is_retryable(e) if is_retryable is not None
                         else isinstance(e, policy.retryable_exceptions))
            if breaker is not None and retryable \
                    and not isinstance(e, DaftCircuitOpenError):
                breaker.record_failure()
            if not retryable or attempt >= policy.max_retries:
                raise
            last = e
            delay = policy.sleep_s(attempt, getattr(e, "retry_after", None))
            if deadline is not None and delay >= deadline.remaining():
                # Sleeping would overrun the remaining budget: surfacing the
                # real error NOW beats a guaranteed DaftTimeoutError later.
                raise
            if on_retry is not None:
                on_retry()
            from daft_tpu_torch import metrics

            if metrics.get_registry().enabled:
                metrics.RETRY_SLEEP.labels(
                    breaker.endpoint if breaker is not None
                    else "unattributed").observe(delay)
            if token is not None:
                if token.wait(delay):
                    token.check(describe)  # woken by cancel: raise through it
            else:
                time.sleep(delay)
        else:
            if breaker is not None:
                breaker.record_success()
            return result
    raise DaftIOError(f"{describe} failed after {policy.max_retries + 1} "
                      f"attempts: {last}")
