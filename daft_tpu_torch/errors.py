"""Error hierarchy for the engine (port of ``daft_tpu/errors.py``).

Mirrors the reference's ``DaftError`` / ``DaftResult`` error taxonomy
(reference: src/common/error/src/lib.rs) as Python exceptions.
"""

from __future__ import annotations


class DaftError(Exception):
    """Base class for all engine errors."""


class DaftTypeError(DaftError, TypeError):
    """Type mismatch in expressions, casts, or kernels."""


class DaftSchemaError(DaftError):
    """Schema mismatch / unresolvable field."""


class DaftValueError(DaftError, ValueError):
    """Invalid argument value."""


class DaftNotImplementedError(DaftError, NotImplementedError):
    """Feature not implemented yet."""


class DaftIOError(DaftError, IOError):
    """IO-layer failure (object store, file format decode)."""


class DaftCorruptionError(DaftIOError):
    """A persisted or wire-crossing artifact failed integrity verification
    (``daft_tpu/integrity.py``; not ported yet): the bytes read do not match the digest minted
    at write time. Deliberately NOT transient — re-reading the same bad
    bytes cannot succeed; the artifact is quarantined and the fix is
    lineage recompute (shuffle chunks), task re-execution (spill files),
    or a cold start (checkpoints). ``ticket`` names the shuffle chunk for
    lineage recovery when the artifact is chunk-shaped."""

    def __init__(self, message: str, artifact: str = "", path: str = "",
                 ticket: str = ""):
        super().__init__(message)
        self.artifact = artifact
        self.path = path
        self.ticket = ticket

    def __reduce__(self):
        # Pickle-safe across the process-worker wire (the same survival
        # contract PartitionFetchError keeps).
        return (DaftCorruptionError,
                (self.args[0], self.artifact, self.path, self.ticket))


class DaftPlanError(DaftError):
    """Logical/physical planning failure."""


class DaftExecutionError(DaftError):
    """Runtime execution failure."""


class DaftTransientError(DaftError):
    """Retryable failure (mirrors reference retry taxonomy in
    src/daft-io/src/retry.rs and python_udf/retry.rs)."""


class DaftCircuitOpenError(DaftTransientError):
    """An IO endpoint's circuit breaker is open: the call failed fast
    instead of re-hitting a flapping host (io/circuit.py). Transient by
    classification — the dispatcher's retry/backoff machinery handles it,
    and a later attempt may land after the breaker's probe succeeds."""

    def __init__(self, message: str, endpoint: str = ""):
        super().__init__(message)
        self.endpoint = endpoint


class DaftAdmissionError(DaftTransientError):
    """The query was rejected at the admission front door
    (execution/admission.py) before planning or dispatch: tenant quota
    saturated with a full wait queue, remaining deadline smaller than the
    estimated queue wait, or overload shedding. Transient by
    classification — the condition is load, not the query: clients should
    back off ``retry_after_s`` seconds and resubmit."""

    def __init__(self, message: str, tenant: str = "", reason: str = "",
                 queue_depth: int = 0, retry_after_s: float = 0.0):
        super().__init__(message)
        self.tenant = tenant
        self.reason = reason
        self.queue_depth = queue_depth
        self.retry_after_s = retry_after_s


class DaftCancelledError(DaftError):
    """The query was cancelled (user cancel or executor abort) and this
    unit of work observed the cancel token cooperatively. Deliberately NOT
    transient: retrying cancelled work defeats the cancel. ``progress``
    (when set) snapshots where the query was — a query cancelled while
    still waiting in the admission queue carries ``{"queued": True}``."""

    def __init__(self, message: str = "", progress: "dict | None" = None):
        super().__init__(message)
        self.progress = progress or {}


class DaftTimeoutError(DaftCancelledError):
    """The query's deadline expired (``df.collect(timeout=...)`` /
    ``DAFT_QUERY_TIMEOUT_S``). ``progress`` carries the per-task state at
    expiry: ``{"completed": int, "running": [...], "pending": int}``."""

    def __init__(self, message: str, progress: "dict | None" = None):
        super().__init__(message)
        self.progress = progress or {}
