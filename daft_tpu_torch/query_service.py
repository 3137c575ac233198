"""The network front door: SQL queries submitted over HTTP or Arrow Flight
(port of ``daft_tpu/query_service.py``).

A client's SQL travels with its **tenant, deadline and priority** down the
path of an in-process ``collect()``: ``enter_front_door`` (the flight
record, the cancel token, the admission gate), the plan and result caches,
the SLO plane. A shed or timed-out remote query leaves the same admission
metrics and flight record as a local one.

Two transports share :func:`submit_query`:

* **HTTP**: ``POST /api/query`` on the dashboard's server
  (``subscribers/dashboard.py``), JSON ``{"sql", "tenant", "timeout_s",
  "priority", "max_rows"}`` in, the columns and the query's record facts
  out; a shed is 429 with ``Retry-After``, an expired deadline 504.
* **Arrow Flight**: ``QueryFlightServer.do_get``
  (``distributed/flight.py``) with the same JSON as its ticket, the result
  streamed back as Arrow record batches (:func:`submit_query_arrow`).

Tables come from the process's :class:`TableRegistry`
(``daft_tpu_torch.register_table``): named DataFrames, usually lazy reads,
that the SQL names. A request's priority can only lower its tenant's
(``admission.set_request_priority``).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, List, Optional

from daft_tpu_torch.errors import DaftValueError

log = logging.getLogger("daft_tpu_torch.query_service")

#: Response row cap unless the request asks lower: the HTTP front door
#: serves dashboard-sized answers, not bulk export (Flight is for bulk).
DEFAULT_MAX_ROWS = 10_000


class TableRegistry:
    """Named DataFrames servable to the query service (one per process)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._tables: Dict[str, object] = {}

    def register(self, name: str, df) -> None:
        if not name or not isinstance(name, str):
            raise DaftValueError(f"table name must be a non-empty string, got {name!r}")
        with self._lock:
            self._tables[name] = df

    def unregister(self, name: str) -> None:
        with self._lock:
            self._tables.pop(name, None)

    def tables(self) -> Dict[str, object]:
        with self._lock:
            return dict(self._tables)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._tables)

    def clear(self) -> None:
        with self._lock:
            self._tables.clear()


_REGISTRY: Optional[TableRegistry] = None
_registry_lock = threading.Lock()


def get_table_registry() -> TableRegistry:
    global _REGISTRY
    if _REGISTRY is None:
        with _registry_lock:
            if _REGISTRY is None:
                _REGISTRY = TableRegistry()
    return _REGISTRY


def register_table(name: str, df) -> None:
    """Serve ``df`` as SQL table ``name`` over the network front door
    (``daft_tpu_torch.register_table``)."""
    get_table_registry().register(name, df)


def submit_query(sql: str, tenant: Optional[str] = None,
                 timeout_s: Optional[float] = None,
                 priority: Optional[int] = None,
                 max_rows: Optional[int] = None) -> dict:
    """Run one SQL query against the registered tables with tenant,
    deadline, and priority carried into the admission front door. Returns
    the serialized result + the query's flight-recorder facts; raises the
    engine's own error taxonomy (the transport maps it to its status
    codes). This IS the in-process path — ``collect(timeout=...)`` under
    ``set_tenant``/``set_request_priority`` — so remote queries get the
    same admission/SLO/flight-recorder treatment as local ones."""
    from daft_tpu_torch import querylog
    from daft_tpu_torch.execution.admission import (
        set_request_priority,
        set_tenant,
    )
    from daft_tpu_torch.sql.planner import plan_sql

    if not sql or not isinstance(sql, str):
        raise DaftValueError("missing 'sql'")
    if max_rows is None:
        max_rows = DEFAULT_MAX_ROWS
    bindings = get_table_registry().tables()
    # Contextvars scope the tenant and the priority to this handler thread
    # (the HTTP server and Flight's handler pool run each request on a
    # thread), and both are cleared in the finally: a pooled thread's next
    # request starts clean.
    set_tenant(tenant)
    set_request_priority(priority)
    try:
        df = plan_sql(sql, bindings)
        t0 = time.monotonic()
        df = df.limit(int(max_rows) + 1) if max_rows else df
        df.collect(timeout=timeout_s)
        wall = time.monotonic() - t0
        data = df.to_pydict()
        n = len(next(iter(data.values()), []))
        truncated = bool(max_rows) and n > max_rows
        if truncated:
            data = {k: v[:max_rows] for k, v in data.items()}
            n = max_rows
        record = querylog.last_record() or {}
        return {
            "columns": list(data.keys()),
            "data": data,
            "row_count": n,
            "truncated": truncated,
            "duration_s": round(wall, 6),
            "query_id": record.get("query_id", ""),
            "tenant": record.get("tenant", tenant or ""),
            "outcome": record.get("outcome", "success"),
            "plan_cache_hit": bool(record.get("plan_cache_hit")),
            "result_cache_hit": bool(record.get("result_cache_hit")),
            "admission_wait_s": record.get("admission_wait_s", 0.0),
            "plan_fingerprint": record.get("plan_fingerprint", ""),
            # Schema v4's view block: {} until the streaming views
            # (ROADMAP A.8.6) serve an answer.
            "view": record.get("view", {}),
        }
    finally:
        set_request_priority(None)
        set_tenant(None)


def submit_query_arrow(sql: str, tenant: Optional[str] = None,
                       timeout_s: Optional[float] = None,
                       priority: Optional[int] = None):
    """Flight-path variant: same front-door treatment, result as one
    Arrow table (no row cap — Flight is the bulk transport)."""
    from daft_tpu_torch.execution.admission import (
        set_request_priority,
        set_tenant,
    )
    from daft_tpu_torch.sql.planner import plan_sql

    if not sql or not isinstance(sql, str):
        raise DaftValueError("missing 'sql'")
    set_tenant(tenant)
    set_request_priority(priority)
    try:
        df = plan_sql(sql, get_table_registry().tables())
        df.collect(timeout=timeout_s)
        return df.to_arrow()
    finally:
        set_request_priority(None)
        set_tenant(None)


def error_response(exc: BaseException) -> tuple:
    """(http_status, payload) for an engine error — one mapping shared by
    the HTTP and Flight transports so clients see consistent semantics:
    429 + Retry-After for admission sheds (transient: back off and
    resubmit), 504 for deadline expiry, 499 for cancels, 400 for bad
    queries, 500 for engine faults."""
    from daft_tpu_torch.errors import (
        DaftAdmissionError,
        DaftCancelledError,
        DaftError,
        DaftTimeoutError,
    )

    payload = {"error": str(exc)[:500], "kind": type(exc).__name__}
    if isinstance(exc, DaftAdmissionError):
        payload["retry_after_s"] = getattr(exc, "retry_after_s", 1.0)
        payload["tenant"] = getattr(exc, "tenant", "")
        payload["reason"] = getattr(exc, "reason", "")
        return 429, payload
    if isinstance(exc, DaftTimeoutError):
        return 504, payload
    if isinstance(exc, DaftCancelledError):
        return 499, payload
    if isinstance(exc, (DaftValueError, KeyError)):
        return 400, payload
    if isinstance(exc, DaftError):
        return 500, payload
    return 500, payload
