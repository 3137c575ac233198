"""Tracing & metrics: OTel-shaped spans with pluggable exporters (port of
``daft_tpu/tracing.py``).

Reference: src/common/tracing/src/lib.rs — the reference wires the OTel SDK
(OTLP traces + metrics + logs) behind ``DAFT_DEV_ENABLE_TRACING`` and tests
against in-memory exporters (tests/observability/test_opentelemetry.py).
The OTel *SDK* is not in this image, so this module implements the same
surface natively: spans carry OTel-compatible ids/attributes/status, the
in-memory exporter mirrors the SDK's test exporter, and the OTLP-JSON file
exporter writes `resourceSpans` payloads in the OTLP/HTTP JSON schema so an
external collector can ship them (zero-egress environments log to disk).

Attach a :class:`TracingSubscriber` explicitly to trace the engine, or set
``DAFT_DEV_ENABLE_TRACING`` (with ``DAFT_TRACE_FILE``, else
``daft_tpu_traces.jsonl`` in the temp directory): ``maybe_enable_tracing``,
called from ``context.notify``, attaches one to the context, as in the JAX
package.
"""

from __future__ import annotations

import json
import os
import secrets
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from daft_tpu_torch.subscribers.events import (
    CircuitClosed,
    CircuitOpened,
    Event,
    OperatorStats,
    OptimizationEnd,
    OptimizationStart,
    PartitionRecovered,
    QueryAdmitted,
    QueryCancelled,
    QueryEnd,
    QueryQueued,
    QueryShed,
    QueryStart,
    TaskCompleted,
    TaskRetried,
    TaskScheduled,
    WorkerLost,
)

# ------------------------------------------------------------------ #
# Span clock: ONE monotonic epoch per process                          #
# ------------------------------------------------------------------ #
# Span timestamps used to mix clock sources (time.time_ns() at span open,
# duration-derived ends), so cross-process span nesting could render
# negative durations when the wall clock stepped mid-span. Every span
# timestamp now derives from one pair captured at import: a wall-clock
# anchor plus a perf_counter offset — strictly monotonic within the
# process, wall-anchored across processes. Residual cross-host skew is
# corrected by the profiler's heartbeat RTT-midpoint offset estimate
# (profiling.py record_worker_clock).
_EPOCH_WALL_NS = time.time_ns()
_EPOCH_PERF_NS = time.perf_counter_ns()


def span_clock_ns() -> int:
    """Monotonic, wall-anchored nanoseconds — the clock for ALL span
    timestamps in this process."""
    return _EPOCH_WALL_NS + (time.perf_counter_ns() - _EPOCH_PERF_NS)


@dataclass
class Span:
    name: str
    trace_id: str
    span_id: str
    parent_id: Optional[str] = None
    start_ns: int = 0
    end_ns: int = 0
    attributes: Dict[str, Any] = field(default_factory=dict)
    status: str = "OK"  # OK | ERROR
    events: List[dict] = field(default_factory=list)

    def to_otlp(self) -> dict:
        """OTLP/JSON span (opentelemetry-proto trace v1)."""
        def attr(k, v):
            if isinstance(v, bool):
                val = {"boolValue": v}
            elif isinstance(v, int):
                val = {"intValue": str(v)}
            elif isinstance(v, float):
                val = {"doubleValue": v}
            else:
                val = {"stringValue": str(v)}
            return {"key": k, "value": val}

        return {
            "traceId": self.trace_id,
            "spanId": self.span_id,
            **({"parentSpanId": self.parent_id} if self.parent_id else {}),
            "name": self.name,
            "startTimeUnixNano": str(self.start_ns),
            "endTimeUnixNano": str(self.end_ns),
            "attributes": [attr(k, v) for k, v in self.attributes.items()],
            "status": {"code": 1 if self.status == "OK" else 2},
            "events": self.events,
        }


class SpanExporter:
    def export(self, spans: List[Span]) -> None:
        raise NotImplementedError

    def shutdown(self) -> None:
        pass


class InMemorySpanExporter(SpanExporter):
    """Mirrors the OTel SDK's test exporter (reference:
    tests/observability/test_opentelemetry.py uses in-memory exporters)."""

    def __init__(self):
        self._spans: List[Span] = []
        self._lock = threading.Lock()

    def export(self, spans: List[Span]) -> None:
        with self._lock:
            self._spans.extend(spans)

    def get_finished_spans(self) -> List[Span]:
        with self._lock:
            return list(self._spans)

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()


class OTLPJsonFileExporter(SpanExporter):
    """One OTLP/HTTP JSON `resourceSpans` payload per line."""

    def __init__(self, path: str, service_name: str = "daft_tpu_torch"):
        self.path = path
        self.service_name = service_name
        self._lock = threading.Lock()

    def export(self, spans: List[Span]) -> None:
        payload = {
            "resourceSpans": [{
                "resource": {"attributes": [{
                    "key": "service.name",
                    "value": {"stringValue": self.service_name}}]},
                "scopeSpans": [{
                    "scope": {"name": "daft_tpu_torch.tracing"},
                    "spans": [s.to_otlp() for s in spans],
                }],
            }]
        }
        with self._lock:
            with open(self.path, "a") as f:
                f.write(json.dumps(payload) + "\n")


class Tracer:
    """Span factory with thread-local parenting and batched export."""

    def __init__(self, exporter: SpanExporter):
        self.exporter = exporter
        self._local = threading.local()

    def _stack(self) -> List[Span]:
        if not hasattr(self._local, "stack"):
            self._local.stack = []
        return self._local.stack

    def start_span(self, name: str, attributes: Optional[Dict[str, Any]] = None,
                   trace_id: Optional[str] = None,
                   parent_id: Optional[str] = None) -> "_SpanCtx":
        stack = self._stack()
        parent = stack[-1] if stack else None
        span = Span(
            name=name,
            trace_id=trace_id or (parent.trace_id if parent else secrets.token_hex(16)),
            span_id=secrets.token_hex(8),
            parent_id=parent_id or (parent.span_id if parent else None),
            start_ns=span_clock_ns(),
            attributes=dict(attributes or {}),
        )
        return _SpanCtx(self, span)

    def _finish(self, span: Span) -> None:
        span.end_ns = span_clock_ns()
        self.exporter.export([span])


class _SpanCtx:
    def __init__(self, tracer: Tracer, span: Span):
        self.tracer = tracer
        self.span = span

    def __enter__(self) -> Span:
        self.tracer._stack().append(self.span)
        return self.span

    def __exit__(self, exc_type, exc, tb) -> None:
        self.tracer._stack().pop()
        if exc is not None:
            self.span.status = "ERROR"
            self.span.attributes["error"] = repr(exc)
        self.tracer._finish(self.span)


# ------------------------------------------------------------------ #
# Metrics (counters + histograms -> OTLP-JSON resourceMetrics)        #
# ------------------------------------------------------------------ #
class Meter:
    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = {}
        self._hist: Dict[str, List[float]] = {}

    def add(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + value

    def record(self, name: str, value: float) -> None:
        with self._lock:
            self._hist.setdefault(name, []).append(value)

    def snapshot(self) -> dict:
        with self._lock:
            hists = {}
            for k, vs in self._hist.items():
                hists[k] = {"count": len(vs), "sum": sum(vs),
                            "min": min(vs), "max": max(vs)}
            return {"counters": dict(self._counters), "histograms": hists}

    def to_otlp(self, service_name: str = "daft_tpu_torch") -> dict:
        snap = self.snapshot()
        now = str(time.time_ns())
        metrics = []
        for k, v in snap["counters"].items():
            metrics.append({"name": k, "sum": {
                "dataPoints": [{"asDouble": v, "timeUnixNano": now}],
                "isMonotonic": True, "aggregationTemporality": 2}})
        for k, h in snap["histograms"].items():
            metrics.append({"name": k, "histogram": {
                "dataPoints": [{"count": str(h["count"]), "sum": h["sum"],
                                "min": h["min"], "max": h["max"],
                                "timeUnixNano": now}],
                "aggregationTemporality": 2}})
        return {"resourceMetrics": [{
            "resource": {"attributes": [{
                "key": "service.name", "value": {"stringValue": service_name}}]},
            "scopeMetrics": [{"scope": {"name": "daft_tpu_torch.metrics"},
                              "metrics": metrics}],
        }]}


# ------------------------------------------------------------------ #
# Engine integration: Events -> spans + metrics                        #
# ------------------------------------------------------------------ #
class TracingSubscriber:
    """Converts the engine's Event stream into spans/metrics (reference:
    operator-level tracing::Instrument spans in swordfish +
    src/daft-context subscriber dispatch)."""

    def __init__(self, exporter: Optional[SpanExporter] = None,
                 meter: Optional[Meter] = None):
        self.exporter = exporter or InMemorySpanExporter()
        self.meter = meter or Meter()
        self._open: Dict[str, Span] = {}
        self._lock = threading.Lock()

    def on_event(self, e: Event) -> None:
        now = span_clock_ns()
        with self._lock:
            if isinstance(e, QueryStart):
                self._open[e.query_id] = Span(
                    name="daft.query", trace_id=secrets.token_hex(16),
                    span_id=secrets.token_hex(8), start_ns=now,
                    attributes={"query_id": e.query_id})
                self.meter.add("daft.queries.started")
            elif isinstance(e, QueryEnd):
                span = self._open.pop(e.query_id, None)
                if span is not None:
                    span.end_ns = now
                    if e.error:
                        span.status = "ERROR"
                        span.attributes["error"] = e.error
                    span.attributes["duration_s"] = e.duration_s
                    self.exporter.export([span])
                self.meter.add("daft.queries.ended")
                self.meter.record("daft.query.duration_s", e.duration_s)
            elif isinstance(e, (OptimizationStart, OptimizationEnd, TaskScheduled)):
                parent = self._open.get(e.query_id)
                if parent is not None:
                    parent.events.append({
                        "name": type(e).__name__, "timeUnixNano": str(now)})
            elif isinstance(e, TaskCompleted):
                parent = self._open.get(e.query_id)
                span = Span(
                    name="daft.task",
                    trace_id=parent.trace_id if parent else secrets.token_hex(16),
                    span_id=secrets.token_hex(8),
                    parent_id=parent.span_id if parent else None,
                    start_ns=now - int(e.duration_s * 1e9), end_ns=now,
                    attributes={"task_id": e.task_id, "worker_id": e.worker_id},
                    status="ERROR" if e.error else "OK")
                self.exporter.export([span])
                self.meter.add("daft.tasks.completed")
            elif isinstance(e, OperatorStats):
                parent = self._open.get(e.query_id)
                span = Span(
                    name=f"daft.operator.{e.operator}",
                    trace_id=parent.trace_id if parent else secrets.token_hex(16),
                    span_id=secrets.token_hex(8),
                    parent_id=parent.span_id if parent else None,
                    start_ns=now - e.cpu_us * 1000, end_ns=now,
                    attributes={"operator": e.operator, "rows_in": e.rows_in,
                                "rows_out": e.rows_out, "cpu_us": e.cpu_us})
                self.exporter.export([span])
                self.meter.add("daft.rows.processed", e.rows_out)
                self.meter.record(f"daft.operator.{e.operator}.cpu_us", e.cpu_us)
            elif isinstance(e, TaskRetried):
                self.meter.add("daft.tasks.retried")
                self.meter.add(f"daft.tasks.retried.{e.reason}")
            elif isinstance(e, WorkerLost):
                self.meter.add("daft.workers.lost")
            elif isinstance(e, PartitionRecovered):
                self.meter.add("daft.partitions.recovered", e.num_partitions or 1)
            elif isinstance(e, QueryCancelled):
                parent = self._open.get(e.query_id)
                if parent is not None:
                    parent.status = "ERROR"
                    parent.attributes["cancel_reason"] = e.reason
                    parent.events.append({
                        "name": "QueryCancelled", "timeUnixNano": str(now)})
                self.meter.add("daft.queries.cancelled")
                self.meter.add(f"daft.queries.cancelled.{e.reason or 'unknown'}")
            elif isinstance(e, CircuitOpened):
                self.meter.add("daft.circuit.opened")
                self.meter.record("daft.circuit.open_for_s", e.open_for_s)
            elif isinstance(e, CircuitClosed):
                self.meter.add("daft.circuit.closed")
            # Admission events fire BEFORE QueryStart (the front door is
            # ahead of planning), so there is no open query span to attach
            # to — they land on the meter, keyed by tenant.
            elif isinstance(e, QueryQueued):
                self.meter.add("daft.admission.queued")
                self.meter.record("daft.admission.queue_depth", e.queue_depth)
            elif isinstance(e, QueryAdmitted):
                # No per-tenant meter keys: tenant ids are caller-supplied
                # strings (unbounded cardinality for the life of the
                # process); the metrics registry already carries tenant as
                # a proper evictable label.
                self.meter.add("daft.admission.admitted")
                self.meter.record("daft.admission.wait_s", e.wait_s)
            elif isinstance(e, QueryShed):
                self.meter.add("daft.admission.shed")
                # reason is a fixed engine enum (5 values) — bounded.
                self.meter.add(
                    f"daft.admission.shed.{e.reason or 'unknown'}")


_auto_subscriber: Optional[TracingSubscriber] = None
_auto_lock = threading.Lock()


def maybe_enable_tracing(context) -> None:
    """Env-gated auto-attach (reference: DAFT_DEV_ENABLE_TRACING)."""
    global _auto_subscriber
    from daft_tpu_torch.config import daft_env

    if _auto_subscriber is not None or not daft_env("DAFT_DEV_ENABLE_TRACING"):
        return
    with _auto_lock:
        if _auto_subscriber is not None:  # double-checked: notify() races
            return
        path = daft_env("DAFT_TRACE_FILE")
        if not path:
            import tempfile

            path = os.path.join(tempfile.gettempdir(), "daft_tpu_traces.jsonl")
        sub = TracingSubscriber(OTLPJsonFileExporter(path))
        context.attach_subscriber(sub)
        _auto_subscriber = sub
