"""Unified metrics plane: engine-wide registry, worker aggregation, export
(port of ``daft_tpu/metrics.py``, whole).

Reference: the reference engine wires OTel SDK metrics behind
``DAFT_DEV_ENABLE_TRACING`` (src/common/tracing) — counters for every hot
path, scraped centrally. The OTel SDK is not in this image, so this module
implements the same surface natively, as the metrics twin of ``tracing.py``:

* a process-wide :class:`MetricRegistry` of labeled :class:`Counter` /
  :class:`Gauge` / :class:`Histogram` instruments (fixed exponential bucket
  boundaries, lock-cheap increments, ``snapshot()``/``reset()`` for tests
  and ``fault_scope``);
* two exporters — **Prometheus text exposition** (``to_prometheus``; the
  dashboard's ``/metrics`` route that serves it is ROADMAP A.8) and **OTLP/HTTP JSON** ``resourceMetrics``
  payloads written alongside ``tracing.py``'s ``resourceSpans`` file
  exporter (``metrics_export_path``);
* **worker→driver aggregation**: each worker piggybacks its registry's
  cumulative :meth:`~MetricRegistry.to_wire` snapshot on the existing
  heartbeat/ping and task-reply wires (mirroring ``RuntimeStats.to_wire``);
  the driver merges per-worker snapshots into the registry under a
  ``worker_id`` label — storing the **latest cumulative** wire per worker so
  repeated heartbeats never double count (each merge replaces the previous
  delta baseline) — and marks a worker's series stale when ``WorkerLost``
  fires, so a killed worker's counters stop being scraped as live. The
  merge is pure registry code; the distributed layer that ships the wires
  is ROADMAP A.8.

``DAFT_METRICS=0``, or ``metrics_enabled=False`` on the execution config,
disables the whole plane with a zero-allocation
fast path: ``labels()`` returns one shared no-op child and increments become
attribute-check no-ops (``chip_smoke.py``'s phase 19 measures enabled against
disabled on a TPC-H-style loop, as the JAX package's ``bench.py`` does). That switch is deliberate
and TOTAL: the spill / device-eval / AI-token tallies now live on this
registry (their legacy objects are thin shims), so disabling metrics also
empties ``spill_metrics.snapshot()``, ``token_metrics()``, and the
EXPLAIN ANALYZE delta lines — there is one measurement plane, on or off,
not a second bookkeeping path that silently survives the kill switch.

Per-query attribution rides the ambient cancellation scope: hot paths that
do not carry a query id (IO) label their per-query series via
:func:`current_query_id`, which reads the ``cancel_scope`` contextvar.
"""

from __future__ import annotations

import bisect
import json
import threading
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple


def exponential_buckets(start: float, factor: float, count: int) -> Tuple[float, ...]:
    """``count`` exponentially spaced upper bounds: start, start*factor, …"""
    if start <= 0 or factor <= 1 or count < 1:
        raise ValueError("need start > 0, factor > 1, count >= 1")
    out, v = [], float(start)
    for _ in range(count):
        out.append(v)
        v *= factor
    return tuple(out)


#: Default latency boundaries: 1 ms … ~32.8 s (doublings).
LATENCY_BUCKETS_S = exponential_buckets(0.001, 2.0, 16)
#: Default size boundaries: 1 KiB … 1 GiB (x4 steps).
BYTES_BUCKETS = exponential_buckets(1024.0, 4.0, 11)


# --------------------------------------------------------------------- #
# Children (one labeled series each)                                     #
# --------------------------------------------------------------------- #
class _NoopChild:
    """Shared do-nothing series returned while metrics are disabled. One
    module-level singleton: the disabled fast path allocates nothing."""

    __slots__ = ()

    def inc(self, value: float = 1.0) -> None:
        pass

    def dec(self, value: float = 1.0) -> None:
        pass

    def set(self, value: float) -> None:
        pass

    def observe(self, value: float) -> None:
        pass

    def value(self) -> float:
        return 0.0


NOOP = _NoopChild()


class _CounterChild:
    __slots__ = ("_value", "_lock")

    def __init__(self):
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, value: float = 1.0) -> None:
        with self._lock:
            self._value += value

    def value(self) -> float:
        return self._value

    def _reset(self) -> None:
        with self._lock:
            self._value = 0.0


class _GaugeChild(_CounterChild):
    __slots__ = ()

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def dec(self, value: float = 1.0) -> None:
        with self._lock:
            self._value -= value


class _HistogramChild:
    __slots__ = ("bounds", "_counts", "_sum", "_count", "_lock")

    def __init__(self, bounds: Sequence[float]):
        self.bounds = tuple(bounds)
        self._counts = [0] * (len(self.bounds) + 1)  # +1: overflow (+Inf)
        self._sum = 0.0
        self._count = 0
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        i = bisect.bisect_left(self.bounds, value)
        with self._lock:
            self._counts[i] += 1
            self._sum += value
            self._count += 1

    def value(self) -> float:  # uniform child interface: the running sum
        return self._sum

    def hist_state(self) -> dict:
        with self._lock:
            return {"bucket_counts": list(self._counts), "sum": self._sum,
                    "count": self._count, "bounds": list(self.bounds)}

    def _reset(self) -> None:
        with self._lock:
            self._counts = [0] * (len(self.bounds) + 1)
            self._sum = 0.0
            self._count = 0


# --------------------------------------------------------------------- #
# Instruments (parent objects holding labeled children)                   #
# --------------------------------------------------------------------- #
class _Instrument:
    kind = "counter"
    _child_cls = _CounterChild

    def __init__(self, registry: "MetricRegistry", name: str, help: str,
                 labelnames: Tuple[str, ...],
                 max_series: Optional[int] = None,
                 ship_on_wire: bool = True):
        self._registry = registry
        self.name = name
        self.help = help
        self.labelnames = labelnames
        # Cardinality bound for unbounded-value labels (query ids): once
        # exceeded, the OLDEST series is evicted (children are
        # insertion-ordered). Bounds the registry, every heartbeat wire, and
        # every scrape in a long-lived serving process.
        self.max_series = max_series
        # ship_on_wire=False keeps a process-local instrument out of
        # to_wire(): workers never see QueryEnd, so per-query series they
        # shipped would be re-exported as live long after the query died.
        self.ship_on_wire = ship_on_wire
        self._children: Dict[Tuple[str, ...], object] = {}
        self._lock = threading.Lock()
        self._default = None  # the () child for label-less instruments

    def _make_child(self):
        return self._child_cls()

    def labels(self, *values, **kv):
        """The child series for one label-value combination. Returns the
        shared no-op singleton while metrics are disabled (nothing is
        allocated on the disabled path)."""
        if not self._registry.enabled:
            return NOOP
        if kv:
            try:
                values = tuple(str(kv[n]) for n in self.labelnames)
            except KeyError as e:
                raise ValueError(
                    f"{self.name}: missing label {e} "
                    f"(expected {self.labelnames})") from e
        else:
            values = tuple(str(v) for v in values)
        if len(values) != len(self.labelnames):
            raise ValueError(f"{self.name}: expected labels "
                             f"{self.labelnames}, got {values}")
        child = self._children.get(values)
        if child is None:
            with self._lock:
                child = self._children.setdefault(values, self._make_child())
                if self.max_series is not None:
                    while len(self._children) > self.max_series:
                        self._children.pop(next(iter(self._children)))
        return child

    def remove_matching(self, label: str, value: str) -> None:
        """Drop every series whose ``label`` equals ``value`` (per-query
        eviction at QueryEnd)."""
        if label not in self.labelnames:
            return
        i = self.labelnames.index(label)
        with self._lock:
            for k in [k for k in self._children if k[i] == str(value)]:
                del self._children[k]

    def _default_child(self):
        if not self._registry.enabled:
            return NOOP
        if self._default is None:
            self._default = self.labels()
        return self._default

    # Label-less convenience (checked against the enabled flag per call so
    # runtime toggles behave).
    def inc(self, value: float = 1.0) -> None:
        self._default_child().inc(value)

    def series(self) -> List[Tuple[Tuple[str, ...], object]]:
        with self._lock:
            return list(self._children.items())

    def reset(self) -> None:
        with self._lock:
            for c in self._children.values():
                c._reset()


class Counter(_Instrument):
    kind = "counter"
    _child_cls = _CounterChild


class Gauge(_Instrument):
    kind = "gauge"
    _child_cls = _GaugeChild

    def set(self, value: float) -> None:
        self._default_child().set(value)

    def dec(self, value: float = 1.0) -> None:
        self._default_child().dec(value)


class Histogram(_Instrument):
    kind = "histogram"

    def __init__(self, registry, name, help, labelnames,
                 buckets: Sequence[float] = LATENCY_BUCKETS_S,
                 max_series: Optional[int] = None,
                 ship_on_wire: bool = True):
        super().__init__(registry, name, help, labelnames,
                         max_series=max_series, ship_on_wire=ship_on_wire)
        self.buckets = tuple(buckets)

    def _make_child(self):
        return _HistogramChild(self.buckets)

    def observe(self, value: float) -> None:
        self._default_child().observe(value)


# --------------------------------------------------------------------- #
# Registry                                                                #
# --------------------------------------------------------------------- #
class MetricsSnapshot:
    """Point-in-time view of a registry (local + live worker series) with
    delta-friendly accessors — ``EXPLAIN ANALYZE`` subtracts two of these."""

    def __init__(self, raw: dict):
        self.raw = raw  # {name: {"kind","help","series":[{labels,value|hist}]}}

    def counter_total(self, name: str) -> float:
        m = self.raw.get(name)
        if not m:
            return 0.0
        return sum(s.get("value", 0.0) for s in m["series"])

    def label_totals(self, name: str, label: str) -> Dict[str, float]:
        out: Dict[str, float] = {}
        m = self.raw.get(name)
        for s in (m["series"] if m else ()):
            key = s["labels"].get(label, "")
            out[key] = out.get(key, 0.0) + s.get("value", 0.0)
        return out

    def value(self, name: str, **labels) -> float:
        m = self.raw.get(name)
        want = {k: str(v) for k, v in labels.items()}
        for s in (m["series"] if m else ()):
            if all(s["labels"].get(k) == v for k, v in want.items()):
                return s.get("value", 0.0)
        return 0.0

    def hist(self, name: str) -> Dict[str, float]:
        m = self.raw.get(name)
        count = total = 0.0
        for s in (m["series"] if m else ()):
            count += s.get("count", 0.0)
            total += s.get("sum", 0.0)
        return {"count": count, "sum": total}


class MetricRegistry:
    """Process-wide instrument registry + worker-snapshot aggregator."""

    def __init__(self, enabled: Optional[bool] = None):
        if enabled is None:
            from daft_tpu_torch.config import daft_env_flag

            enabled = daft_env_flag("DAFT_METRICS", True)
        self.enabled = enabled
        self._instruments: Dict[str, _Instrument] = {}
        self._lock = threading.Lock()
        # worker_id -> latest cumulative wire snapshot; replacing (not
        # adding) the stored wire is what makes repeated heartbeat merges
        # idempotent — the previous snapshot IS the delta baseline.
        self._workers: Dict[str, dict] = {}
        self._stale: set = set()
        # worker_id -> {metric_name: wire entry captured at reset(name)}.
        # Workers keep counting cumulatively through a driver-side reset, so
        # the next heartbeat would re-deliver pre-reset totals wholesale;
        # subtracting the captured baseline at read time keeps shim resets
        # (spill/token) honest in distributed runs.
        self._baselines: Dict[str, Dict[str, dict]] = {}

    # -- instrument factories (idempotent by name) ------------------------
    def _register(self, cls, name: str, help: str,
                  labelnames: Iterable[str], **kw) -> _Instrument:
        labelnames = tuple(labelnames)
        with self._lock:
            inst = self._instruments.get(name)
            if inst is not None:
                if inst.kind != cls.kind or inst.labelnames != labelnames:
                    raise ValueError(
                        f"metric {name} re-registered as {cls.kind}"
                        f"{labelnames} (was {inst.kind}{inst.labelnames})")
                return inst
            inst = cls(self, name, help, labelnames, **kw)
            self._instruments[name] = inst
            return inst

    def counter(self, name: str, help: str = "",
                labelnames: Iterable[str] = (),
                max_series: Optional[int] = None,
                ship_on_wire: bool = True) -> Counter:
        return self._register(Counter, name, help, labelnames,
                              max_series=max_series,
                              ship_on_wire=ship_on_wire)

    def gauge(self, name: str, help: str = "",
              labelnames: Iterable[str] = (),
              max_series: Optional[int] = None) -> Gauge:
        return self._register(Gauge, name, help, labelnames,
                              max_series=max_series)

    def histogram(self, name: str, help: str = "",
                  labelnames: Iterable[str] = (),
                  buckets: Sequence[float] = LATENCY_BUCKETS_S,
                  max_series: Optional[int] = None) -> Histogram:
        return self._register(Histogram, name, help, labelnames,
                              buckets=buckets, max_series=max_series)

    # -- worker aggregation ----------------------------------------------
    def to_wire(self) -> dict:
        """Compact JSON/pickle-safe cumulative snapshot for the heartbeat
        wire (the ``RuntimeStats.to_wire`` shape, one level richer).
        Excludes ship_on_wire=False instruments — per-query series stay
        process-local (workers never see QueryEnd, so shipped ones would
        outlive their queries on every scrape)."""
        return self._collect(include_local_only=False)

    def _collect(self, include_local_only: bool) -> dict:
        out: Dict[str, dict] = {}
        with self._lock:
            instruments = [i for i in self._instruments.values()
                           if include_local_only or i.ship_on_wire]
        for inst in instruments:
            series = []
            for values, child in inst.series():
                labels = dict(zip(inst.labelnames, values))
                if inst.kind == "histogram":
                    series.append({"labels": labels, **child.hist_state()})
                else:
                    series.append({"labels": labels, "value": child.value()})
            if series:
                out[inst.name] = {"kind": inst.kind, "help": inst.help,
                                  "series": series}
        return out

    def merge_worker_wire(self, worker_id: str, wire: Optional[dict],
                          revive: bool = True) -> None:
        """Fold one worker's cumulative snapshot in under ``worker_id``
        labels. ``revive=True`` (heartbeat path: an answered ping IS
        liveness evidence) clears a staleness mark; ``revive=False`` (task
        replies) only updates the stored wire — a reply that raced the
        worker's death on a still-open connection must not re-export a
        WorkerLost worker as live (death is sticky: the scheduler never
        routes to it again, so nothing would ever re-mark it)."""
        if not self.enabled or not worker_id:
            return
        with self._lock:
            if wire:
                self._workers[worker_id] = wire
            if not revive and worker_id in self._stale:
                return
            self._stale.discard(worker_id)
        self.gauge("daft_worker_up",
                   "1 while the worker answers heartbeats, 0 once lost",
                   ("worker_id",)).labels(worker_id).set(1)

    def mark_worker_stale(self, worker_id: str) -> None:
        """Stop exporting ``worker_id``'s series as live (WorkerLost). The
        last snapshot is kept for post-mortems but leaves the scrape."""
        if not self.enabled or not worker_id:
            return
        with self._lock:
            self._stale.add(worker_id)
        self.gauge("daft_worker_up",
                   "1 while the worker answers heartbeats, 0 once lost",
                   ("worker_id",)).labels(worker_id).set(0)

    def stale_workers(self) -> set:
        with self._lock:
            return set(self._stale)

    def clear_stale_workers(self) -> None:
        """Forget stale workers ENTIRELY — marks, stored wires, and their
        liveness series (fault_scope exit: simulated kills must not leave
        suppressed marks behind, and un-marking alone would re-export a
        dead worker's final snapshot as live while its up-gauge read 0)."""
        with self._lock:
            stale = list(self._stale)
            for wid in stale:
                self._workers.pop(wid, None)
                self._baselines.pop(wid, None)
            self._stale.clear()
            liveness = [self._instruments[n]
                        for n in ("daft_worker_up",
                                  "daft_worker_heartbeats_total")
                        if n in self._instruments]
        for inst in liveness:
            for wid in stale:
                inst.remove_matching("worker_id", wid)

    def _live_worker_wires(self) -> List[Tuple[str, dict]]:
        """Live workers' wires, baseline-adjusted (see ``reset``)."""
        with self._lock:
            # Copy each wire dict under the lock: reset(name) pops keys from
            # the stored dicts in place, and iterating the live reference
            # outside the lock would race it (RuntimeError in a scrape).
            live = [(wid, dict(wire), self._baselines.get(wid))
                    for wid, wire in self._workers.items()
                    if wid not in self._stale]
        out = []
        for wid, wire, bases in live:
            if bases:
                wire = {n: _subtract_wire_metric(m, bases.get(n))
                        for n, m in wire.items()}
            out.append((wid, wire))
        return out

    # -- snapshots / reset ------------------------------------------------
    def snapshot(self) -> MetricsSnapshot:
        """Local + live-worker series, flattened (worker series carry a
        ``worker_id`` label)."""
        raw = self._collect(include_local_only=True)
        for wid, wire in self._live_worker_wires():
            for name, m in wire.items():
                slot = raw.setdefault(
                    name, {"kind": m["kind"], "help": m.get("help", ""),
                           "series": []})
                for s in m["series"]:
                    merged = dict(s)
                    merged["labels"] = dict(s["labels"], worker_id=wid)
                    slot["series"].append(merged)
        return MetricsSnapshot(raw)

    def reset(self, name: Optional[str] = None) -> None:
        """Zero series values (all instruments, or just ``name``); a full
        reset also drops worker snapshots and staleness marks. Instrument
        objects survive — module-level handles stay valid. A per-metric
        reset strips that metric from stored worker wires too, so shim
        resets (spill/token) hold in distributed runs where merged worker
        snapshots would otherwise bleed into the next measurement."""
        with self._lock:
            targets = ([self._instruments[name]]
                       if name is not None and name in self._instruments
                       else [] if name is not None
                       else list(self._instruments.values()))
            if name is None:
                self._workers.clear()
                self._stale.clear()
                self._baselines.clear()
            else:
                # Capture each worker's current cumulative entry as the
                # subtraction baseline — future heartbeats re-deliver
                # cumulative totals, and reads must not resurrect them.
                for wid, wire in self._workers.items():
                    entry = wire.pop(name, None)
                    if entry is not None:
                        self._baselines.setdefault(wid, {})[name] = entry
        for inst in targets:
            inst.reset()

    # -- Prometheus text exposition ---------------------------------------
    def to_prometheus(self) -> str:
        """Text exposition format (version 0.0.4): HELP/TYPE per metric,
        one line per series; histograms expand to cumulative ``_bucket``
        lines plus ``_sum``/``_count``."""
        snap = self.snapshot().raw
        lines: List[str] = []
        for name in sorted(snap):
            m = snap[name]
            if m["help"]:
                lines.append(f"# HELP {name} {_esc_help(m['help'])}")
            lines.append(f"# TYPE {name} {m['kind']}")
            for s in sorted(m["series"],
                            key=lambda s: sorted(s["labels"].items())):
                base = _labelstr(s["labels"])
                if m["kind"] == "histogram":
                    cum = 0
                    for bound, n in zip(s["bounds"], s["bucket_counts"]):
                        cum += n
                        lines.append(
                            f"{name}_bucket"
                            f"{_labelstr(s['labels'], le=_fmt(bound))} {cum}")
                    lines.append(
                        f"{name}_bucket{_labelstr(s['labels'], le='+Inf')} "
                        f"{s['count']}")
                    lines.append(f"{name}_sum{base} {_fmt(s['sum'])}")
                    lines.append(f"{name}_count{base} {s['count']}")
                else:
                    lines.append(f"{name}{base} {_fmt(s['value'])}")
        return "\n".join(lines) + "\n"

    # -- OTLP/HTTP JSON ----------------------------------------------------
    def to_otlp(self, service_name: str = "daft_tpu_torch") -> dict:
        """One OTLP/HTTP JSON ``resourceMetrics`` payload
        (opentelemetry-proto metrics v1), the sibling of
        ``tracing.Span.to_otlp``'s ``resourceSpans``."""
        snap = self.snapshot().raw
        now = str(time.time_ns())
        metrics = []
        for name in sorted(snap):
            m = snap[name]
            entry: dict = {"name": name}
            if m["help"]:
                entry["description"] = m["help"]
            if m["kind"] == "histogram":
                entry["histogram"] = {
                    "dataPoints": [{
                        "attributes": _otlp_attrs(s["labels"]),
                        "count": str(s["count"]), "sum": s["sum"],
                        "explicitBounds": list(s["bounds"]),
                        "bucketCounts": [str(c) for c in s["bucket_counts"]],
                        "timeUnixNano": now,
                    } for s in m["series"]],
                    "aggregationTemporality": 2,
                }
            elif m["kind"] == "gauge":
                entry["gauge"] = {"dataPoints": [{
                    "attributes": _otlp_attrs(s["labels"]),
                    "asDouble": s["value"], "timeUnixNano": now,
                } for s in m["series"]]}
            else:
                entry["sum"] = {
                    "dataPoints": [{
                        "attributes": _otlp_attrs(s["labels"]),
                        "asDouble": s["value"], "timeUnixNano": now,
                    } for s in m["series"]],
                    "isMonotonic": True, "aggregationTemporality": 2,
                }
            metrics.append(entry)
        return {"resourceMetrics": [{
            "resource": {"attributes": [{
                "key": "service.name",
                "value": {"stringValue": service_name}}]},
            "scopeMetrics": [{"scope": {"name": "daft_tpu_torch.metrics"},
                              "metrics": metrics}],
        }]}


def _subtract_wire_metric(new: dict, base: Optional[dict]) -> dict:
    """Subtract a reset-time baseline from a worker's cumulative wire entry,
    series-by-series (matched on labels). A series whose new total dropped
    BELOW its baseline means the worker restarted — its raw value is the
    truth and the stale baseline is ignored for that series."""
    if not base:
        return new
    by_labels = {tuple(sorted(s["labels"].items())): s
                 for s in base.get("series", ())}
    series = []
    for s in new.get("series", ()):
        b = by_labels.get(tuple(sorted(s["labels"].items())))
        if b is None:
            series.append(s)
            continue
        if "bucket_counts" in s:  # histogram
            if s.get("count", 0) >= b.get("count", 0):
                s = dict(s,
                         bucket_counts=[max(n - o, 0) for n, o in
                                        zip(s["bucket_counts"],
                                            b.get("bucket_counts", []))]
                         or s["bucket_counts"],
                         sum=s.get("sum", 0.0) - b.get("sum", 0.0),
                         count=s.get("count", 0) - b.get("count", 0))
            series.append(s)
            continue
        if new.get("kind") == "gauge":
            series.append(s)  # a gauge is a level, not a cumulative total
            continue
        nv, bv = s.get("value", 0.0), b.get("value", 0.0)
        series.append(dict(s, value=nv - bv if nv >= bv else nv))
    return dict(new, series=series)


def _esc_help(s: str) -> str:
    return s.replace("\\", r"\\").replace("\n", r"\n")


def _esc_label(s: str) -> str:
    return (s.replace("\\", r"\\").replace('"', r'\"')
            .replace("\n", r"\n"))


def _labelstr(labels: Dict[str, str], **extra: str) -> str:
    items = list(labels.items()) + list(extra.items())
    if not items:
        return ""
    body = ",".join(f'{k}="{_esc_label(str(v))}"'
                    for k, v in sorted(items))
    return "{" + body + "}"


def _fmt(v) -> str:
    f = float(v)
    return str(int(f)) if f.is_integer() else repr(f)


def _otlp_attrs(labels: Dict[str, str]) -> List[dict]:
    return [{"key": k, "value": {"stringValue": str(v)}}
            for k, v in sorted(labels.items())]


# --------------------------------------------------------------------- #
# Process-wide registry + engine instrument inventory                    #
# --------------------------------------------------------------------- #
_REGISTRY: Optional[MetricRegistry] = None
_registry_lock = threading.Lock()


def get_registry() -> MetricRegistry:
    """THE process registry. Never replaced (module-level instrument
    handles must stay valid); tests toggle ``.enabled`` / call ``reset()``."""
    global _REGISTRY
    if _REGISTRY is None:
        with _registry_lock:
            if _REGISTRY is None:
                _REGISTRY = MetricRegistry()
    return _REGISTRY


def metrics_enabled() -> bool:
    return get_registry().enabled


def current_query_id() -> str:
    """The ambient query id (cancel_scope contextvar), '' outside a query
    scope — per-query attribution for paths that don't carry an id."""
    from daft_tpu_torch.cancellation import current_token

    tok = current_token()
    return getattr(tok, "query_id", "") or ""


_r = get_registry()

# Dispatcher / task lifecycle (distributed/scheduler.py)
TASKS_COMPLETED = _r.counter(
    "daft_tasks_completed_total", "Task attempts that finished",
    ("worker_id",))
TASK_DURATION = _r.histogram(
    "daft_task_duration_seconds", "Wall time per completed task attempt")
TASK_RETRIES = _r.counter(
    "daft_task_retries_total",
    "Tasks re-queued, by reason (worker-died/transient/fetch-recovery/"
    "straggler)", ("reason",))
SPECULATIONS = _r.counter(
    "daft_task_speculations_total", "Straggler duplicates launched")
DEADLINE_ABORTS = _r.counter(
    "daft_query_aborts_total",
    "Queries aborted through the drain path, by reason", ("reason",))
DISPATCH_PENDING = _r.gauge(
    "daft_dispatcher_pending_tasks", "Tasks queued, not yet submitted")
DISPATCH_INFLIGHT = _r.gauge(
    "daft_dispatcher_inflight_tasks", "Task attempts currently running")

# Query lifecycle (MetricsSubscriber)
QUERIES_STARTED = _r.counter("daft_queries_started_total", "Queries begun")
QUERIES_ENDED = _r.counter(
    "daft_queries_ended_total", "Queries finished, by status", ("status",))
PARTITIONS_RECOVERED = _r.counter(
    "daft_partitions_recovered_total",
    "Partitions recomputed from lineage after loss")
WORKERS_LOST = _r.counter(
    "daft_workers_lost_total", "Workers marked dead, by reason", ("reason",))

# Executor + memory manager (execution/)
MORSELS = _r.counter(
    "daft_executor_morsels_total", "Morsels yielded per operator",
    ("operator",))
MORSEL_ROWS = _r.counter(
    "daft_executor_rows_total", "Rows yielded per operator", ("operator",))
PERMIT_WAIT = _r.histogram(
    "daft_memory_permit_wait_seconds",
    "Time blocked waiting for memory permits")
MEMORY_POISON = _r.counter(
    "daft_memory_poison_total", "Memory-manager poison events (query aborts)")

# Memory observatory (execution/memledger.py): the per-query byte ledger,
# its reservation reconciliation, and the RSS correlation sampler.
MEM_RESERVATION_OVER = _r.counter(
    "daft_memory_reservation_over_bytes",
    "Bytes by which queries' peak held memory EXCEEDED their admission "
    "reservation (summed per finished query)")
MEM_RESERVATION_UNDER = _r.counter(
    "daft_memory_reservation_under_bytes",
    "Bytes by which queries' admission reservation exceeded their actual "
    "peak held memory (reservation headroom, summed per finished query)")
MEM_LEDGER_HELD = _r.gauge(
    "daft_memory_ledger_held_bytes",
    "Bytes the memory ledger currently attributes to in-flight queries "
    "(all kinds; 0 on an idle engine — the zero-leak audit surface)")
MEM_LEDGER_RESIDUAL = _r.counter(
    "daft_memory_ledger_residual_bytes_total",
    "Bytes force-drained at query finish because a charge site failed to "
    "release them (should stay 0; the reconciliation audit asserts it)")
MEM_RSS = _r.gauge(
    "daft_memory_rss_bytes",
    "Process resident-set size sampled by the memory observatory")
MEM_UNACCOUNTED = _r.gauge(
    "daft_memory_unaccounted_bytes",
    "Sampled RSS minus ledger-held bytes: interpreter + caches + "
    "systematic ledger under-accounting (watch the trend, not the level)")
PIPELINE_STALL = _r.counter(
    "daft_pipeline_stall_seconds_total",
    "Seconds stage feeders spent blocked on a full bounded queue "
    "(backpressure engaged), per operator", ("operator",))

# Shuffle plane (distributed/shuffle.py): chunked compressed transfers
SHUFFLE_BYTES_WRITTEN = _r.counter(
    "daft_shuffle_bytes_written_total",
    "Uncompressed bytes written into shuffle chunk files (map side)")
SHUFFLE_BYTES_FETCHED = _r.counter(
    "daft_shuffle_bytes_fetched_total",
    "Uncompressed bytes fetched by shuffle readers (reduce side)")
SHUFFLE_BYTES_SPILLED = _r.counter(
    "daft_shuffle_bytes_spilled_total",
    "Fetched shuffle bytes spilled to disk under memory-permit pressure")
SHUFFLE_CHUNKS = _r.counter(
    "daft_shuffle_chunks_total", "Shuffle chunk files written, by codec",
    ("codec",))
SHUFFLE_FETCH_SECONDS = _r.histogram(
    "daft_shuffle_fetch_seconds", "Wall time per shuffle chunk fetch")
SHUFFLE_LOCAL_HITS = _r.counter(
    "daft_shuffle_local_hits_total",
    "Shuffle reads served by the intra-host short-circuit (no wire)")

# Spill (execution/spill.py shims onto these)
SPILL_BYTES = _r.counter("daft_spill_bytes_total", "Bytes spilled to disk")
SPILL_FILES = _r.counter("daft_spill_files_total", "Spill files written")
SPILL_EVENTS = _r.counter(
    "daft_spill_events_total", "Sink-level spill events (runs/buckets)")

# Device eval (ops/device_eval.py shims onto these)
DEVICE_FUSED_EXPRS = _r.counter(
    "daft_device_fused_exprs_total", "Expressions fused onto the device path")
DEVICE_FUSED_ROWS = _r.counter(
    "daft_device_fused_rows_total", "Expression-rows evaluated on device")
DEVICE_FALLBACKS = _r.counter(
    "daft_device_fallback_exprs_total",
    "Expressions that fell back to host eval, by reason", ("reason",))
DEVICE_ERRORS = _r.counter(
    "daft_device_errors_total", "Device-path evaluation errors")

# Compiled chain evaluation (ops/compiled_eval.py): whole filter→project→agg
# chains traced into single jitted XLA programs, cache-keyed on schema +
# canonicalized plan fingerprint.
COMPILE_CACHE_HITS = _r.counter(
    "daft_compile_cache_hits_total",
    "Compiled-chain program cache hits (fingerprint + bucket shape)")
COMPILE_CACHE_MISSES = _r.counter(
    "daft_compile_cache_misses_total",
    "Compiled-chain program cache misses (fresh XLA trace + compile)")
COMPILE_SECONDS = _r.histogram(
    "daft_compile_seconds",
    "XLA trace+compile wall seconds per fresh chain program",
    buckets=exponential_buckets(0.001, 4.0, 10))
COMPILED_EVAL_ENABLED = _r.gauge(
    "daft_compiled_eval_enabled",
    "1 while the compiled chain path is live; 0 when disabled by config "
    "or by the fused-vs-interpreted self-disable guard")
COMPILED_CHAIN_MORSELS = _r.counter(
    "daft_compiled_chain_morsels_total",
    "Morsels evaluated through a compiled chain program, by chain kind",
    ("kind",))
COMPILED_CHAIN_ROWS = _r.counter(
    "daft_compiled_chain_rows_total",
    "Rows evaluated through a compiled chain program, by chain kind",
    ("kind",))
STAGE_FUSIONS = _r.counter(
    "daft_stage_fusions_total",
    "Adjacent Project/Filter stages collapsed into one morsel stage "
    "(counted once per fused chain per query plan walk)")

# IO (io/iostats.py + native clients + retry)
IO_REQUESTS = _r.counter(
    "daft_io_requests_total", "Object-store/HTTP requests",
    ("endpoint", "verb"))
IO_BYTES = _r.counter(
    "daft_io_bytes_total", "Payload bytes moved", ("endpoint", "direction"))
IO_SECONDS = _r.histogram(
    "daft_io_request_seconds", "Request latency per endpoint", ("endpoint",))
IO_RETRIES = _r.counter(
    "daft_io_retries_total", "IO attempts retried", ("endpoint",))
RETRY_SLEEP = _r.histogram(
    "daft_io_retry_sleep_seconds", "Backoff sleeps before IO retries",
    ("endpoint",))
# Per-query series are evicted at QueryEnd AND capped (oldest-out) so an
# abandoned query id — a worker that never sees QueryEnd, a crashed driver —
# can't grow the registry, the heartbeat wire, or the scrape without bound.
_MAX_QUERY_SERIES = 128
QUERY_IO_REQUESTS = _r.counter(
    "daft_query_io_requests_total",
    "IO requests attributed to the ambient query", ("query_id",),
    max_series=_MAX_QUERY_SERIES, ship_on_wire=False)
QUERY_IO_BYTES = _r.counter(
    "daft_query_io_bytes_total",
    "IO bytes attributed to the ambient query", ("query_id",),
    max_series=_MAX_QUERY_SERIES, ship_on_wire=False)

# Circuit breakers (io/circuit.py)
CIRCUIT_STATE = _r.gauge(
    "daft_circuit_state",
    "Breaker state per endpoint: 0=closed, 1=half_open, 2=open",
    ("endpoint",))
CIRCUIT_TRANSITIONS = _r.counter(
    "daft_circuit_transitions_total", "Breaker state transitions",
    ("endpoint", "to"))

# Worker liveness (distributed/worker.py)
WORKER_UP = _r.gauge(
    "daft_worker_up", "1 while the worker answers heartbeats, 0 once lost",
    ("worker_id",))
HEARTBEATS = _r.counter(
    "daft_worker_heartbeats_total", "Successful liveness probes",
    ("worker_id",))

# Elastic fleet (distributed/fleet.py)
FLEET_WORKERS = _r.gauge(
    "daft_fleet_workers",
    "Workers per membership state (active/draining/drained/released/dead)",
    ("state",))
FLEET_SCALE_EVENTS = _r.counter(
    "daft_fleet_scale_events_total",
    "Fleet membership changes, by direction (up/down) and triggering "
    "reason (queue-pressure/slo-burn/shed-level/memory-pressure/inflight/"
    "idle/launch-failed/drain-failed/drain-interrupted/manual)",
    ("direction", "reason"))
FLEET_DRAIN_SECONDS = _r.histogram(
    "daft_fleet_drain_seconds",
    "Graceful-drain duration from WorkerDrainStarted to release")

# Admission control (execution/admission.py)
ADMISSION_QUEUE_DEPTH = _r.gauge(
    "daft_admission_queue_depth",
    "Queries waiting in the tenant's bounded admission queue", ("tenant",))
ADMISSION_ACTIVE = _r.gauge(
    "daft_admission_active_queries",
    "Admitted queries currently holding a tenant slot", ("tenant",))
ADMISSION_ADMITTED = _r.counter(
    "daft_admission_admitted_total", "Queries admitted per tenant",
    ("tenant",))
ADMISSION_REJECTED = _r.counter(
    "daft_admission_rejected_total",
    "Queries rejected at the front door, by tenant and reason "
    "(queue-full/deadline-too-short/shed-low-priority/shed-over-quota/"
    "overload)", ("tenant", "reason"))
ADMISSION_WAIT = _r.histogram(
    "daft_admission_wait_seconds",
    "Time from admit() call to admission (0 on the uncontended fast path)")
ADMISSION_SHED_LEVEL = _r.gauge(
    "daft_admission_shed_level",
    "Overload ladder level: 0 normal, 1 shed low-priority/over-quota, "
    "2 + halved stage parallelism, 3 + reject default-priority tenants")

# Query flight recorder (the JAX package's querylog.py, ROADMAP A.8)
QUERYLOG_RECORDS = _r.counter(
    "daft_querylog_records_total",
    "Flight-recorder records written, by outcome "
    "(success/timeout/cancelled/shed/failed)", ("outcome",))
QUERYLOG_DROPPED = _r.counter(
    "daft_querylog_dropped_total",
    "Flight records lost to recorder/sink failures (should stay 0)")

# Feedback-driven planning (the JAX package's feedback.py, ROADMAP A.8): the estimate-vs-actual
# plane and the corrections it drives.
PLANNER_QERROR = _r.histogram(
    "daft_planner_qerror",
    "Per-plan-node q-error max(est/actual, actual/est) from completed "
    "flight records (1 = perfect estimate; log-scale buckets)",
    buckets=exponential_buckets(1.0, 2.0, 12))
PLAN_CORRECTED = _r.counter(
    "daft_plan_corrected_total",
    "Feedback-driven plan corrections, by kind (replan/agg-partition/"
    "join-spill/shuffle-buckets)", ("kind",))
FEEDBACK_FINGERPRINTS = _r.gauge(
    "daft_feedback_fingerprints",
    "Query fingerprints currently held by the planner statistics store")
FEEDBACK_CORRECTED_PLANS = _r.counter(
    "daft_feedback_corrected_plans_total",
    "Queries planned under observed (feedback-corrected) statistics")

# SLO plane (the JAX package's slo.py, ROADMAP A.8). Tenant labels are caller-supplied, so every
# tenant-labeled series is cardinality-capped (oldest-out) — the admission
# plane's discipline.
_MAX_TENANT_SERIES = 256
SLO_BURN_RATE = _r.gauge(
    "daft_slo_burn_rate",
    "Error-budget burn rate per tenant and window (1.0 = burning exactly "
    "at budget)", ("tenant", "window"),
    # Two series per tenant (fast + slow): the cap doubles so this gauge
    # holds exactly as many tenants as the one-series-per-tenant ones.
    max_series=2 * _MAX_TENANT_SERIES)
SLO_LATENCY_P99 = _r.gauge(
    "daft_slo_latency_p99_seconds",
    "Rolling p99 completion latency per tenant (slow SLO window)",
    ("tenant",), max_series=_MAX_TENANT_SERIES)
SLO_ERROR_RATE = _r.gauge(
    "daft_slo_error_rate",
    "Rolling bad-query fraction per tenant (slow SLO window)",
    ("tenant",), max_series=_MAX_TENANT_SERIES)
SLO_ALERTS = _r.counter(
    "daft_slo_alerts_total", "Burn-rate alert episodes per tenant",
    ("tenant",), max_series=_MAX_TENANT_SERIES)
AUTOPROFILE_CAPTURES = _r.counter(
    "daft_slo_autoprofile_captures_total",
    "Queries auto-profiled by the tail sampler (armed plan fingerprints)")

# Query-as-a-service caching (plancache.py)
PLAN_CACHE_HITS = _r.counter(
    "daft_plan_cache_hits_total",
    "Queries whose optimize+translate was served from the plan cache")
PLAN_CACHE_MISSES = _r.counter(
    "daft_plan_cache_misses_total",
    "Queries that paid a full optimize+translate pass")
PLAN_CACHE_SIZE = _r.gauge(
    "daft_plan_cache_entries", "Plans currently cached")
RESULT_CACHE_HITS = _r.counter(
    "daft_result_cache_hits_total",
    "Result/scan-cache hits, by tier (result = whole query, scan = "
    "scan-node output)", ("kind",))
RESULT_CACHE_MISSES = _r.counter(
    "daft_result_cache_misses_total", "Result/scan-cache misses, by tier",
    ("kind",))
RESULT_CACHE_HIT_BYTES = _r.counter(
    "daft_result_cache_hit_bytes_total",
    "Bytes served from the result/scan cache instead of re-executed")
RESULT_CACHE_BYTES = _r.gauge(
    "daft_result_cache_bytes", "Bytes currently resident in the "
    "result/scan cache (memoized size_bytes accounting)")
RESULT_CACHE_ENTRIES = _r.gauge(
    "daft_result_cache_entries", "Entries currently in the result/scan cache")
RESULT_CACHE_EVICTIONS = _r.counter(
    "daft_result_cache_evictions_total",
    "Cache entries dropped, by tier and reason (capacity / invalidated / "
    "stale-source / tenant-quota)", ("kind", "reason"))
RESULT_CACHE_INVALIDATIONS = _r.counter(
    "daft_result_cache_invalidations_total",
    "Entries dropped by write-invalidation (io/writers, io/sink, catalog)")
RESULT_CACHE_TENANT_BYTES = _r.gauge(
    "daft_result_cache_tenant_bytes",
    "Result/scan-cache bytes resident per tenant (the admission quota "
    "charge, mirrored into the memory observatory)", ("tenant",),
    max_series=_MAX_TENANT_SERIES)

# Streaming ingestion & materialized views (the JAX package's streaming/,
# ROADMAP A.8). View
# names are operator-supplied registry keys — cardinality-capped like
# tenants.
_MAX_VIEW_SERIES = 256
VIEW_REFRESHES = _r.counter(
    "daft_view_refreshes_total",
    "Materialized-view refreshes, by view and mode (incremental = delta "
    "absorbed via partial merge, full = rebase recompute)",
    ("view", "mode"), max_series=2 * _MAX_VIEW_SERIES)
VIEW_REFRESH_SECONDS = _r.counter(
    "daft_view_refresh_seconds_total",
    "Wall seconds spent refreshing each view (cost-of-upkeep currency: "
    "compare against full-recompute estimates)", ("view",),
    max_series=_MAX_VIEW_SERIES)
VIEW_DELTA_FILES = _r.counter(
    "daft_view_delta_files_total",
    "Source files absorbed as deltas per view", ("view",),
    max_series=_MAX_VIEW_SERIES)
VIEW_DELTA_ROWS = _r.counter(
    "daft_view_delta_rows_total",
    "Rows absorbed as deltas per view", ("view",),
    max_series=_MAX_VIEW_SERIES)
VIEW_SERVES = _r.counter(
    "daft_view_serves_total",
    "Queries served from a view cache entry (with freshness metadata) "
    "instead of executing", ("view",), max_series=_MAX_VIEW_SERIES)
VIEW_STALENESS = _r.gauge(
    "daft_view_staleness_seconds",
    "Seconds since each view's last refresh absorbed its watermark",
    ("view",), max_series=_MAX_VIEW_SERIES)
VIEW_BACKLOG = _r.gauge(
    "daft_view_backlog_files",
    "Discovered-but-unabsorbed source files per view (delta backlog)",
    ("view",), max_series=_MAX_VIEW_SERIES)
VIEW_STATE_BYTES = _r.gauge(
    "daft_view_state_bytes",
    "Bytes held by each view's incremental aggregate state", ("view",),
    max_series=_MAX_VIEW_SERIES)
STREAM_BATCHES = _r.counter(
    "daft_stream_batches_total",
    "Micro-batches emitted by tailing sources, by source kind "
    "(listing / append-log)", ("kind",))
FRESHNESS_BURN_RATE = _r.gauge(
    "daft_freshness_burn_rate",
    "Staleness-budget burn rate per view and window (1.0 = burning "
    "exactly at budget)", ("view", "window"),
    max_series=2 * _MAX_VIEW_SERIES)
FRESHNESS_ALERTS = _r.counter(
    "daft_freshness_alerts_total",
    "Freshness burn-rate alert episodes per view", ("view",),
    max_series=_MAX_VIEW_SERIES)

# Data-integrity plane (integrity.py): digests verified at every
# artifact read, failures quarantined and healed through lineage.
INTEGRITY_VERIFIED = _r.counter(
    "daft_integrity_verified_total",
    "Artifact integrity verifications that passed, by artifact kind "
    "(chunk / spill / checkpoint)", ("artifact",))
INTEGRITY_FAILED = _r.counter(
    "daft_integrity_failed_total",
    "Artifact integrity verifications that FAILED (digest mismatch — "
    "corruption caught before decode), by artifact kind", ("artifact",))
INTEGRITY_QUARANTINED = _r.counter(
    "daft_integrity_quarantined_total",
    "Corrupt artifact files renamed to *.quarantined pending sweep at "
    "query release, by artifact kind", ("artifact",))
STREAM_CORRUPT_LINES = _r.counter(
    "daft_streaming_corrupt_lines_total",
    "Corrupt (undecodable) JSONL lines skipped by tailing sources, by "
    "source kind", ("source",))

# AI providers (ai/metrics.py shims onto these)
AI_TOKENS = _r.counter(
    "daft_ai_tokens_total", "Provider tokens consumed",
    ("provider_model", "kind"))
AI_REQUESTS = _r.counter(
    "daft_ai_requests_total", "Provider API requests", ("provider_model",))

del _r

_CIRCUIT_STATE_CODE = {"closed": 0, "half_open": 1, "open": 2}


def record_io(endpoint: str, verb: str, nbytes: int = 0,
              seconds: float = 0.0, direction: str = "read") -> None:
    """One IO request's worth of per-endpoint counters + the per-query
    attribution series (ambient cancel_scope query id, when present)."""
    if not get_registry().enabled:
        return
    IO_REQUESTS.labels(endpoint, verb).inc()
    if nbytes:
        IO_BYTES.labels(endpoint, direction).inc(nbytes)
    if seconds > 0:
        # Untimed legacy call sites pass seconds=0; fabricated 0s samples
        # would collapse the latency histogram's quantiles toward zero.
        IO_SECONDS.labels(endpoint).observe(seconds)
    qid = current_query_id()
    if qid:
        QUERY_IO_REQUESTS.labels(qid).inc()
        if nbytes:
            QUERY_IO_BYTES.labels(qid).inc(nbytes)


def record_circuit_state(endpoint: str, state: str) -> None:
    """Breaker transition: labeled gauge (current state) + transition
    counter — scrape-friendly view of io/circuit.py's state machines."""
    if not get_registry().enabled:
        return
    CIRCUIT_STATE.labels(endpoint).set(_CIRCUIT_STATE_CODE.get(state, -1))
    CIRCUIT_TRANSITIONS.labels(endpoint, state).inc()


# --------------------------------------------------------------------- #
# Exporters + event subscriber                                            #
# --------------------------------------------------------------------- #
class OTLPJsonMetricsFileExporter:
    """One OTLP/HTTP JSON ``resourceMetrics`` payload per line — the metrics
    twin of ``tracing.OTLPJsonFileExporter`` (same file discipline: an
    external collector tails and ships; zero-egress environments keep it)."""

    def __init__(self, path: str, service_name: str = "daft_tpu_torch"):
        self.path = path
        self.service_name = service_name
        self._lock = threading.Lock()

    def export(self, registry: Optional[MetricRegistry] = None) -> None:
        payload = (registry or get_registry()).to_otlp(self.service_name)
        line = json.dumps(payload) + "\n"
        with self._lock:
            with open(self.path, "a") as f:
                f.write(line)


class MetricsSubscriber:
    """Event→registry bridge for lifecycle events nobody increments inline
    (queries, cancels, worker loss, lineage recoveries). Hot-path counters
    (task retries, IO, morsels) are incremented at the source instead — an
    event round-trip per morsel would cost more than the work it measures.
    Optionally exports an OTLP line at every QueryEnd."""

    def __init__(self, exporter: Optional[OTLPJsonMetricsFileExporter] = None):
        self.exporter = exporter

    def on_event(self, e) -> None:
        from daft_tpu_torch.subscribers.events import (
            PartitionRecovered,
            QueryCancelled,
            QueryEnd,
            QueryStart,
            WorkerLost,
        )

        if not get_registry().enabled:
            return
        if isinstance(e, QueryStart):
            QUERIES_STARTED.inc()
        elif isinstance(e, QueryEnd):
            QUERIES_ENDED.labels("error" if e.error else "ok").inc()
            if self.exporter is not None:
                self.exporter.export()
            # Per-query attribution series die with the query (cardinality:
            # a serving process sees millions of query ids).
            QUERY_IO_REQUESTS.remove_matching("query_id", e.query_id)
            QUERY_IO_BYTES.remove_matching("query_id", e.query_id)
        elif isinstance(e, QueryCancelled):
            DEADLINE_ABORTS.labels(e.reason or "cancelled").inc()
        elif isinstance(e, WorkerLost):
            WORKERS_LOST.labels(e.reason or "unknown").inc()
            get_registry().mark_worker_stale(e.worker_id)
        elif isinstance(e, PartitionRecovered):
            PARTITIONS_RECOVERED.inc(e.num_partitions or 1)


_auto_subscriber: Optional[MetricsSubscriber] = None
_auto_lock = threading.Lock()


def maybe_enable_metrics(context) -> None:
    """Attach the lifecycle subscriber once per context (called from
    ``context.notify``). Honors the
    config mirror of the plane's knobs — ``metrics_enabled=False`` on the
    execution config disables the registry process-wide at first notify
    (it is one plane per process, not per query), and
    ``metrics_export_path`` is the config-level spelling of
    ``DAFT_METRICS_FILE`` for the OTLP file exporter."""
    global _auto_subscriber
    reg = get_registry()
    cfg = getattr(context, "execution_config", None)
    if cfg is not None and not getattr(cfg, "metrics_enabled", True):
        reg.enabled = False
    if _auto_subscriber is not None or not reg.enabled:
        return
    with _auto_lock:
        if _auto_subscriber is not None:  # double-checked: notify() races
            return
        from daft_tpu_torch.config import daft_env

        path = daft_env("DAFT_METRICS_FILE") or (
            getattr(cfg, "metrics_export_path", None) if cfg is not None else None)
        sub = MetricsSubscriber(
            OTLPJsonMetricsFileExporter(path) if path else None)
        context.attach_subscriber(sub)
        _auto_subscriber = sub
