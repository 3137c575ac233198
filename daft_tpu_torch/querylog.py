"""The query flight recorder: one structured record for every query (port
of ``daft_tpu/querylog.py``).

Each query on the native runner, on every outcome (success, timeout,
cancelled, shed, failed), lands exactly one record: its identity (query
id, tenant, runner, wall-clock start), the **plan fingerprint** (the
engine's one fingerprint, ``plancache.fingerprint``, of the optimized
plan's text), the admission facts (queue wait, shed level), the rows and
bytes out, the compile-cache, fusion and shuffle counters' deltas over its
bracket, the cache hits, the memory ledger's ``mem`` block, the outcome and
error kind, and with a profile a top-N operator digest.

Records live in a bounded ring (``daft_tpu_torch.recent_queries()``) and,
with ``DAFT_QUERY_LOG`` / ``query_log_path``, append as schema-versioned
JSONL on the shared rotating sink (``utils/jsonl_sink.py``,
``DAFT_QUERY_LOG_MAX_BYTES``); :func:`load_query_log` skips torn lines.
Every record feeds the SLO plane (``slo.py``), whose tail sampler arms a
slow query's fingerprint; :func:`maybe_autoprofile` then profiles the next
runs of that shape.

The cost is per query, never per morsel, except :meth:`FlightEntry.count`
(two adds per yielded partition). A recording failure never fails the
query: the recorder logs and drops the record.

Left out, each raising ``DaftNotImplementedError`` naming its item: the
views' block and ``view_scope`` and the feedback fields (``note_query_fp``,
``note_feedback``, ``note_estimates``), ROADMAP A.8.6; the fleet's event
ring, A.8.5. The ``view`` block of every record is ``{}``.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import logging
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from daft_tpu_torch.errors import DaftNotImplementedError
from daft_tpu_torch.utils.jsonl_sink import RotatingJsonlSink

log = logging.getLogger("daft_tpu_torch.querylog")

#: The JAX package's schema: v2 added ``plan_cache_hit`` /
#: ``result_cache_hit`` (the query caches); v3 the memory ledger's ``mem``
#: block (reserved vs peak-held vs spilled bytes, stall time); v4 the
#: streaming views' ``view`` block ({} for a plain query); v5 the optional
#: ``integrity`` block, stamped only when the integrity plane verified,
#: failed or quarantined anything over the query's bracket. The reader
#: accepts v1 through v6, so a log written across the versions loads whole.
QUERYLOG_SCHEMA_VERSION = 6

#: Outcome taxonomy — every query lands in exactly one bucket.
OUTCOME_SUCCESS = "success"
OUTCOME_TIMEOUT = "timeout"
OUTCOME_CANCELLED = "cancelled"
OUTCOME_SHED = "shed"
OUTCOME_FAILED = "failed"
OUTCOMES = (OUTCOME_SUCCESS, OUTCOME_TIMEOUT, OUTCOME_CANCELLED,
            OUTCOME_SHED, OUTCOME_FAILED)

#: The reader/writer contract (tests pin these sets; extending the record
#: means bumping QUERYLOG_SCHEMA_VERSION or adding OPTIONAL keys, never
#: repurposing these). v1 is the pre-cache set; v2 additionally requires
#: the cache-hit facts; v3 additionally requires the ``mem`` block ({} when
#: the memory ledger is disabled); v4 additionally requires the ``view``
#: block ({} for queries that neither refreshed nor served from a view).
RECORD_REQUIRED_V1 = ("schema_version", "query_id", "tenant", "runner", "ts",
                      "outcome", "duration_s", "plan_fingerprint",
                      "admission_wait_s", "shed_level", "rows_out",
                      "bytes_out")
RECORD_REQUIRED_V2 = RECORD_REQUIRED_V1 + ("plan_cache_hit",
                                           "result_cache_hit")
RECORD_REQUIRED_V3 = RECORD_REQUIRED_V2 + ("mem",)
RECORD_REQUIRED_V4 = RECORD_REQUIRED_V3 + ("view",)
#: v5 adds NO required keys: the ``integrity`` block is optional by design
#: (only stamped when the integrity plane verified/failed/quarantined
#: anything during the query), so the required pin is v4's.
RECORD_REQUIRED_V5 = RECORD_REQUIRED_V4
#: v6 likewise adds only OPTIONAL keys: the feedback store's ``estimates``
#: block and ``query_fingerprint`` (ROADMAP A.8.6; the port stamps
#: neither).
RECORD_REQUIRED_V6 = RECORD_REQUIRED_V5
RECORD_REQUIRED = RECORD_REQUIRED_V6

#: Ring capacity default; DAFT_QUERY_LOG_RING overrides at first use.
DEFAULT_RING_SIZE = 512

#: JSONL sink rotation default (64 MiB): at rotation the live file renames
#: to ``<path>.1`` (replacing the previous rotation) and a fresh file
#: starts — an always-on serving process bounds its own disk, the
#: operator's collector tails both.
DEFAULT_MAX_BYTES = 64 * 1024 * 1024

#: Operator-digest size: top self-wall plan nodes kept on the record.
DIGEST_OPERATORS = 5


def plan_fingerprint(plan_repr: str) -> str:
    """16-hex-char fingerprint of an optimized plan's canonical repr.

    Identical query shapes (the serving regime where the same few hundred
    queries arrive again and again) produce identical reprs and
    so identical fingerprints — which is what lets the SLO plane say "auto-
    profile the next N queries LIKE the slow one". The hash itself is THE
    shared engine fingerprint helper (plancache.fingerprint) — the plan
    cache and this recorder key through
    one scheme so they can never drift apart."""
    from daft_tpu_torch.plancache import fingerprint

    return fingerprint(plan_repr)


def classify_outcome(error: Optional[BaseException]) -> tuple:
    """(outcome, error_kind) for a query's terminal exception (None for a
    clean finish). Classification is by the engine's own error taxonomy so
    the log and the errors clients see can't disagree; ``GeneratorExit``
    is a normal early close (limit pushdown / partial iteration), not a
    failure."""
    if error is None or isinstance(error, GeneratorExit):
        return OUTCOME_SUCCESS, ""
    from daft_tpu_torch.errors import (
        DaftAdmissionError,
        DaftCancelledError,
        DaftTimeoutError,
    )

    kind = type(error).__name__
    if isinstance(error, DaftAdmissionError):
        return OUTCOME_SHED, kind
    if isinstance(error, DaftTimeoutError):
        return OUTCOME_TIMEOUT, kind
    if isinstance(error, DaftCancelledError):
        return OUTCOME_CANCELLED, kind
    return OUTCOME_FAILED, kind


def _counter_values() -> Dict[str, float]:
    """Point-in-time reads of the compile/fusion counters a record deltas
    over its bracket. Process-level totals: under concurrent queries the
    attribution is approximate (documented on the record as such) — exact
    per-query attribution would need per-query series on every hot-path
    increment, which is the cost this plane exists to avoid."""
    from daft_tpu_torch import metrics

    return {
        "compile_cache_hits": metrics.COMPILE_CACHE_HITS._default_child().value(),
        "compile_cache_misses": metrics.COMPILE_CACHE_MISSES._default_child().value(),
        "stage_fusions": metrics.STAGE_FUSIONS._default_child().value(),
        "shuffle_bytes_written": metrics.SHUFFLE_BYTES_WRITTEN._default_child().value(),
        "shuffle_bytes_fetched": metrics.SHUFFLE_BYTES_FETCHED._default_child().value(),
        # Integrity plane (labelled by artifact): summed across children so
        # the record's delta is "any artifact kind", matching the optional
        # v5 block's coarse shape.
        "integrity_verified": sum(
            c.value() for _, c in metrics.INTEGRITY_VERIFIED.series()),
        "integrity_failed": sum(
            c.value() for _, c in metrics.INTEGRITY_FAILED.series()),
        "integrity_quarantined": sum(
            c.value() for _, c in metrics.INTEGRITY_QUARANTINED.series()),
    }


class FlightEntry:
    """Per-query accumulator between the front door and the runner's
    ``finally`` — becomes exactly one record at :meth:`finish` (idempotent:
    the pre-plan failure path and the execution ``finally`` may both call
    it; the first wins)."""

    __slots__ = ("query_id", "tenant", "runner", "cfg", "ts", "_t0",
                 "plan_fingerprint", "admission_wait_s", "shed_level",
                 "shed_reason", "rows_out", "bytes_out", "profiled",
                 "autoprofiled", "plan_cache_hit", "result_cache_hit",
                 "mem", "_m0", "_recorder", "_done")

    def __init__(self, query_id: str, tenant: str, runner: str, cfg,
                 recorder: "FlightRecorder"):
        self.query_id = query_id
        self.tenant = tenant
        self.runner = runner
        self.cfg = cfg
        self.ts = time.time()
        self._t0 = time.monotonic()
        self.plan_fingerprint = ""
        self.admission_wait_s = 0.0
        self.shed_level = 0
        self.shed_reason = ""
        self.rows_out = 0
        self.bytes_out = 0
        self.profiled = False
        self.autoprofiled = False
        self.plan_cache_hit = False
        self.result_cache_hit = False
        self.mem: Dict[str, Any] = {}
        self._m0 = _counter_values()
        self._recorder = recorder
        self._done = False

    def note_admission(self, wait_s: float, shed_level: int) -> None:
        self.admission_wait_s = float(wait_s)
        self.shed_level = int(shed_level)

    def observe_plan(self, plan_repr: str) -> None:
        self.plan_fingerprint = plan_fingerprint(plan_repr)

    def note_caches(self, plan_hit: "bool | None" = None,
                    result_hit: "bool | None" = None) -> None:
        """Cache-hit facts for this query (plancache.py): did the plan
        cache skip optimize+translate, did the result cache skip execution
        entirely. Schema-v2 record fields."""
        if plan_hit is not None:
            self.plan_cache_hit = bool(plan_hit)
        if result_hit is not None:
            self.result_cache_hit = bool(result_hit)

    def note_memory(self, mem: "dict | None") -> None:
        """The memory observatory's reconciled profile for this query
        (execution/memledger.py finish_query): reserved vs peak-held vs
        spilled bytes, per-operator peaks, stall time — the schema-v3
        ``mem`` block. {} when the ledger plane is disabled."""
        if mem:
            self.mem = mem

    def note_view(self, view: "dict | None") -> None:
        """The streaming views' block (schema v4's ``view``): which view a
        refresh maintained, or the freshness a view hit served. The views
        are ROADMAP A.8.6; until then every record's ``view`` is ``{}``."""
        raise DaftNotImplementedError(
            "FlightEntry.note_view: the streaming views are not ported yet, ROADMAP A.8.6")

    def note_query_fp(self, fp: "str | None") -> None:
        """The pre-optimize query fingerprint the feedback store learns
        under (schema v6's optional ``query_fingerprint``): ROADMAP A.8.6."""
        raise DaftNotImplementedError(
            "FlightEntry.note_query_fp: the feedback store is not ported yet, ROADMAP A.8.6")

    def note_feedback(self, corrected: bool, epoch: int) -> None:
        """Whether the query ran a feedback-corrected plan: ROADMAP A.8.6."""
        raise DaftNotImplementedError(
            "FlightEntry.note_feedback: the feedback store is not ported yet, ROADMAP A.8.6")

    def note_estimates(self, nodes: "list | None", complete: bool = True) -> None:
        """The executor's estimate-vs-actual report (schema v6's optional
        ``estimates`` block): ROADMAP A.8.6."""
        raise DaftNotImplementedError(
            "FlightEntry.note_estimates: the feedback store is not ported yet, ROADMAP A.8.6")

    def count(self, mp) -> None:
        """Per-yielded-partition output accounting (``size_bytes`` is
        memoized on the immutable batches, so this is an add, not a buffer
        walk)."""
        self.rows_out += len(mp)
        self.bytes_out += mp.size_bytes()

    def finish(self, error: Optional[BaseException] = None,
               profile=None) -> Optional[dict]:
        """Close the entry into one record and hand it to the recorder.
        Never raises — a recorder bug must not fail (or double-fail) the
        query it records."""
        if self._done:
            return None
        self._done = True
        try:
            return self._recorder._record_entry(self, error, profile)
        except Exception:
            # Classified at the boundary: anything below is a recorder
            # defect, logged loudly and dropped (the query's own outcome
            # already propagated to the caller).
            log.warning("flight recorder failed to record query %s",
                        self.query_id, exc_info=True)
            from daft_tpu_torch import metrics

            metrics.QUERYLOG_DROPPED.inc()
            return None


def _operator_digest(profile) -> List[dict]:
    """Compact top-N self-wall digest from a finished QueryProfile — enough
    to name the bottleneck operator from the log line alone."""
    if profile is None:
        return []
    table = profile.operator_table(by="plan_node")
    return [{"op": r.get("plan_node", r["operator"]),
             "self_ms": round(r["self_wall_ns"] / 1e6, 3),
             "rows": r["rows"]}
            for r in table[:DIGEST_OPERATORS]]


class _QueryLogSink(RotatingJsonlSink):
    """Schema-versioned JSONL sink: one sorted-key line per record on the
    shared rotating appender (utils/jsonl_sink.py — the event log uses the
    same discipline, so rotation fixes land once)."""

    def write(self, record: dict) -> None:
        self.write_line(
            json.dumps(record, separators=(",", ":"), sort_keys=True))


class FlightRecorder:
    """THE process flight recorder: bounded ring + optional JSONL sink +
    SLO-plane feed. One per process, like the metrics registry it reads."""

    def __init__(self, ring_size: Optional[int] = None):
        if ring_size is None:
            from daft_tpu_torch.config import daft_env

            try:
                ring_size = int(daft_env("DAFT_QUERY_LOG_RING",
                                         str(DEFAULT_RING_SIZE)))
            except (TypeError, ValueError):
                ring_size = DEFAULT_RING_SIZE
        self.ring_size = max(ring_size, 16)
        self._ring: deque = deque(maxlen=self.ring_size)
        self._lock = threading.Lock()
        self._totals: Dict[str, int] = {o: 0 for o in OUTCOMES}
        self._sink: Optional[_QueryLogSink] = None
        self._sink_path: Optional[str] = None

    # -- lifecycle --------------------------------------------------------
    def begin(self, query_id: str, cfg, runner: str = "native"
              ) -> Optional[FlightEntry]:
        """Open a per-query entry, or None when recording is disabled. An
        explicitly-set ``DAFT_QUERY_RECORDER`` wins both directions over
        the config knob (the profiler's live-switch discipline — it is also
        what lets the overhead guard A/B inside one process)."""
        from daft_tpu_torch.config import daft_env, daft_env_flag
        from daft_tpu_torch.execution.admission import current_tenant

        if daft_env("DAFT_QUERY_RECORDER") is not None:
            enabled = daft_env_flag("DAFT_QUERY_RECORDER", True)
        else:
            enabled = bool(getattr(cfg, "query_recorder_enabled", True))
        if not enabled:
            return None
        return FlightEntry(query_id, current_tenant(), runner, cfg, self)

    def _record_entry(self, entry: FlightEntry,
                      error: Optional[BaseException], profile) -> dict:
        outcome, error_kind = classify_outcome(error)
        m1 = _counter_values()
        record = {
            "schema_version": QUERYLOG_SCHEMA_VERSION,
            "query_id": entry.query_id,
            "tenant": entry.tenant,
            "runner": entry.runner,
            "ts": round(entry.ts, 6),
            "outcome": outcome,
            "error_kind": error_kind,
            "error": str(error)[:200] if error is not None else "",
            "duration_s": round(time.monotonic() - entry._t0, 6),
            "plan_fingerprint": entry.plan_fingerprint,
            "admission_wait_s": round(entry.admission_wait_s, 6),
            "shed_level": entry.shed_level,
            "rows_out": entry.rows_out,
            "bytes_out": entry.bytes_out,
            # Process-level deltas over the query's bracket: approximate
            # under concurrency, exact when serial (documented contract).
            "compile_cache_hits": int(m1["compile_cache_hits"]
                                      - entry._m0["compile_cache_hits"]),
            "compile_cache_misses": int(m1["compile_cache_misses"]
                                        - entry._m0["compile_cache_misses"]),
            "stage_fusions": int(m1["stage_fusions"]
                                 - entry._m0["stage_fusions"]),
            # Optional (not in the v1/v2 required pin): shuffle exchange
            # volume over the query's bracket — a flight record of a
            # shuffle-heavy plan names its dominant cost without a trace.
            "shuffle_bytes_written": int(m1["shuffle_bytes_written"]
                                         - entry._m0["shuffle_bytes_written"]),
            "shuffle_bytes_fetched": int(m1["shuffle_bytes_fetched"]
                                         - entry._m0["shuffle_bytes_fetched"]),
            "peak_rss_bytes": _peak_rss(),
            "plan_cache_hit": entry.plan_cache_hit,
            "result_cache_hit": entry.result_cache_hit,
            "mem": entry.mem,
            # Schema v4's view block: {} until the streaming views
            # (ROADMAP A.8.6) maintain or serve from a view.
            "view": {},
            "profiled": entry.profiled or profile is not None,
            "autoprofiled": entry.autoprofiled,
            "operators": _operator_digest(profile),
        }
        # Schema-v5 OPTIONAL block: stamped only when the integrity plane
        # saw traffic during this query's bracket (same process-level-delta
        # caveat as the compile/shuffle counters above).
        integ = {k: int(m1[f"integrity_{k}"] - entry._m0[f"integrity_{k}"])
                 for k in ("verified", "failed", "quarantined")}
        if any(integ.values()):
            record["integrity"] = integ
        # Schema v6's optional blocks (``estimates``, ``query_fingerprint``)
        # come from the feedback store, ROADMAP A.8.6: never stamped here.
        self._publish(record, cfg=entry.cfg)
        return record

    def _publish(self, record: dict, cfg=None) -> None:
        with self._lock:
            self._ring.append(record)
            self._totals[record["outcome"]] = \
                self._totals.get(record["outcome"], 0) + 1
        # Per-context "my query's record": finish_entry runs on the thread
        # draining the query (the runner's finally), so the network front
        # door can read ITS query's facts race-free under concurrent
        # serving threads — unlike recent(1), which any tenant can bump.
        _last_record_var.set(record)
        from daft_tpu_torch import metrics

        metrics.QUERYLOG_RECORDS.labels(record["outcome"]).inc()
        sink = self._resolve_sink(cfg)
        if sink is not None:
            try:
                sink.write(record)
            except OSError:
                log.warning("query-log sink write failed (%s)",
                            self._sink_path, exc_info=True)
                metrics.QUERYLOG_DROPPED.inc()
        # Feed the SLO plane LAST, and never let a tracker bug surface as
        # a recorder failure: the record is already durable in the ring at
        # this point, so counting it DROPPED (finish's catch-all) would
        # double-book a record that landed.
        try:
            from daft_tpu_torch import slo

            if cfg is None:
                from daft_tpu_torch.context import get_context

                cfg = get_context().execution_config
            slo.get_tracker().observe(record, cfg)
        except Exception:
            log.warning("SLO tracker failed to observe query %s",
                        record.get("query_id"), exc_info=True)

    def _resolve_sink(self, cfg=None) -> Optional[_QueryLogSink]:
        from daft_tpu_torch.config import daft_env

        path = daft_env("DAFT_QUERY_LOG")
        if not path:
            if cfg is None:
                from daft_tpu_torch.context import get_context

                cfg = get_context().execution_config
            path = getattr(cfg, "query_log_path", None)
        if not path:
            return None
        with self._lock:
            if self._sink is None or self._sink_path != path:
                if self._sink is not None:
                    self._sink.close()
                try:
                    max_bytes = int(daft_env("DAFT_QUERY_LOG_MAX_BYTES",
                                             str(DEFAULT_MAX_BYTES)))
                except (TypeError, ValueError):
                    max_bytes = DEFAULT_MAX_BYTES
                self._sink = _QueryLogSink(path, max_bytes=max_bytes)
                self._sink_path = path
            return self._sink

    # -- introspection ----------------------------------------------------
    def recent(self, n: Optional[int] = None, tenant: Optional[str] = None,
               outcome: Optional[str] = None) -> List[dict]:
        """Newest-first ring slice, optionally filtered — the
        ``daft_tpu_torch.recent_queries()`` / ``/api/querylog`` surface."""
        with self._lock:
            out = list(self._ring)
        out.reverse()
        if tenant:
            out = [r for r in out if r["tenant"] == tenant]
        if outcome:
            out = [r for r in out if r["outcome"] == outcome]
        return out[:n] if n else out

    def record_for(self, query_id: str) -> Optional[dict]:
        with self._lock:
            for r in reversed(self._ring):
                if r["query_id"] == query_id:
                    return r
        return None

    def stats(self) -> dict:
        with self._lock:
            return {"total": sum(self._totals.values()),
                    "by_outcome": dict(self._totals),
                    "ring": len(self._ring),
                    "ring_size": self.ring_size,
                    "sink_path": self._sink_path}

    def reset(self) -> None:
        """Drop all recorded state (tests)."""
        with self._lock:
            self._ring.clear()
            self._totals = {o: 0 for o in OUTCOMES}
            if self._sink is not None:
                self._sink.close()
            self._sink = None
            self._sink_path = None


def _peak_rss() -> int:
    try:
        import resource
        import sys

        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        return int(rss) if sys.platform == "darwin" else int(rss) * 1024
    except (ImportError, ValueError, OSError):
        return 0


# --------------------------------------------------------------------- #
# JSONL reader (torn-line-safe, the trajectory-store discipline)          #
# --------------------------------------------------------------------- #
def validate_record(rec: Any) -> List[str]:
    """Schema check for one query-log line; returns problems (empty =
    valid). Shared by the writer's tests and any reader that must not
    trust a torn tail line. Accepts EVERY schema version from v1
    (pre-cache) through v2 (cache-hit fields), v3 (the memory ``mem``
    block), v4 (the streaming ``view`` block), v5 (optional ``integrity``
    block), and v6 (optional ``estimates`` block + ``query_fingerprint``)
    — a log written across the upgrades loads whole."""
    errs: List[str] = []
    if not isinstance(rec, dict):
        return [f"record is {type(rec).__name__}, not an object"]
    version = rec.get("schema_version")
    required = {1: RECORD_REQUIRED_V1,
                2: RECORD_REQUIRED_V2,
                3: RECORD_REQUIRED_V3,
                4: RECORD_REQUIRED_V4,
                5: RECORD_REQUIRED_V5}.get(version, RECORD_REQUIRED_V6)
    for key in required:
        if key not in rec:
            errs.append(f"missing key {key!r}")
    if errs:
        return errs
    if version not in (1, 2, 3, 4, 5, QUERYLOG_SCHEMA_VERSION):
        errs.append(f"schema_version {version!r} not in "
                    f"(1, 2, 3, 4, 5, {QUERYLOG_SCHEMA_VERSION})")
    if rec["outcome"] not in OUTCOMES:
        errs.append(f"unknown outcome {rec['outcome']!r}")
    if not isinstance(rec.get("duration_s"), (int, float)) \
            or rec.get("duration_s", -1) < 0:
        errs.append("duration_s must be a non-negative number")
    return errs


def load_query_log(path: str, include_rotated: bool = False) -> List[dict]:
    """Every schema-valid record in the sink (oldest first). Torn, corrupt,
    or schema-invalid lines are skipped, never fatal — the process may have
    died mid-write and the log must still load. ``include_rotated`` reads
    ``<path>.1`` first when present."""
    paths = ([path + ".1", path] if include_rotated else [path])
    out: List[dict] = []
    for p in paths:
        try:
            f = open(p)
        except OSError:
            continue
        with f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if validate_record(rec):
                    continue
                out.append(rec)
    return out


# --------------------------------------------------------------------- #
# Process-global recorder + runner glue                                   #
# --------------------------------------------------------------------- #
_RECORDER: Optional[FlightRecorder] = None
_recorder_lock = threading.Lock()


def get_recorder() -> FlightRecorder:
    global _RECORDER
    if _RECORDER is None:
        with _recorder_lock:
            if _RECORDER is None:
                _RECORDER = FlightRecorder()
    return _RECORDER


_last_record_var: contextvars.ContextVar[Optional[dict]] = \
    contextvars.ContextVar("daft_last_query_record", default=None)

@contextlib.contextmanager
def view_scope(info: dict):
    """The bracket a materialized view's refresh puts around its delta
    queries, stamping their records' ``view`` block: the streaming views
    are ROADMAP A.8.6."""
    raise DaftNotImplementedError(
        "querylog.view_scope: the streaming views are not ported yet, ROADMAP A.8.6")
    yield  # pragma: no cover - a generator, for contextmanager


def last_record() -> Optional[dict]:
    """The most recent flight record finished ON THIS context (thread-
    scoped): the network front door's way to attach the record's facts
    (cache hits, admission wait, outcome) to the response it just served,
    race-free under concurrent serving threads."""
    return _last_record_var.get()


def recent_queries(n: Optional[int] = None, tenant: Optional[str] = None,
                   outcome: Optional[str] = None) -> List[dict]:
    """The flight recorder's bounded ring, newest first — the operator's
    "what just happened" surface (``daft_tpu_torch.recent_queries()``)."""
    return get_recorder().recent(n=n, tenant=tenant, outcome=outcome)


def record_fleet_event(kind: str, **fields) -> dict:
    """The fleet's membership events (scale decisions, launches, drains)
    keep a ring of their own beside the records: the fleet is ROADMAP
    A.8.5."""
    raise DaftNotImplementedError(
        "querylog.record_fleet_event: the fleet is not ported yet, ROADMAP A.8.5")


def recent_fleet_events(n: Optional[int] = None) -> List[dict]:
    """Newest-first slice of the fleet's event ring: ROADMAP A.8.5."""
    raise DaftNotImplementedError(
        "querylog.recent_fleet_events: the fleet is not ported yet, ROADMAP A.8.5")


def finish_entry(entry: Optional[FlightEntry],
                 error: Optional[BaseException] = None,
                 profile=None) -> None:
    """Null-safe entry close — the runners' one-liner for every exit path."""
    if entry is not None:
        entry.finish(error=error, profile=profile)


def maybe_autoprofile(query_id: str, entry: Optional[FlightEntry]):
    """Tail-based auto-profiling hook: called by the runners right after
    planning (the first moment the fingerprint exists) for queries NOT
    already profiled. When the SLO plane armed this plan fingerprint — a
    matching query recently blew its tenant's latency objective — a full
    QueryProfile opens for this run and the armed budget decrements.
    Returns the profile or None."""
    if entry is None or not entry.plan_fingerprint:
        return None
    from daft_tpu_torch import slo

    if not slo.get_tracker().consume_autoprofile(entry.plan_fingerprint):
        return None
    from daft_tpu_torch import metrics, profiling

    prof = profiling.force_begin_query(query_id)
    if prof is None:
        return None
    prof.root.attributes["autoprofile"] = True
    prof.root.attributes["plan_fingerprint"] = entry.plan_fingerprint
    entry.autoprofiled = True
    entry.profiled = True
    metrics.AUTOPROFILE_CAPTURES.inc()
    log.info("tail-sampling: auto-profiling query %s (fingerprint %s)",
             query_id, entry.plan_fingerprint)
    return prof
