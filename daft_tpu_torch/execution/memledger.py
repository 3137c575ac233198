"""The per-query, per-operator byte ledger (port of
``daft_tpu/execution/memledger.py``).

Every byte-holding part of the executor reports into this one ledger:

* **Charges** are ``(query_id, operator, kind)``-keyed byte deltas. Kinds:

  ======  ================================================================
  permit  MemoryManager bytes the query's executor holds (blocking sinks,
          shared-subtree pins: the executor's ``_add_held``) and the
          spilling sinks' ``budget_reservation`` working sets
  queue   a pipeline stage's bounded-queue residency: a morsel is charged
          when a stage worker completes it and released when the consumer
          takes it (``execution/pipeline.py``)
  spill   spill-file residency (``execution/spill.py`` ``SpillDir``),
          charged at write and released when the spill directory goes
  ======  ================================================================

* **Pairing by structure**: every charge site is paired with its release
  site in code, so the ledger drains to zero at query teardown. Releases
  clamp at zero and ignore unknown keys: a release racing teardown is a
  no-op, never a negative balance. :meth:`MemoryLedger.finish_query`
  force-drains any residue and reports it (``residual_bytes``), so a leaking
  charge site shows.
* **The query's block**: at query end ``DataFrame`` calls
  :meth:`finish_query`, which returns the query's ``mem`` block (peak held,
  charged, spilled, stall seconds, per-operator peaks, the RSS high-water
  over the query) and keeps it for :meth:`profile_for`.
* **Determinism**: cumulative charged bytes per (operator, kind) are a pure
  function of the morsel stream, the same at any ``num_compute_threads``
  (peaks vary with concurrency).
* **Process truth**: :class:`RssSampler` wakes only while queries are in
  flight and stamps the process RSS onto each of them.

``memory_ledger_enabled=False`` (``ExecutionConfig``) turns the ledger off:
charge and release become no-ops.

The metrics registry gets the JAX package's series (``daft_pipeline_stall_
seconds_total``, ``daft_memory_ledger_residual_bytes_total``, and the
sampler's ``daft_memory_rss_bytes`` / ``daft_memory_ledger_held_bytes`` /
``daft_memory_unaccounted_bytes``); :meth:`MemoryLedger.process_stats` keeps
the same numbers in process. ``finish_query`` reconciles each query's peak
against its admission reservation (``daft_memory_reservation_over_bytes``
/ ``..._under_bytes``). Not ported: the worker wire
(``drain_query_wire``, ``merge_worker_profile``) and the ``shuffle`` /
``cache`` kinds, which belong to the distributed layer (ROADMAP A.8.5).
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

KIND_PERMIT = "permit"
KIND_QUEUE = "queue"
KIND_SPILL = "spill"
KINDS = (KIND_PERMIT, KIND_QUEUE, KIND_SPILL)

#: Operator rows kept on a finished query's ``mem`` block (top by peak).
PROFILE_TOP_OPERATORS = 8

#: Finished profiles kept for :meth:`MemoryLedger.profile_for`.
PROFILE_RING = 256


class _OpSlot:
    """Per-(operator, kind) accumulator inside one query's ledger."""

    __slots__ = ("held", "peak", "charged")

    def __init__(self):
        self.held = 0
        self.peak = 0
        self.charged = 0


class _QueryLedger:
    """One in-flight query's byte state, under its own lock so charges on
    one query never contend with another's."""

    __slots__ = ("query_id", "lock", "ops", "held", "peak", "charged", "stall_ns",
                 "rss_peak", "started_at")

    def __init__(self, query_id: str):
        self.query_id = query_id
        self.lock = threading.Lock()
        self.ops: Dict[tuple, _OpSlot] = {}
        self.held = 0
        self.peak = 0
        self.charged = 0
        self.stall_ns = 0
        self.rss_peak = 0
        self.started_at = time.monotonic()

    def snapshot(self) -> dict:
        with self.lock:
            by_op: Dict[str, dict] = {}
            for (op, kind), slot in self.ops.items():
                row = by_op.setdefault(op or "(unattributed)",
                                       {"peak": 0, "held": 0, "charged": 0, "kinds": {}})
                row["peak"] += slot.peak
                row["held"] += slot.held
                row["charged"] += slot.charged
                row["kinds"][kind] = {"peak": slot.peak, "charged": slot.charged}
            return {
                "query_id": self.query_id,
                "held_bytes": self.held,
                "peak_held_bytes": self.peak,
                "charged_bytes": self.charged,
                "stall_s": round(self.stall_ns / 1e9, 6),
                "rss_peak_bytes": self.rss_peak,
                "age_s": round(time.monotonic() - self.started_at, 3),
                "by_operator": by_op,
            }


class MemoryLedger:
    """THE process byte ledger (one per process, like the MemoryManager
    whose grants it attributes)."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._queries: Dict[str, _QueryLedger] = {}
        self._ring: deque = deque(maxlen=PROFILE_RING)
        self._sampler: Optional[RssSampler] = None
        self._process = self._fresh_process_stats()

    @staticmethod
    def _fresh_process_stats() -> dict:
        return {"stall_s_by_op": {}, "residual_bytes": 0, "rss_bytes": 0,
                "held_bytes": 0, "unaccounted_bytes": 0}

    # -- query lookup ------------------------------------------------------
    def _q(self, query_id: str) -> _QueryLedger:
        q = self._queries.get(query_id)
        if q is None:
            with self._lock:
                q = self._queries.setdefault(query_id, _QueryLedger(query_id))
            self._wake_sampler()
        return q

    # -- charge / release --------------------------------------------------
    def charge(self, query_id: str, op: str, nbytes: int, kind: str = KIND_PERMIT) -> None:
        """Attribute ``nbytes`` now held by ``query_id``'s ``op``. A charge
        with no query id is dropped: nothing would ever finish it (a bare
        Executor in a test)."""
        if not self.enabled or nbytes <= 0 or not query_id:
            return
        q = self._q(query_id)
        with q.lock:
            slot = q.ops.get((op, kind))
            if slot is None:
                slot = q.ops.setdefault((op, kind), _OpSlot())
            slot.held += nbytes
            slot.charged += nbytes
            if slot.held > slot.peak:
                slot.peak = slot.held
            q.held += nbytes
            q.charged += nbytes
            if q.held > q.peak:
                q.peak = q.held

    def release(self, query_id: str, op: str, nbytes: int, kind: str = KIND_PERMIT) -> None:
        """Return ``nbytes`` charged before. Clamps at zero and ignores
        unknown (query, op, kind) keys: a release racing teardown is a
        no-op, never a negative balance."""
        if not self.enabled or nbytes <= 0:
            return
        q = self._queries.get(query_id or "")
        if q is None:
            return
        with q.lock:
            slot = q.ops.get((op, kind))
            if slot is None:
                return
            taken = min(nbytes, slot.held)
            slot.held -= taken
            q.held -= taken

    def note_stall(self, query_id: str, op: str, seconds: float) -> None:
        """A stage feeder spent ``seconds`` unable to enqueue because its
        bounded queue was full (backpressure downstream of ``op``)."""
        if not self.enabled or seconds <= 0:
            return
        from daft_tpu_torch import metrics

        metrics.PIPELINE_STALL.labels(op or "stage").inc(seconds)
        with self._lock:
            by_op = self._process["stall_s_by_op"]
            by_op[op or "stage"] = by_op.get(op or "stage", 0.0) + seconds
        if not query_id:
            return  # the process total keeps it; no entry to strand
        q = self._q(query_id)
        with q.lock:
            q.stall_ns += int(seconds * 1e9)

    # -- finish ------------------------------------------------------------
    def finish_query(self, query_id: str, reserved_bytes: int = 0,
                     tenant: str = "") -> dict:
        """Close the query's ledger into its ``mem`` block, reconciling its
        peak against the admission reservation (``reserved_bytes``, the
        ticket's ``mem_reserved``): ``over_bytes`` / ``under_bytes`` on the
        block and on ``daft_memory_reservation_over_bytes`` /
        ``..._under_bytes``. Any residue still held is FORCE-DRAINED (the
        ledger returns to zero at teardown whatever the outcome) and
        reported as ``residual_bytes``."""
        with self._lock:
            # The pop runs even when the ledger is disabled: a query that
            # charged before a mid-flight disable must not strand its balance.
            q = self._queries.pop(query_id or "", None)
        if not self.enabled:
            return {}
        with self._lock:
            self._sweep_stale_locked()
        if q is None:
            q = _QueryLedger(query_id or "")
        snap = q.snapshot()
        residual = snap.pop("held_bytes")
        peak = snap["peak_held_bytes"]
        spilled = sum(k["charged"] for row in snap["by_operator"].values()
                      for kind, k in row["kinds"].items() if kind == KIND_SPILL)
        # Bound the per-operator table: the top rows by peak.
        by_op = dict(sorted(snap["by_operator"].items(),
                            key=lambda kv: -kv[1]["peak"])[:PROFILE_TOP_OPERATORS])
        for row in by_op.values():
            row.pop("held", None)
        over = under = 0
        if reserved_bytes > 0:
            over = max(peak - reserved_bytes, 0)
            under = max(reserved_bytes - peak, 0)
        block = {
            "reserved_bytes": int(reserved_bytes),
            "peak_held_bytes": peak,
            "charged_bytes": snap["charged_bytes"],
            "spilled_bytes": spilled,
            "stall_s": snap["stall_s"],
            "over_bytes": over,
            "under_bytes": under,
            "rss_peak_bytes": snap["rss_peak_bytes"],
            "residual_bytes": residual,
            "by_operator": by_op,
        }
        from daft_tpu_torch import metrics

        if reserved_bytes > 0:
            metrics.MEM_RESERVATION_OVER.inc(over)
            metrics.MEM_RESERVATION_UNDER.inc(under)
        if residual:
            metrics.MEM_LEDGER_RESIDUAL.inc(residual)
        with self._lock:
            self._process["residual_bytes"] += residual
            self._ring.append({"query_id": query_id, "tenant": tenant,
                               "ts": time.time(), **block})
        return block

    def _sweep_stale_locked(self, max_age_s: float = 3600.0) -> None:
        """Drop husks (the caller holds ``_lock``): a stage worker completing
        a morsel just as its query finished re-creates the query's entry with
        nothing held and no ``finish_query`` to come."""
        now = time.monotonic()
        for qid in [qid for qid, ql in self._queries.items()
                    if ql.held == 0 and now - ql.started_at > max_age_s]:
            del self._queries[qid]

    # -- introspection / audit ---------------------------------------------
    def total_held(self) -> int:
        """Bytes the ledger believes are live now, across every query and
        kind: 0 on an idle engine, always."""
        with self._lock:
            queries = list(self._queries.values())
        return sum(q.held for q in queries)

    def audit(self) -> Dict[str, int]:
        """{query_id: held bytes} for every query with a balance (empty on a
        healthy idle engine)."""
        with self._lock:
            queries = list(self._queries.values())
        return {q.query_id: q.held for q in queries if q.held}

    def live_snapshot(self) -> List[dict]:
        with self._lock:
            queries = list(self._queries.values())
        return [q.snapshot() for q in queries]

    def profile_for(self, query_id: str) -> Optional[dict]:
        """The finished ``mem`` block of ``query_id`` (None if not kept)."""
        with self._lock:
            for p in reversed(self._ring):
                if p["query_id"] == query_id:
                    return p
        return None

    def process_stats(self) -> dict:
        """The process-wide numbers the JAX package exports as Prometheus
        series: stall seconds by operator, the force-drained residue, and
        the sampler's last RSS, held and unaccounted bytes."""
        with self._lock:
            return {**self._process, "stall_s_by_op": dict(self._process["stall_s_by_op"])}

    def reset(self) -> None:
        """Drop all state (tests)."""
        with self._lock:
            self._queries.clear()
            self._ring.clear()
            self._process = self._fresh_process_stats()

    def active_queries(self) -> int:
        with self._lock:
            return len(self._queries)

    # -- RSS sampler -------------------------------------------------------
    def _wake_sampler(self) -> None:
        s = self._sampler
        if s is not None:
            s.wake()

    def ensure_sampler(self, cfg=None) -> Optional["RssSampler"]:
        """Start the process RSS sampler once (the first query through the
        runner arms it). None while the ledger is off, or when
        ``DAFT_MEM_SAMPLER=0`` / ``mem_sampler_enabled=False`` disables it."""
        if not self.enabled:
            return None
        if self._sampler is not None:
            return self._sampler
        from daft_tpu_torch.config import daft_env_flag

        enabled = daft_env_flag("DAFT_MEM_SAMPLER", True)
        if cfg is not None and not getattr(cfg, "mem_sampler_enabled", True):
            enabled = False
        if not enabled:
            return None
        with self._lock:
            if self._sampler is None:
                self._sampler = RssSampler(self)
                self._sampler.start()
            return self._sampler

    def _sampler_tick(self, rss: int) -> None:
        """One observation: the process RSS against the ledger's belief, and
        the RSS high-water stamped onto every in-flight query."""
        from daft_tpu_torch import metrics

        held = self.total_held()
        metrics.MEM_RSS.set(rss)
        metrics.MEM_LEDGER_HELD.set(held)
        metrics.MEM_UNACCOUNTED.set(max(rss - held, 0))
        with self._lock:
            self._process.update(rss_bytes=rss, held_bytes=held,
                                 unaccounted_bytes=max(rss - held, 0))
            self._sweep_stale_locked()
            queries = list(self._queries.values())
        for q in queries:
            with q.lock:
                if rss > q.rss_peak:
                    q.rss_peak = rss


def peak_rss_bytes() -> int:
    """Peak resident set of THIS process so far (``ru_maxrss``: kilobytes on
    Linux, bytes on macOS); 0 where the resource module is unavailable. The
    port's copy of ``daft_tpu/perf_report.py``'s helper."""
    try:
        import resource
        import sys

        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        return int(rss if sys.platform == "darwin" else rss * 1024)
    except (ImportError, OSError, ValueError):
        return 0


def read_rss_bytes() -> int:
    """Current process RSS. Linux reads /proc/self/statm (resident pages);
    elsewhere the ``ru_maxrss`` HIGH-water (a peak, not a level)."""
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return pages * (os.sysconf("SC_PAGE_SIZE") if hasattr(os, "sysconf") else 4096)
    except (OSError, ValueError, IndexError):
        return peak_rss_bytes()


class RssSampler:
    """Daemon thread correlating process RSS against the ledger. It sleeps
    on an event while no query is in flight, so an idle process pays no
    wakeups."""

    def __init__(self, ledger: MemoryLedger, interval_s: float = 0.25):
        self.ledger = ledger
        self.interval_s = max(float(interval_s), 0.02)
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True, name="daft-mem-sampler")
        self.samples = 0

    def start(self) -> None:
        self._thread.start()

    def wake(self) -> None:
        self._wake.set()

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()

    def _run(self) -> None:
        while not self._stop.is_set():
            if self.ledger.active_queries() == 0:
                # Park until the next query begins.
                self._wake.wait()
                self._wake.clear()
                if self._stop.is_set():
                    return
            self.ledger._sampler_tick(read_rss_bytes())
            self.samples += 1
            time.sleep(self.interval_s)


_LEDGER: Optional[MemoryLedger] = None
_ledger_lock = threading.Lock()


def get_ledger() -> MemoryLedger:
    """THE process memory ledger. Never replaced (charge sites hold no
    reference of their own); tests toggle ``.enabled`` or call ``reset()``."""
    global _LEDGER
    if _LEDGER is None:
        with _ledger_lock:
            if _LEDGER is None:
                _LEDGER = MemoryLedger()
    return _LEDGER
