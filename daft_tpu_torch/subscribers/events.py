"""Engine events + subscriber ABC (port of ``daft_tpu/subscribers/events.py``,
whole: the events of modules the port does not have yet, the fleet, admission,
the SLO plane and the streaming views, are plain dataclasses nobody fires).

Reference: the ``Subscriber`` trait and 15-variant ``Event`` enum
(src/daft-context/src/subscribers/mod.rs:52, events.rs:11-32) and the Python
subscriber ABC (daft/subscribers/).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional


@dataclass
class Event:
    pass


@dataclass
class QueryStart(Event):
    query_id: str = ""
    plan: str = ""


@dataclass
class QueryEnd(Event):
    query_id: str = ""
    duration_s: float = 0.0
    error: Optional[str] = None


@dataclass
class OptimizationStart(Event):
    query_id: str = ""


@dataclass
class OptimizationEnd(Event):
    query_id: str = ""
    optimized_plan: str = ""


@dataclass
class TaskScheduled(Event):
    query_id: str = ""
    task_id: str = ""
    worker_id: str = ""
    # Execution attempt (0 = first): retries and speculative duplicates
    # carry their attempt number so profiler spans stay distinguishable.
    attempt: int = 0


@dataclass
class TaskCompleted(Event):
    query_id: str = ""
    task_id: str = ""
    worker_id: str = ""
    duration_s: float = 0.0
    error: Optional[str] = None
    # Which execution attempt finished (matches TaskScheduled.attempt): the
    # profiler pairs completions to open attempt spans by it, so a retry
    # landing on the same worker as its original can't close the wrong span.
    attempt: int = 0


@dataclass
class TaskRetried(Event):
    """A task attempt was abandoned / duplicated and the task re-queued.
    ``reason`` is one of ``worker-died``, ``transient``, ``fetch-recovery``,
    ``straggler`` (speculative duplicate)."""

    query_id: str = ""
    task_id: str = ""
    worker_id: str = ""
    attempt: int = 0
    reason: str = ""


@dataclass
class WorkerLost(Event):
    """A worker was marked dead (task failure, heartbeat timeout, or
    unreachable partition fetch)."""

    worker_id: str = ""
    reason: str = ""


@dataclass
class WorkerLaunched(Event):
    """The fleet controller (distributed/fleet.py) added a worker —
    scale-up launch or re-activation of a worker that was draining.
    ``reason`` names the triggering signal (queue-pressure / slo-burn /
    shed-level / memory-pressure / inflight / manual)."""

    worker_id: str = ""
    reason: str = ""
    num_slots: int = 0
    reactivated: bool = False


@dataclass
class WorkerDrainStarted(Event):
    """A worker entered ``draining``: the scheduler stops placing new
    tasks on it; running tasks finish (or time out into lineage
    recovery) and its partitions/chunk files migrate before release."""

    worker_id: str = ""
    reason: str = ""
    active_tasks: int = 0


@dataclass
class WorkerDrained(Event):
    """A drain completed and passed both leak audits (shuffle chunk files
    + memory ledger); the worker was released. ``migrated_partitions`` /
    ``migrated_bytes`` size the state moved off the worker."""

    worker_id: str = ""
    duration_s: float = 0.0
    migrated_partitions: int = 0
    migrated_bytes: int = 0


@dataclass
class ScaleDecision(Event):
    """One fleet-controller decision with its triggering signal snapshot.
    ``direction`` is ``up`` / ``down`` / ``hold``; ``reason`` names the
    dominant signal; ``workers`` is the post-decision live worker count."""

    direction: str = ""
    reason: str = ""
    workers: int = 0
    signal: Dict[str, Any] = field(default_factory=dict)


@dataclass
class PartitionRecovered(Event):
    """Lost partitions were recomputed from lineage on a live worker."""

    query_id: str = ""
    task_id: str = ""  # the recomputed producer task
    worker_id: str = ""  # the dead worker that held the partitions
    num_partitions: int = 0


@dataclass
class CorruptionDetected(Event):
    """An artifact failed integrity verification at read
    (integrity.py): the bytes on disk / off the wire do not match
    the digest minted at write time. ``artifact`` is chunk / spill /
    checkpoint; ``action`` is what the plane did about it (``quarantined``
    — file renamed to *.quarantined pending sweep — or ``detected`` when
    there was no file to quarantine, e.g. a wire-side content mismatch);
    ``ticket`` names the shuffle chunk for lineage recovery."""

    artifact: str = ""
    path: str = ""
    ticket: str = ""
    expected: str = ""
    actual: str = ""
    action: str = ""


@dataclass
class StreamCorruptLines(Event):
    """A tailing source skipped corrupt (undecodable) JSONL lines during
    one poll (streaming/sources.py AppendLogSource). One event per poll
    that saw any — ``offsets`` are the byte offsets of the skipped lines
    within the log, ``count`` how many this poll."""

    source: str = ""
    path: str = ""
    count: int = 0
    offsets: tuple = ()


@dataclass
class QueryCancelled(Event):
    """The query's deadline expired or the user cancelled it; the scheduler
    is aborting through the drain path. ``reason`` is ``deadline`` or the
    user-supplied cancel reason; ``progress`` snapshots per-task state at
    cancel time ({completed, running, pending})."""

    query_id: str = ""
    reason: str = ""
    progress: Dict[str, Any] = field(default_factory=dict)


@dataclass
class QueryQueued(Event):
    """The query hit its tenant's concurrency/memory quota and entered the
    bounded admission queue (execution/admission.py). ``queue_depth`` is
    the tenant's queue length INCLUDING this query."""

    query_id: str = ""
    tenant: str = ""
    queue_depth: int = 0


@dataclass
class QueryAdmitted(Event):
    """The query passed the admission front door. ``wait_s`` is 0 on the
    uncontended fast path; ``shed_level`` is the overload-ladder level at
    admission and ``compute_threads_cap`` (0 = uncapped) the per-query
    stage-parallelism cap applied at level >= 2."""

    query_id: str = ""
    tenant: str = ""
    wait_s: float = 0.0
    shed_level: int = 0
    compute_threads_cap: int = 0


@dataclass
class QueryShed(Event):
    """The query was rejected at admission — fast, before planning or
    dispatch. ``reason``: queue-full / deadline-too-short /
    shed-low-priority / shed-over-quota / overload. ``retry_after_s`` is
    the backoff hint shipped to the client in DaftAdmissionError."""

    query_id: str = ""
    tenant: str = ""
    reason: str = ""
    queue_depth: int = 0
    retry_after_s: float = 0.0


@dataclass
class SLOBurnRateAlert(Event):
    """A tenant is burning its SLO error budget faster than the alerting
    thresholds in BOTH the fast and slow windows (the SLO plane, ROADMAP A.8). Fired
    once per episode; ``bad_fraction`` is the fast window's share of bad
    queries (failed/timeout/shed/over-latency-objective)."""

    tenant: str = ""
    fast_burn_rate: float = 0.0
    slow_burn_rate: float = 0.0
    bad_fraction: float = 0.0
    error_rate_objective: float = 0.0
    latency_objective_s: float = 0.0
    window_s: float = 0.0


@dataclass
class ViewRefreshed(Event):
    """A materialized view absorbed a delta (streaming views, ROADMAP A.8).
    ``delta_files``/``delta_rows`` size the absorbed micro-batch;
    ``watermark`` is the view's new high-water mark (max source mtime of
    everything absorbed); ``full_recompute`` marks a rebase (a source file
    changed in place, invalidating incremental state)."""

    view: str = ""
    tenant: str = ""
    watermark: float = 0.0
    delta_files: int = 0
    delta_rows: int = 0
    duration_s: float = 0.0
    full_recompute: bool = False


@dataclass
class FreshnessBurnRateAlert(Event):
    """A view is burning its staleness error budget faster than the
    alerting thresholds in BOTH burn windows (the SLO plane
    FreshnessTracker). ``stale_fraction`` is the fast window's share of
    samples over the staleness objective."""

    view: str = ""
    tenant: str = ""
    fast_burn_rate: float = 0.0
    slow_burn_rate: float = 0.0
    stale_fraction: float = 0.0
    staleness_objective_s: float = 0.0
    window_s: float = 0.0


@dataclass
class CircuitOpened(Event):
    """An IO endpoint's circuit breaker tripped open after consecutive
    transient failures; calls now fail fast until a probe succeeds."""

    endpoint: str = ""
    failures: int = 0
    open_for_s: float = 0.0


@dataclass
class CircuitClosed(Event):
    """A half-open probe against the endpoint succeeded; traffic resumes."""

    endpoint: str = ""


@dataclass
class PlanCorrected(Event):
    """The feedback plane changed a decision the optimizer's estimates got
    wrong — a re-plan under observed statistics (kind="replan"), or a
    mid-query strategy switch when the first-chunk probe contradicted the
    estimate (kind="agg-partition" / "join-spill" / "shuffle-buckets").
    The correction itself is observable: estimated vs observed carry the
    contradiction that triggered it."""

    query_id: str = ""
    fingerprint: str = ""  # query fingerprint (pre-optimize key)
    node: str = ""         # plan-node fingerprint or operator label
    kind: str = ""         # replan | agg-partition | join-spill | shuffle-buckets
    estimated: float = 0.0
    observed: float = 0.0
    action: str = ""       # human-readable decision ("switched to ...")


@dataclass
class OperatorStats(Event):
    query_id: str = ""
    operator: str = ""
    rows_in: int = 0
    rows_out: int = 0
    cpu_us: int = 0
    extra: Dict[str, Any] = field(default_factory=dict)


class Subscriber:
    """Attach with ``get_context().attach_subscriber(sub)``."""

    def on_event(self, event: Event) -> None:
        raise NotImplementedError
