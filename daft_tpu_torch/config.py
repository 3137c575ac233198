"""Planning and execution configuration (port of ``daft_tpu/config.py``).

Reference: ``DaftPlanningConfig`` / ``DaftExecutionConfig``
(src/common/daft-config/src/lib.rs:120-200). Frozen dataclasses threaded
through the context; the CUDA port's own knob is ``device``.

``ExecutionConfig.from_env()`` builds the process's default config, as the
JAX package's context does, reading the JAX package's variable names
verbatim for every field the port has: ``DAFT_TPU_DEVICE_EVAL``, ``DAFT_COMPILED_EVAL``, ``DAFT_COMPUTE_THREADS``,
``DAFT_QUERY_TIMEOUT_S``, ``DAFT_METRICS``, ``DAFT_METRICS_FILE``,
``DAFT_PROFILE``, ``DAFT_PROFILE_FILE``, ``DAFT_PLAN_CACHE``,
``DAFT_PLAN_CACHE_SIZE``, ``DAFT_RESULT_CACHE``, ``DAFT_RESULT_CACHE_BYTES``,
``DAFT_MEMLEDGER``, ``DAFT_MEM_SAMPLER``, ``DAFT_INTEGRITY``,
``DAFT_INTEGRITY_VERIFY_ON_WRITE``, the front door's ``DAFT_ADMISSION``,
``DAFT_ADMISSION_MAX_CONCURRENT``, ``DAFT_ADMISSION_QUEUE_DEPTH``,
``DAFT_ADMISSION_POLICIES``, ``DAFT_QUERY_RECORDER``, ``DAFT_QUERY_LOG``,
``DAFT_SLO_LATENCY_P99_S``, ``DAFT_SLO_ERROR_RATE`` and
``DAFT_SLO_AUTOPROFILE``. ``DAFT_QUERY_RECORDER`` is also read at every
query's start (``querylog.FlightRecorder.begin``), and
``DAFT_QUERY_LOG``, ``DAFT_QUERY_LOG_MAX_BYTES`` and ``DAFT_QUERY_LOG_RING``
where the recorder opens its sink and ring, as in the JAX package. ``DAFT_SPILL_DIR``, ``DAFT_PROFILE_CPU``,
``DAFT_DEV_ENABLE_TRACING`` / ``DAFT_TRACE_FILE``, ``DAFT_TENANT`` and the
``DAFT_MEMORY_LIMIT`` of a new ``MemoryManager`` are read where the JAX
package reads them, through :func:`daft_env`. The config's
``memory_limit_bytes`` field, whose one reader in the JAX package is the
fleet, comes with the fleet (ROADMAP A.8.5). ``DAFT_STAGE_FUSION`` has no
field here: the port's chains are always one stage (ROADMAP A.9's Keep).

The variables of layers not ported yet come with their fields in their own
slices: the shuffle (``DAFT_SHUFFLE_*``), the fleet, the faults and
speculation (``DAFT_FLEET*``, ``DAFT_FAULT_*``, ``DAFT_SPECULATION``) and the
distributed runner (``DAFT_RUNNER``), ROADMAP A.8.5; feedback and streaming
(``DAFT_FEEDBACK*``, ``DAFT_STREAMING_*``, and the views' freshness
objective ``DAFT_SLO_STALENESS_P99_S``), A.8.6.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass
from typing import Optional, Tuple


def daft_env(name: str, default: Optional[str] = None) -> Optional[str]:
    """The one place the engine reads its environment: every knob taken
    from a ``DAFT_*`` variable goes through here, so a test can patch one
    function and the set of variables honoured stays greppable."""
    return os.environ.get(name, default)


def daft_env_flag(name: str, default: bool = False) -> bool:
    """Boolean form of :func:`daft_env`: '0'/'false'/'no'/'off' (any case)
    and '' are false, unset means ``default``, anything else is true."""
    raw = os.environ.get(name)
    if raw is None:
        return default
    return raw.strip().lower() not in ("0", "false", "no", "off", "")


@dataclass(frozen=True)
class PlanningConfig:
    default_io_config: Optional[object] = None

    def with_changes(self, **kwargs) -> "PlanningConfig":
        return dataclasses.replace(self, **kwargs)


@dataclass(frozen=True)
class ExecutionConfig:
    # Scan task sizing (io/scan.py ScanInfo.to_scan_tasks): files are packed
    # into tasks of at least min and at most max bytes, at most
    # max_sources_per_scan_task files each (daft_tpu/config.py's defaults).
    scan_tasks_min_size_bytes: int = 96 * 1024 * 1024
    scan_tasks_max_size_bytes: int = 384 * 1024 * 1024
    max_sources_per_scan_task: int = 10
    # Rows a collected DataFrame's repr and the notebook table show.
    num_preview_rows: int = 8
    # Writers roll to a new file past these in-memory bytes (io/writers.py).
    parquet_target_filesize: int = 512 * 1024 * 1024
    csv_target_filesize: int = 512 * 1024 * 1024
    json_target_filesize: int = 512 * 1024 * 1024
    # Morsel rows for pipeline stages (daft_tpu/config.py's default).
    default_morsel_size: int = 256 * 1024
    # The device the relational layer runs on (device_eval and compiled
    # chains): resolved by ``device.resolve_device`` when a morsel first needs
    # it, so the default raises where no CUDA device is visible.
    device: str = "cuda"
    # Fused evaluation of the numeric subtrees of a projection (ops/device_eval).
    device_eval: bool = True
    device_eval_min_rows: int = 1024
    # Padded lengths of device batches: a program sees O(#buckets) shapes.
    device_batch_buckets: Tuple[int, ...] = (1024, 4096, 16384, 65536, 131072)
    # Whole-chain evaluation (ops/compiled_eval): a filter → project → global
    # partial-aggregation chain runs as ONE cached program per morsel or chunk.
    compiled_eval_enabled: bool = True
    # First-chunk group-reduction ratio above which the grouped aggregation
    # hash-partitions instead of merging chunk partials: a partial pass that
    # keeps more than 30% of its rows feeds a merge nearly the size of the
    # input (daft_tpu/config.py's default).
    high_cardinality_aggregation_threshold: float = 0.3
    # Workers of the executor's compute pool, which every pipelined stage
    # (Project/Filter chains, aggregation chunk partials, the partitioned
    # aggregation's split and buckets, join probes) shares, and the number of
    # the partitioned aggregation's buckets; 0 = one per visible CPU core.
    # 1 runs every stage serially on the calling thread.
    num_compute_threads: int = 0
    # Ordered stages yield in input order; False lets them yield in
    # completion order (daft_tpu/config.py's default).
    default_maintain_order: bool = True
    # Latency-constrained dynamic batching of a UDF without a batch_size
    # (execution/dynamic_batching.py), aiming each batch at this latency.
    udf_dynamic_batching: bool = True
    udf_target_batch_latency_s: float = 0.2
    # Seconds a query may run before it fails with DaftTimeoutError, when
    # collect() names no timeout; None = unbounded.
    query_timeout_s: Optional[float] = None
    # The metrics plane (metrics.py): metrics_enabled=False on the ACTIVE
    # config disables the registry process-wide at the first event (one
    # plane per process, not per query); metrics_export_path writes an
    # OTLP-JSON line per finished query (DAFT_METRICS_FILE).
    metrics_enabled: bool = True
    metrics_export_path: Optional[str] = None
    # The query profiler (profiling.py): profile every query, and write each
    # one's Chrome trace to profile_export_path (DAFT_PROFILE_FILE).
    profile_enabled: bool = False
    profile_export_path: Optional[str] = None
    # The query caches (plancache.py). Plan cache: a bounded LRU keyed on the
    # canonical pre-optimize plan text and the planning fields' digest; a hit
    # skips optimize + translate. Its entries over in-memory frames keep the
    # frames resident, so it is bounded on those bytes too. Result cache:
    # finished results and, with result_cache_scan_outputs, the scans'
    # morsel streams, byte-accounted per tenant, checked against the source
    # files' mtime and size at every hit and dropped by every engine write.
    plan_cache_enabled: bool = True
    plan_cache_size: int = 256
    plan_cache_max_pinned_bytes: int = 256 << 20
    result_cache_enabled: bool = True
    result_cache_max_bytes: int = 1 << 30
    result_cache_max_entry_bytes: int = 256 << 20
    result_cache_scan_outputs: bool = True
    # The per-query byte ledger (execution/memledger.py); False turns it off
    # and drops what it held. The RSS sampler thread beside it is
    # mem_sampler_enabled (DAFT_MEM_SAMPLER).
    memory_ledger_enabled: bool = True
    mem_sampler_enabled: bool = True
    # The admission front door (execution/admission.py), on by default with
    # unlimited per-tenant concurrency: the uncontended path is one lock
    # acquisition per query. Per-tenant defaults: max concurrent queries
    # (0 = unlimited), the bounded wait queue's depth (full = a fast
    # DaftAdmissionError), the memory-reservation quota as a fraction of
    # the MemoryManager limit (1.0 = ungated). admission_policies is a JSON
    # map {tenant: {max_concurrent_queries, max_memory_fraction,
    # queue_depth, priority, slo_latency_p99_s, slo_error_rate}}. The shed
    # ladder rises with queue pressure above admission_overload_queue_fraction
    # of capacity or a permit-wait p95 above admission_permit_wait_p95_s, and
    # steps down one level per admission_shed_cooldown_s without overload.
    admission_enabled: bool = True
    admission_max_concurrent_queries: int = 0
    admission_queue_depth: int = 32
    admission_max_memory_fraction: float = 1.0
    admission_policies: Optional[str] = None
    admission_overload_queue_fraction: float = 0.8
    admission_permit_wait_p95_s: float = 1.0
    admission_shed_cooldown_s: float = 2.0
    # The flight recorder (querylog.py): one record per query, every
    # outcome, into a bounded ring; query_log_path also appends it as JSONL
    # with a size-capped rotation.
    query_recorder_enabled: bool = True
    query_log_path: Optional[str] = None
    # The SLO plane (slo.py): per-tenant objectives (overridable in the
    # admission policy JSON), the multiwindow burn-rate alert's windows and
    # thresholds, the tail sampler's captures per armed plan fingerprint,
    # and a global slow-query threshold (> 0) below the tenant objective.
    slo_latency_p99_s: float = 30.0
    slo_error_rate: float = 0.05
    slo_fast_window_s: float = 60.0
    slo_slow_window_s: float = 300.0
    slo_fast_burn: float = 14.0
    slo_slow_burn: float = 6.0
    slo_autoprofile_count: int = 3
    slo_slow_query_s: float = 0.0
    # The spill files' digest check (integrity.py): verify before each read,
    # and with verify_on_write also right after each write.
    integrity_enabled: bool = True
    integrity_verify_on_write: bool = False

    def with_changes(self, **kwargs) -> "ExecutionConfig":
        return dataclasses.replace(self, **kwargs)

    @staticmethod
    def from_env() -> "ExecutionConfig":
        """The default config with the ``DAFT_*`` variables applied, each
        read as the JAX package's ``ExecutionConfig.from_env`` reads it."""
        cfg = ExecutionConfig()
        changes = {}
        if daft_env("DAFT_TPU_DEVICE_EVAL") in ("0", "false"):
            changes["device_eval"] = False
        if not daft_env_flag("DAFT_COMPILED_EVAL", True):
            changes["compiled_eval_enabled"] = False
        if daft_env("DAFT_COMPUTE_THREADS"):
            changes["num_compute_threads"] = int(daft_env("DAFT_COMPUTE_THREADS"))
        if daft_env("DAFT_QUERY_TIMEOUT_S"):
            changes["query_timeout_s"] = float(daft_env("DAFT_QUERY_TIMEOUT_S"))
        if not daft_env_flag("DAFT_METRICS", True):
            changes["metrics_enabled"] = False
        if daft_env("DAFT_METRICS_FILE"):
            changes["metrics_export_path"] = daft_env("DAFT_METRICS_FILE")
        if not daft_env_flag("DAFT_ADMISSION", True):
            changes["admission_enabled"] = False
        if daft_env("DAFT_ADMISSION_MAX_CONCURRENT"):
            changes["admission_max_concurrent_queries"] = int(
                daft_env("DAFT_ADMISSION_MAX_CONCURRENT"))
        if daft_env("DAFT_ADMISSION_QUEUE_DEPTH"):
            changes["admission_queue_depth"] = int(daft_env("DAFT_ADMISSION_QUEUE_DEPTH"))
        if daft_env("DAFT_ADMISSION_POLICIES"):
            changes["admission_policies"] = daft_env("DAFT_ADMISSION_POLICIES")
        if daft_env_flag("DAFT_PROFILE", False):
            changes["profile_enabled"] = True
        if daft_env("DAFT_PROFILE_FILE"):
            changes["profile_export_path"] = daft_env("DAFT_PROFILE_FILE")
        if not daft_env_flag("DAFT_QUERY_RECORDER", True):
            changes["query_recorder_enabled"] = False
        if daft_env("DAFT_QUERY_LOG"):
            changes["query_log_path"] = daft_env("DAFT_QUERY_LOG")
        if daft_env("DAFT_SLO_LATENCY_P99_S"):
            changes["slo_latency_p99_s"] = float(daft_env("DAFT_SLO_LATENCY_P99_S"))
        if daft_env("DAFT_SLO_ERROR_RATE"):
            changes["slo_error_rate"] = float(daft_env("DAFT_SLO_ERROR_RATE"))
        if daft_env("DAFT_SLO_AUTOPROFILE"):
            changes["slo_autoprofile_count"] = int(daft_env("DAFT_SLO_AUTOPROFILE"))
        if not daft_env_flag("DAFT_PLAN_CACHE", True):
            changes["plan_cache_enabled"] = False
        if daft_env("DAFT_PLAN_CACHE_SIZE"):
            changes["plan_cache_size"] = int(daft_env("DAFT_PLAN_CACHE_SIZE"))
        if not daft_env_flag("DAFT_RESULT_CACHE", True):
            changes["result_cache_enabled"] = False
        if not daft_env_flag("DAFT_MEMLEDGER", True):
            changes["memory_ledger_enabled"] = False
        if not daft_env_flag("DAFT_MEM_SAMPLER", True):
            changes["mem_sampler_enabled"] = False
        if daft_env("DAFT_RESULT_CACHE_BYTES"):
            changes["result_cache_max_bytes"] = int(daft_env("DAFT_RESULT_CACHE_BYTES"))
        if not daft_env_flag("DAFT_INTEGRITY", True):
            changes["integrity_enabled"] = False
        if daft_env_flag("DAFT_INTEGRITY_VERIFY_ON_WRITE", False):
            changes["integrity_verify_on_write"] = True
        return cfg.with_changes(**changes) if changes else cfg
