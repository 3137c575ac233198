"""Engine context and execution config (port of ``daft_tpu/context.py`` and
``daft_tpu/config.py``).

This slice keeps the knobs the embedding path, the relational layer (the
device layer and the grouped aggregation's cardinality switch), the stage
pool, UDF batching, query deadlines, the scan's task sizing, the
writers' target file sizes, the byte ledger, the spill files' digest check and
the preview read, and the planning config (``default_io_config``).
``set_execution_config`` / ``set_planning_config`` change them for the
process, ``execution_config_ctx`` / ``planning_config_ctx`` for a block of
code. The per-query clock (``query_now``) freezes CURRENT_DATE /
CURRENT_TIMESTAMP once per statement. Not ported yet: ``ExecutionConfig.
from_env`` (the port reads no ``DAFT_*`` variable), the runner choice (the
port runs the local executor only), tenants and subscribers (ROADMAP A.8).
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import datetime
from dataclasses import dataclass
from typing import Iterator, Optional, Tuple


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
    # The per-query byte ledger (execution/memledger.py); False turns it off
    # and drops what it held (daft_tpu/config.py's default).
    memory_ledger_enabled: bool = True
    # The spill files' digest check (integrity.py): verify before each read,
    # and with verify_on_write also right after each write.
    integrity_enabled: bool = True
    integrity_verify_on_write: bool = False

    def with_changes(self, **kwargs) -> "ExecutionConfig":
        return dataclasses.replace(self, **kwargs)


class DaftContext:
    def __init__(self) -> None:
        self.planning_config = PlanningConfig()
        self.execution_config = ExecutionConfig()


_CONTEXT = DaftContext()


def get_context() -> DaftContext:
    return _CONTEXT


def set_execution_config(config: Optional[ExecutionConfig] = None, **kwargs) -> None:
    ctx = get_context()
    base = config or ctx.execution_config
    ctx.execution_config = base.with_changes(**kwargs) if kwargs else base


def set_planning_config(config: Optional[PlanningConfig] = None, **kwargs) -> None:
    ctx = get_context()
    base = config or ctx.planning_config
    ctx.planning_config = base.with_changes(**kwargs) if kwargs else base


@contextlib.contextmanager
def execution_config_ctx(**kwargs) -> Iterator[None]:
    ctx = get_context()
    old = ctx.execution_config
    try:
        ctx.execution_config = old.with_changes(**kwargs)
        yield
    finally:
        ctx.execution_config = old


@contextlib.contextmanager
def planning_config_ctx(**kwargs) -> Iterator[None]:
    ctx = get_context()
    old = ctx.planning_config
    try:
        ctx.planning_config = old.with_changes(**kwargs)
        yield
    finally:
        ctx.planning_config = old


# -- per-query clock --------------------------------------------------------
# CURRENT_DATE / CURRENT_TIMESTAMP are one value per statement, not one per
# morsel: the DataFrame freezes the clock around the executor's stream, and
# the now() / today() kernels read it through query_now(). Outside a query (a
# bare Series evaluation) the wall clock is read directly. Stage threads see
# the frozen value: the pipeline hands each task a copy of the caller's
# contextvars.
_query_clock: contextvars.ContextVar[Optional[datetime.datetime]] = \
    contextvars.ContextVar("daft_torch_query_clock", default=None)


def query_now() -> datetime.datetime:
    frozen = _query_clock.get()
    return frozen if frozen is not None else datetime.datetime.now(datetime.timezone.utc)


def iter_with_frozen_clock(gen):
    """Drain ``gen`` with the query clock frozen during each resumption only,
    so two lazy queries interleaved on one thread cannot reset each other's
    clock: the clock is set right before each ``next()`` and reset before
    control returns to the caller."""
    now = datetime.datetime.now(datetime.timezone.utc)
    while True:
        token = _query_clock.set(now)
        try:
            try:
                item = next(gen)
            finally:
                _query_clock.reset(token)
        except StopIteration:
            return
        yield item


@contextlib.contextmanager
def frozen_clock_scope(at: Optional[datetime.datetime] = None):
    """Freeze the query clock for a synchronous block."""
    token = _query_clock.set(at or datetime.datetime.now(datetime.timezone.utc))
    try:
        yield
    finally:
        _query_clock.reset(token)
