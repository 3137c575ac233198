"""Out-of-core spill for the blocking sinks (port of
``daft_tpu/execution/spill.py``).

Under a memory limit (``resource_manager.memory_limit``) each blocking sink
keeps a bounded in-memory working set and spills the rest to local-disk Arrow
IPC files, streaming them back (reference: the memory-managed blocking sinks
of src/daft-local-execution, resource_manager.rs:44, and upstream Daft's TPC-H
SF1000 on 244 GB, docs/benchmarks/index.md:277-283):

* **external sort**: sorted runs, then a k-way streaming merge whose working
  set is about one head morsel per run;
* **grace aggregation**: the merged partial state is hash-partitioned by
  group key into disk buckets whenever it outgrows the budget, and each
  bucket is merged and finalised alone;
* **grace distinct / grace join**: the input (a join's build side, and for
  right / outer joins its probe side) is hash-partitioned by key into disk
  buckets and deduplicated or joined bucket by bucket.

Spilled data goes through ``distributed/partition_ref.partition_to_wire_table``
so logical types and Python-object columns survive the disk. Each file is
stamped with a digest at write and verified before it is read back
(``integrity.py``): a mismatch raises ``DaftCorruptionError``. A write or a
read that fails raises ``DaftExecutionError`` from its cause; the query never
goes on in memory instead.

The spill directory is ``root=``, else ``DAFT_SPILL_DIR``, else
``tempfile.gettempdir()``, as in the JAX package. The fault-injection hook
before each read-back (``maybe_inject``, the distributed layer's) is ROADMAP
A.8.5. ``spill_metrics`` is a shim
over the metrics registry's ``daft_spill_*_total`` series, as in the JAX
package; each spill is also attributed to the profiled operator
(``profiling.note_spill``).
"""

from __future__ import annotations

import os
import shutil
import tempfile
import threading
import uuid
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Callable, Iterator, List, Optional, Sequence

import numpy as np
import pyarrow as pa

from daft_tpu_torch.errors import DaftCorruptionError, DaftExecutionError
from daft_tpu_torch.micropartition import MicroPartition
from daft_tpu_torch.recordbatch import RecordBatch
from daft_tpu_torch.schema import Field, Schema

#: Reserved merge-state column, stripped before rows leave the merge.
_MARKER = "__daft_run_marker__"


class SpillMetrics:
    """Thin shim over the unified registry (metrics.py), as in the JAX
    package: bytes and files written and spill events live as the
    ``daft_spill_*_total`` series, so disabling the registry empties them
    too. The port's own tallies stay in process: the permit waits that
    timed out into best effort (``budget_reservation``, and the permit gates
    of ``_collect`` and of a shared subtree's cache that disengaged: each
    after a wait of 5 s), and the spill directories made since the last
    reset (:meth:`dirs`, for the audit that none remains)."""

    _SERIES = {"bytes_spilled": "daft_spill_bytes_total",
               "files": "daft_spill_files_total",
               "spills": "daft_spill_events_total"}
    _LOCAL = ("best_effort_reservations", "permit_gates_off")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._c = dict.fromkeys(self._LOCAL, 0)
        self._dirs: List[str] = []

    def record(self, nbytes: int, nfiles: int = 1) -> None:
        from daft_tpu_torch import metrics, profiling

        metrics.SPILL_BYTES.inc(nbytes)
        metrics.SPILL_FILES.inc(nfiles)
        metrics.SPILL_EVENTS.inc()
        profiling.note_spill(nbytes)

    def record_best_effort(self, key: str) -> None:
        with self._lock:
            self._c[key] += 1

    def note_dir(self, root: str) -> None:
        with self._lock:
            self._dirs.append(root)

    def reset(self) -> None:
        from daft_tpu_torch import metrics

        reg = metrics.get_registry()
        for name in self._SERIES.values():
            reg.reset(name)
        with self._lock:
            self._c = dict.fromkeys(self._LOCAL, 0)
            self._dirs = []

    def snapshot(self) -> dict:
        from daft_tpu_torch import metrics

        snap = metrics.get_registry().snapshot()
        out = {k: int(snap.counter_total(name)) for k, name in self._SERIES.items()}
        with self._lock:
            out.update(self._c)
        return out

    def dirs(self) -> List[str]:
        with self._lock:
            return list(self._dirs)


spill_metrics = SpillMetrics()


#: Seconds a sink's reservation waits for its permits before it goes on at
#: best effort (the JAX package's 5 s).
PERMIT_WAIT_S = 5.0


@contextmanager
def budget_reservation(memory, budget: int, token=None, op: str = ""):
    """Reserve a spilling sink's working set against the permit gate, so
    concurrent executors under one limit coordinate (at most limit/budget
    sinks hold reservations at once). An acquire that times out after
    ``PERMIT_WAIT_S`` degrades to best effort (counted) instead of deadlocking, as the
    reference's permits do (resource_manager.rs:44); a cancel ``token``
    wakes the wait when the query dies. ``op`` names the reservation in the
    byte ledger (kind ``permit``), charged and released with the permit."""
    ok = memory.acquire(budget, timeout=PERMIT_WAIT_S, token=token)
    if not ok:
        spill_metrics.record_best_effort("best_effort_reservations")
    ledger = None
    qid = getattr(token, "query_id", "") or ""
    if ok and op:
        from daft_tpu_torch.execution.memledger import get_ledger

        ledger = get_ledger()
        granted = budget if memory.limit is None else min(budget, memory.limit)
        ledger.charge(qid, op, granted, kind="permit")
    try:
        yield
    finally:
        if ok:
            memory.release(budget)
            if ledger is not None:
                ledger.release(qid, op, granted, kind="permit")


def sink_budget(memory_limit: Optional[int]) -> Optional[int]:
    """One blocking sink's in-memory working set under ``memory_limit``: a
    quarter of it (several sinks can be live at once: a join's build and a
    sort, two joins), floored at 64 KiB so tiny limits still make progress;
    None without a limit."""
    if memory_limit is None:
        return None
    return max(memory_limit // 4, 1 << 16)


@dataclass
class SpillFile:
    path: str
    rows: int
    nbytes: int
    schema: Schema
    #: The digest of the raw file bytes, minted at write (``integrity.py``).
    digest: str = ""


class SpillDir:
    """A directory of Arrow IPC spill files, removed at query end.

    ``query_id`` tags every written file's bytes in the byte ledger (kind
    ``spill``): a file is disk residency the query holds until
    :meth:`cleanup`, so the ledger is charged at :meth:`write` and the whole
    tally released at :meth:`cleanup`."""

    def __init__(self, root: Optional[str] = None, query_id: str = ""):
        from daft_tpu_torch.config import daft_env

        base = root or daft_env("DAFT_SPILL_DIR") or tempfile.gettempdir()
        self.root = os.path.join(base, f"daft-spill-{uuid.uuid4().hex[:8]}")
        self._created = False
        self.query_id = query_id
        self._ledger_lock = threading.Lock()
        self._ledger_charges: dict = {}  # op -> bytes charged in this directory's life

    def _ensure(self) -> None:
        if not self._created:
            os.makedirs(self.root, exist_ok=True)
            self._created = True
            spill_metrics.note_dir(self.root)

    def write(self, mp: MicroPartition, chunk_rows: int = 1 << 16, op: str = "") -> SpillFile:
        """Spill one partition to a new IPC file in chunks, so that reads
        stream."""
        from daft_tpu_torch import integrity
        from daft_tpu_torch.distributed.partition_ref import partition_to_wire_table
        from daft_tpu_torch.execution.memledger import get_ledger

        table = partition_to_wire_table(mp)
        path = os.path.join(self.root, f"{uuid.uuid4().hex[:12]}.arrow")
        try:
            self._ensure()
            with pa.OSFile(path, "wb") as f:
                with pa.ipc.new_stream(f, table.schema) as writer:
                    for start in range(0, max(table.num_rows, 1), chunk_rows):
                        chunk = table.slice(start, chunk_rows)
                        if chunk.num_rows or table.num_rows == 0:
                            writer.write_table(chunk)
            digest = integrity.hash_file(path)
        except (OSError, pa.ArrowException) as e:
            raise DaftExecutionError(f"spill write failed: {path}: {e}") from e
        if integrity.verify_on_write():
            integrity.verify_file(path, digest, "spill")
        sf = SpillFile(path, table.num_rows, table.nbytes, mp.schema, digest=digest)
        spill_metrics.record(table.nbytes, 1)
        ledger = get_ledger()
        if ledger.enabled and table.nbytes:
            with self._ledger_lock:
                self._ledger_charges[op] = self._ledger_charges.get(op, 0) + table.nbytes
            ledger.charge(self.query_id, op, table.nbytes, kind="spill")
        return sf

    def stream(self, sf: SpillFile) -> Iterator[RecordBatch]:
        """Stream a spill file back a batch at a time (bounded memory). The
        raw bytes are verified against the digest minted at write before
        anything decodes them: a mismatch quarantines the file and raises
        ``DaftCorruptionError``."""
        from daft_tpu_torch import integrity
        from daft_tpu_torch.distributed.partition_ref import partition_from_wire_table

        try:
            integrity.verify_file(sf.path, sf.digest, "spill")
            with pa.OSFile(sf.path, "rb") as f:
                with pa.ipc.open_stream(f) as reader:
                    for batch in reader:
                        if batch.num_rows == 0:
                            continue
                        mp = partition_from_wire_table(pa.Table.from_batches([batch]),
                                                       sf.schema)
                        yield mp.combined()
        except DaftCorruptionError:
            raise
        except (OSError, pa.ArrowException) as e:
            raise DaftExecutionError(f"spill read failed: {sf.path}: {e}") from e

    def read_all(self, files: Sequence[SpillFile]) -> Optional[MicroPartition]:
        batches: List[RecordBatch] = []
        schema = None
        for sf in files:
            schema = sf.schema
            batches.extend(self.stream(sf))
        if schema is None:
            return None
        return MicroPartition(schema, batches)

    def cleanup(self) -> None:
        if self._created:
            shutil.rmtree(self.root, ignore_errors=True)
            self._created = False
        # Spill residency ends with the files: release the whole tally
        # (idempotent: the dict empties on the first pass).
        with self._ledger_lock:
            charges, self._ledger_charges = self._ledger_charges, {}
        if charges:
            from daft_tpu_torch.execution.memledger import get_ledger

            ledger = get_ledger()
            for op, nbytes in charges.items():
                ledger.release(self.query_id, op, nbytes, kind="spill")


# -- external sort ----------------------------------------------------------
class ExternalSort:
    """Run generation and a k-way merge.

    ``add`` buffers morsels up to the budget; each overflow sorts the buffer
    into a run and spills it. ``results`` merges the runs with a streaming
    k-way merge whose working set is about one head morsel per run
    (reference: the Sort blocking sink, src/daft-local-execution/src/sinks/
    sort.rs)."""

    def __init__(self, sort_by, descending, nulls_first, schema: Schema, budget: int,
                 spill: SpillDir, morsel_rows: int = 1 << 16, op: str = "Sort"):
        self.sort_by = sort_by
        self.descending = descending
        self.nulls_first = nulls_first
        self.schema = schema
        self.budget = budget
        self.spill = spill
        self.morsel_rows = morsel_rows
        self.op = op  # the byte ledger's name for this sink's runs
        self._buf: List[MicroPartition] = []
        self._buf_bytes = 0
        self._runs: List[SpillFile] = []

    def _sort_mp(self, mp: MicroPartition) -> MicroPartition:
        return mp.sort(self.sort_by, self.descending, self.nulls_first)

    def add(self, mp: MicroPartition) -> None:
        self._buf.append(mp)
        self._buf_bytes += mp.size_bytes()
        if self._buf_bytes >= self.budget:
            self._flush_run()

    def _flush_run(self) -> None:
        if not self._buf:
            return
        run = self._sort_mp(MicroPartition.concat(self._buf))
        self._runs.append(self.spill.write(run, chunk_rows=self.morsel_rows, op=self.op))
        self._buf = []
        self._buf_bytes = 0

    def results(self) -> Iterator[MicroPartition]:
        if not self._runs:
            # Everything fitted: one sort in memory.
            if not self._buf:
                yield MicroPartition.empty(self.schema)
                return
            yield self._sort_mp(MicroPartition.concat(self._buf))
            return
        self._flush_run()
        run_iters = [self.spill.stream(sf) for sf in self._runs]
        for rb in _merge_sorted_runs(run_iters, self.sort_by, self.descending,
                                     self.nulls_first, self.morsel_rows):
            yield MicroPartition(self.schema, [rb])


def _merge_sorted_runs(run_iters: List[Iterator[RecordBatch]], sort_by, descending,
                       nulls_first, morsel_rows: int) -> Iterator[RecordBatch]:
    """K-way merge of sorted runs in bounded memory.

    Invariant: ``pending`` is a sorted working batch with a marker column
    that flags, for each live run, exactly one row: that run's last-pulled
    row. Every unread row of run *i* sorts at or after run *i*'s marker row,
    so everything up to the FIRST marker row (inclusive) is final and can be
    emitted. The marked run then refills, and the working set stays at about
    k head morsels whatever the total size."""
    from daft_tpu_torch.expressions.evaluator import evaluate
    from daft_tpu_torch.series import Series

    live = dict(enumerate(run_iters))
    need_pull = set(live)
    pending: Optional[RecordBatch] = None

    def with_marker(rb: RecordBatch, run_id: int) -> RecordBatch:
        marker = np.full(len(rb), -1, dtype=np.int64)
        marker[-1] = run_id
        cols = rb.columns() + [Series.from_numpy(marker, _MARKER)]
        return RecordBatch(Schema([Field(c.name, c.dtype) for c in cols]), cols, len(rb))

    def sort_working(rb: RecordBatch) -> RecordBatch:
        keys = [evaluate(e, rb) for e in sort_by]
        return rb.sort(keys, descending, nulls_first)

    def try_fast_merge(p: RecordBatch, f: RecordBatch) -> Optional[RecordBatch]:
        """O(n+m) positional merge of two sorted batches in the common case
        (one ascending numeric key without nulls or NaN): the steady-state
        refill would otherwise re-sort the working set per pulled batch."""
        if len(sort_by) != 1 or (descending and descending[0]):
            return None
        vp, mp = evaluate(sort_by[0], p).to_numpy_masked()
        vf, mf = evaluate(sort_by[0], f).to_numpy_masked()
        if (mp is not None and mp.any()) or (mf is not None and mf.any()):
            return None
        if vp.dtype.kind not in "iuf" or vf.dtype.kind not in "iuf":
            return None
        if vp.dtype.kind == "f" and (np.isnan(vp).any() or np.isnan(vf).any()):
            return None
        n, m = len(p), len(f)
        idx = np.empty(n + m, dtype=np.uint64)
        idx[np.arange(n) + np.searchsorted(vf, vp, side="left")] = np.arange(n, dtype=np.uint64)
        idx[np.arange(m) + np.searchsorted(vp, vf, side="right")] = \
            np.arange(m, dtype=np.uint64) + n
        return RecordBatch.concat([p, f]).take(idx)

    def strip_marker(rb: RecordBatch) -> RecordBatch:
        cols = [c for c in rb.columns() if c.name != _MARKER]
        return RecordBatch(Schema([Field(c.name, c.dtype) for c in cols]), cols, len(rb))

    def emit(rb: RecordBatch) -> Iterator[RecordBatch]:
        for start in range(0, len(rb), morsel_rows):
            yield strip_marker(rb.slice(start, morsel_rows))

    while live or (pending is not None and len(pending)):
        fresh: List[RecordBatch] = []
        for run_id in sorted(need_pull):
            it = live.get(run_id)
            if it is None:
                continue
            batch = next(it, None)
            while batch is not None and len(batch) == 0:
                batch = next(it, None)
            if batch is None:
                del live[run_id]
            else:
                fresh.append(with_marker(batch, run_id))
        need_pull = set()
        parts = ([pending] if pending is not None and len(pending) else []) + fresh
        if not parts:
            break
        working = None
        if len(parts) == 2 and parts[0] is pending:
            working = try_fast_merge(parts[0], parts[1])
        if working is None:
            working = sort_working(RecordBatch.concat(parts))
        if not live:
            yield from emit(working)
            return
        markers = np.asarray(working.get_column(_MARKER).to_numpy(), dtype=np.int64)
        # Every live run has exactly one marker row in the working set.
        cut = int(np.flatnonzero(markers >= 0)[0])
        refill_run = int(markers[cut])
        yield from emit(working.slice(0, cut + 1))
        pending = working.slice(cut + 1)
        need_pull = {refill_run}


# -- grace hash partitioning (aggregation, distinct and join buckets) --------
class GracePartitioner:
    """Streams record batches into ``num_buckets`` disk buckets by key hash.

    Small per-bucket write buffers coalesce morsel fragments, so each bucket
    becomes a few sequential IPC files rather than one per input morsel (the
    reference's shuffle cache batches to a 4 MiB chunk target,
    src/daft-shuffles/src/shuffle_cache.rs:30)."""

    BUFFER_BYTES = 4 * 1024 * 1024

    def __init__(self, key_fn: Callable[[RecordBatch], List], num_buckets: int,
                 spill: SpillDir, total_buffer_bytes: Optional[int] = None, op: str = ""):
        self.key_fn = key_fn  # rb -> key Series list
        self.num_buckets = num_buckets
        self.spill = spill
        self.op = op  # the byte ledger's name for this sink's buckets
        # The COLLECTIVE pending cap keeps the partitioner inside the sink
        # budget (32 buckets x 4 MiB alone would allow 128 MiB resident); when
        # it trips, the fullest bucket flushes.
        self.total_cap = total_buffer_bytes or self.BUFFER_BYTES * 4
        self.buckets: List[List[SpillFile]] = [[] for _ in range(num_buckets)]
        self._pend: List[List[RecordBatch]] = [[] for _ in range(num_buckets)]
        self._pend_bytes = [0] * num_buckets
        self._pend_total = 0

    def add(self, rb: RecordBatch) -> None:
        if len(rb) == 0:
            return
        parts = rb.partition_by_hash(self.key_fn(rb), self.num_buckets)
        for b, part in enumerate(parts):
            if len(part) == 0:
                continue
            nbytes = part.size_bytes()
            self._pend[b].append(part)
            self._pend_bytes[b] += nbytes
            self._pend_total += nbytes
            if self._pend_bytes[b] >= self.BUFFER_BYTES:
                self._flush(b)
        while self._pend_total > self.total_cap:
            fullest = max(range(self.num_buckets), key=lambda i: self._pend_bytes[i])
            if self._pend_bytes[fullest] == 0:
                break
            self._flush(fullest)

    def _flush(self, b: int) -> None:
        if not self._pend[b]:
            return
        rb = RecordBatch.concat(self._pend[b])
        self.buckets[b].append(self.spill.write(MicroPartition(rb.schema, [rb]), op=self.op))
        self._pend_total -= self._pend_bytes[b]
        self._pend[b] = []
        self._pend_bytes[b] = 0

    def finish(self) -> List[List[SpillFile]]:
        for b in range(self.num_buckets):
            self._flush(b)
        return self.buckets

    def read_bucket(self, b: int) -> Optional[MicroPartition]:
        return self.spill.read_all(self.buckets[b])

    def stream_bucket(self, b: int) -> Iterator[RecordBatch]:
        """Stream one bucket back a batch at a time (bounded memory): a
        consumer that folds as it reads (aggregation, distinct, a join's
        probe side) never holds a skewed bucket whole."""
        for sf in self.buckets[b]:
            yield from self.spill.stream(sf)
