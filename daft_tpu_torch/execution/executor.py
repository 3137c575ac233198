"""Local execution engine (port of ``daft_tpu/execution/executor.py``).

Runs a physical plan as a pull chain of operator generators, yielding result
MicroPartitions in input order, with the streaming operators as stages on ONE
shared compute pool of ``num_compute_threads`` workers (one per core by
default; ``execution/pipeline.py``). The port has these operators:

* ``InMemorySource`` — yields the materialised partitions;
* ``PhysicalScan`` — reads its scan tasks (``io/formats.read_scan_task``):
  one task inline on the pulling thread; several at once on an IO pool of
  ``NUM_IO_THREADS`` threads (``daft-scan*``, 8 as in the JAX executor), each
  task into a bounded queue of 4 morsels, yielded in task order. The readers
  run in a copy of the caller's context (so they see the query's cancel
  token), a stop flag releases them when the consumer goes away, and a
  reader's error reaches the caller as ``DaftExecutionError("Scan failed:
  ...")`` from its cause. A pushed-down filter runs on the IO threads, on the
  host, as in the JAX package;
* ``Project`` / ``Filter`` — the maximal Project/Filter chain below a node runs
  as one stage (``map_stage``) over ``morselize``d input (morsels of
  ``MIN_MORSEL_ROWS`` .. ``default_morsel_size`` rows); the longest suffix of
  the chain that the device can run whole runs as ONE program per morsel
  (``ops/compiled_eval.ChainSpec``), the rest step by step, where each
  projection's numeric subtrees may still run on the device
  (``ops/device_eval``);
* ``UDFProject`` — a UDF with a ``batch_size`` gets morsels of
  ``min(batch_size * 16, default_morsel_size)`` rows (16 device batches: enough
  chunks for the provider to overlap the copy of one with the forward of
  another, with a bounded host window); one without follows the
  latency-constrained dynamic batching (``execution/dynamic_batching.py``)
  unless ``udf_dynamic_batching=False``. ``max_concurrency > 1`` evaluates that
  many morsels at once, in order, on a pool of the UDF's own;
* ``Aggregate`` — partial aggregation per chunk of ``AGG_CHUNK_ROWS``+ rows,
  the chunks' partials on the pool and merged in chunk order. A global one
  absorbs the Project/Filter chain below it: the chain and the partial
  aggregation run as one program per chunk
  (``ops/compiled_eval.AggChainSpec``). A grouped one leaves the chain as its
  own stage and aggregates through Acero on the host, the aggregations'
  children too, as the JAX package does; the first morsel's group reduction
  picks the route: merge the chunks' partials, or, above
  ``high_cardinality_aggregation_threshold``, hash-partition the rows into
  ``num_compute_threads`` buckets on the pool and aggregate each bucket once,
  the buckets at once (``collect_parallel``);
* ``Limit`` — offset/limit over the stream, closing its input early;
* ``Sort`` / ``Distinct`` — collect the input, then one Arrow sort (stable)
  or a per-morsel then whole-input dedupe; ``TopN`` keeps a buffer trimmed
  to the first ``limit + offset`` rows whenever it passes four times that;
* ``HashJoin`` — collects the build (right) side while a ``Prefetch`` thread
  warms the probe (left) side's stages; for inner / left / semi / anti joins
  it builds a ``JoinIndex`` over the build side once where the keys allow
  and probes ``morselize``d morsels of the left side against it on the pool,
  in input order, or else joins each probe morsel through Arrow's Acero;
  right and outer joins collect both sides and join them once through Acero.
  ``join_index.join_counters`` records each join's route and rows;
* ``AsofJoin`` / ``CrossJoin`` — collect the right side, stream the left;
  ``Concat`` — its children's streams one after another;
* ``Write`` — streams its input into the writer (``io/writers.make_writer``)
  and yields one row per written file; under ``write_mode="overwrite"`` it
  then deletes every other file under the root directory;
* ``Explode`` / ``Unpivot`` / ``Sample`` (by fraction) /
  ``MonotonicallyIncreasingId`` — per morsel, in input order; ``Sample`` by
  size and ``Pivot`` collect their input first;
* ``Window`` — collects its input and evaluates the window expressions
  (``execution/window_eval.py``) in linear work;
* ``Repartition`` — hash, random, into and range_bound: collects its input
  and yields the parts, every part even an empty one.

Joins, sorts and dedupes run on the host, as in the JAX package; the
Project/Filter chains on each side of them still run on the device, each
pool worker on a CUDA stream of its own.

Memory: the blocking sinks take byte permits from the process
``MemoryManager`` (``execution/resource_manager.py``) for what they buffer
(``_collect``; a shared subtree's cached morsels too), and every byte the
executor holds is charged to the query in the byte ledger
(``execution/memledger.py``): permits, the stages' queues, spill files.
Under a memory limit (``memory_limit()``) each blocking sink works within
``sink_budget`` (a quarter of the limit) under a ``budget_reservation`` and
spills the rest (``execution/spill.py``), as the JAX package routes it:

* ``Sort`` — an external sort (sorted runs, k-way merge);
* ``Aggregate`` — a global one compresses its state in place (no chain
  absorption); a grouped one accumulates serially and, past the budget,
  hash-partitions its merged state into ``GRACE_BUCKETS`` disk buckets,
  each then merged and finalised alone;
* ``Distinct`` — per-morsel dedupe, then past the budget grace buckets;
* ``Window`` — when every window partitions by the same keys, the input
  buffers until the budget, then goes to grace buckets by those keys, each
  bucket evaluated alone (a window of no partition keys collects);
* ``Repartition`` by hash — buffers until the budget, then streams into one
  disk bucket per output partition (every bucket yields, an empty one too);
* ``HashJoin`` — no probe-side prefetch; each side in memory or, past the
  budget, in grace buckets by its unified key; per bucket an inner / left /
  semi / anti join streams the probe bucket against the build bucket, and a
  right / outer join materialises both (``join_counters`` route ``grace``).

A failure poisons the manager's current waiters of this query (an early
close does not); on every exit of ``run`` the executor closes its operator
iterators, removes its spill directory and returns its held permits and
their ledger charges at once, so a late acquire on a side thread hands its
permit straight back (``_add_held``).

The determinism contract of ``pipeline.py`` holds: morsel, chunk and bucket
boundaries are pure functions of the input, so results are the same bytes at
``num_compute_threads=1`` (every stage serial on the calling thread) and at
any other count; ordered stages keep input order unless
``default_maintain_order=False``. A worker's error reaches the caller as
raised, never retried. The query's cancel token is observed at every morsel
boundary (``_cancel_checked`` around each operator's stream, and each worker
before its morsel); on every exit of ``run`` the pool is shut down and every
operator iterator closed, which releases the feeders.

Not ported yet: the feedback plane with its join bucket counts and
estimate-driven early spill (off by default in the JAX package), the
distributed nodes (two-phase aggregation, sort sampling, shuffle reads) and
the ``shard`` repartition (A.8), replica slots for ``chips_per_replica`` (A.10),
and the scan-output cache tier in front of the scan
(``daft_tpu/execution/executor.py:527-574``, ``plancache``, A.8).

Observability, as in the JAX executor: with ``stats`` (a ``RuntimeStats``)
every operator's stream counts its morsels and rows in the metrics registry
(``daft_executor_morsels_total`` / ``_rows_total``) and its rows and
exclusive CPU time in the stats (``_instrumented``); with ``profiler`` (a
``profiling.TaskProfiler``) every operator's stream runs inside one span
keyed by plan node (``Filter#2``, numbered in the order the pulls first meet
the nodes: ``_profiled``), a fused chain's members get spans of their own
(``_member_frames``), and each stage times its work on the worker that does
it (``timer=``, the node's ``_OpFrame``). Neither changes a route, a morsel
boundary or an order.

Plans are DAGs: a decorrelated subquery references one subtree from several
parents. A node that more than one parent references
(``physical/plan.shared_subtree_ids``) runs ONCE per query: the first puller
materialises its output under a per-node fill event while any other puller
(the join's prefetch thread among them) waits for it, a failed fill clears
its slot so the next puller fills again, and the Project/Filter chains and
the global aggregation's chain absorption stop at it. ``shared_fills``
counts the fills per node id and ``shared_hits`` the pulls served from the
cache. The cached morsels are held under memory permits until the query
ends (``SharedSubtree`` in the byte ledger).
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import os
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional

import numpy as np

from daft_tpu_torch.cancellation import CancelToken
from daft_tpu_torch.context import ExecutionConfig
from daft_tpu_torch.datatype import unify_dtypes
from daft_tpu_torch.errors import DaftExecutionError, DaftPlanError
from daft_tpu_torch.execution.aggregation import AggState
from daft_tpu_torch.execution.join_index import JoinIndex, _key_values, join_counters
from daft_tpu_torch.execution.memledger import get_ledger
from daft_tpu_torch.execution.resource_manager import get_memory_manager
from daft_tpu_torch.execution.spill import (
    ExternalSort,
    GracePartitioner,
    SpillDir,
    budget_reservation,
    sink_budget,
    spill_metrics,
)
from daft_tpu_torch.execution.dynamic_batching import LatencyConstrainedBatching, dynamic_remorsel
from daft_tpu_torch.execution.pipeline import (
    DEFAULT_MIN_MORSEL_ROWS,
    Prefetch,
    chunk_morsels,
    collect_parallel,
    map_stage,
    morselize,
    run_stage,
    split_morsels,
)
from daft_tpu_torch.expressions.evaluator import evaluate
from daft_tpu_torch.expressions.expr import UdfCall
from daft_tpu_torch.micropartition import MicroPartition
from daft_tpu_torch.ops import compiled_eval
from daft_tpu_torch.ops.device_eval import device_eval_counters
from daft_tpu_torch.parallel.replica import ReplicaSlots
from daft_tpu_torch.physical import plan as pp
from daft_tpu_torch.recordbatch import RecordBatch
from daft_tpu_torch.schema import Field, Schema
from daft_tpu_torch.series import Series


_SENTINEL = object()


class Executor:
    """Runs a local physical plan, yielding result MicroPartitions."""

    #: Rows per partial-aggregation chunk. FIXED, so the association of the
    #: float partial sums depends only on the input stream.
    AGG_CHUNK_ROWS = 256 * 1024
    #: Morsels smaller than this merge before a Project/Filter/Aggregate stage
    #: (the JAX package's default ``min_morsel_size``).
    MIN_MORSEL_ROWS = DEFAULT_MIN_MORSEL_ROWS
    #: How long ``run``'s cleanup waits for an operator iterator that another
    #: thread is inside of (a feeder finishing its last pull) before it stops
    #: trying to close it.
    CLOSE_WAIT_S = 10.0
    #: Threads of a scan's IO pool (the JAX executor's default).
    NUM_IO_THREADS = 8
    #: Disk buckets of a grace aggregation, distinct or join.
    GRACE_BUCKETS = 32
    #: Seconds a blocking sink waits for a permit before its gate disengages.
    PERMIT_WAIT_S = 5.0

    def __init__(self, cfg: ExecutionConfig, cancel_token: Optional[CancelToken] = None,
                 stats=None, profiler=None):
        self.cfg = cfg
        self.cancel_token = cancel_token
        self.stats = stats  # RuntimeStats | None
        # Query profiler (profiling.TaskProfiler | None): when present, every
        # operator's morsel loop runs inside a span keyed by plan-node id.
        # None is the unprofiled fast path: no per-morsel cost.
        self.profiler = profiler
        self._profile_node_ids: Dict[int, int] = {}
        # Live _OpFrame per plan node while its span is open: stages hand it
        # to their workers, so per-morsel wall/CPU is measured on the worker
        # and aggregated into the ONE span of that plan node.
        self._op_frames: Dict[int, object] = {}
        # Per-THREAD pull-chain stack for _instrumented's exclusive CPU time:
        # nested frames run in different feeder threads.
        self._op_stacks = threading.local()
        self.max_morsel_rows = cfg.default_morsel_size
        self.min_morsel_rows = min(self.MIN_MORSEL_ROWS, self.max_morsel_rows)
        n = cfg.num_compute_threads
        self.compute_threads = n if n > 0 else (os.cpu_count() or 1)
        self._state_lock = threading.Lock()
        self._compute_pool: Optional[ThreadPoolExecutor] = None
        self._live_iters: List = []
        self._shared_ids: set = set()
        self._shared_cache: dict = {}
        self.shared_fills: Dict[int, int] = {}
        self.shared_hits: Dict[int, int] = {}
        self.memory = get_memory_manager()
        # Permits this executor holds, in all and per operator: the teardown
        # releases exactly what it charged (two executors may share a query
        # id).
        self._held_bytes = 0
        self._held_by_op: Dict[str, int] = {}
        # Set under _state_lock once run()'s teardown has returned the held
        # permits: a side thread whose acquire succeeded just as the query
        # unwound hands its permit straight back (_add_held).
        self._permits_closed = False
        self._ledger = get_ledger()
        self._ledger_qid = getattr(cancel_token, "query_id", "") \
            or (stats.query_id if stats is not None else "") or ""
        self._spill_dir: Optional[SpillDir] = None

    def _spill(self) -> SpillDir:
        """The query's spill directory, made on first use and removed when
        ``run`` ends."""
        with self._state_lock:
            if self._spill_dir is None:
                self._spill_dir = SpillDir(query_id=self._ledger_qid)
            return self._spill_dir

    def _stage_ledger(self, op: str) -> Optional[tuple]:
        """The ``(query_id, operator)`` tag a stage charges its queue's
        residency under; None when the ledger is off."""
        return (self._ledger_qid, op) if self._ledger.enabled else None

    def _sink_budget(self) -> Optional[int]:
        """One blocking sink's working set; None without a memory limit."""
        return sink_budget(self.memory.limit)

    def _pool(self) -> Optional[ThreadPoolExecutor]:
        """The executor-wide compute pool, shared by every stage so stacked
        operators compete for ``compute_threads`` workers instead of each
        spawning a pool; None when the stages run serially. Made on first
        use, which may be on a feeder thread."""
        if self.compute_threads <= 1:
            return None
        with self._state_lock:
            if self._compute_pool is None:
                self._compute_pool = ThreadPoolExecutor(
                    max_workers=self.compute_threads, thread_name_prefix="daft-compute")
            return self._compute_pool

    def run(self, plan: pp.PhysicalPlan) -> Iterator[MicroPartition]:
        self._shared_ids = pp.shared_subtree_ids(plan)
        with self._state_lock:
            self._shared_cache = {}
            self.shared_fills, self.shared_hits = {}, {}
            self._permits_closed = False  # executors are re-runnable
        try:
            yield from self._run(plan)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            # A sink thread still blocked in a permit wait would sleep until
            # its timeout: poison wakes this query's current waiters with the
            # failure. GeneratorExit is an early close (a limit, an abandoned
            # iteration), never a poison.
            if not isinstance(e, GeneratorExit):
                self.memory.poison(e, query_id=self._ledger_qid or None)
            raise
        finally:
            self._shutdown()
            with self._state_lock:
                self._shared_cache = {}
                spill, self._spill_dir = self._spill_dir, None
            if spill is not None:
                spill.cleanup()
            # Close the permit window ATOMICALLY with reading the held total:
            # an acquire that lands after this point releases itself in
            # _add_held instead of adding to a drained counter.
            with self._state_lock:
                held, self._held_bytes = self._held_bytes, 0
                by_op, self._held_by_op = self._held_by_op, {}
                self._permits_closed = True
            if held:
                self.memory.release(held)
            for op, nbytes in by_op.items():
                self._ledger.release(self._ledger_qid, op, nbytes, kind="permit")
            if self.stats is not None:
                self.stats.flush()

    def _add_held(self, nbytes: int, op: str = "") -> None:
        """Book a granted permit of ``nbytes`` to ``op`` (and charge it in
        the ledger); after the teardown, hand it straight back instead."""
        with self._state_lock:
            if not self._permits_closed:
                self._held_bytes += nbytes
                self._held_by_op[op] = self._held_by_op.get(op, 0) + nbytes
                self._ledger.charge(self._ledger_qid, op, nbytes, kind="permit")
                return
        # The query already unwound and released its held total: this
        # acquire raced the teardown. The ledger was never charged.
        self.memory.release(nbytes)

    def _shutdown(self) -> None:
        """On every exit of ``run``: stop the pool (a later submit raises,
        which unwinds any feeder still pulling), then close every operator
        iterator, children first, so each stage's stop flag releases its
        feeder. An iterator another thread is inside of cannot be closed yet;
        it is tried again until that thread has left it."""
        with self._state_lock:
            pool = self._compute_pool
            live, self._live_iters = list(self._live_iters), []
        if pool is not None:
            pool.shutdown(wait=False, cancel_futures=True)
        deadline = time.monotonic() + self.CLOSE_WAIT_S
        while live:
            busy = []
            for g in reversed(live):
                try:
                    g.close()
                except ValueError:  # "generator already executing" on a feeder
                    busy.append(g)
            if not busy or time.monotonic() > deadline:
                return
            live = list(reversed(busy))
            time.sleep(0.005)

    def _run(self, node: pp.PhysicalPlan) -> Iterator[MicroPartition]:
        if id(node) in self._shared_ids:
            return iter(self._shared_subtree(node))
        return self._run_uncached(node)

    def _shared_subtree(self, node: pp.PhysicalPlan) -> List[MicroPartition]:
        """Materialise a shared subtree exactly once, even when a join's
        prefetch thread races the main pull chain for it. Coordination is a
        per-node fill event; the lock is held only for bookkeeping, never
        across the fill, so a fill that reaches another shared node cannot
        deadlock (fills follow the acyclic plan DAG)."""
        key = id(node)
        while True:
            with self._state_lock:
                entry = self._shared_cache.get(key)
                if entry is None:
                    evt = threading.Event()
                    self._shared_cache[key] = ("filling", evt)
                    self.shared_fills[key] = self.shared_fills.get(key, 0) + 1
                    break
                if entry[0] == "done":
                    self.shared_hits[key] = self.shared_hits.get(key, 0) + 1
                    return entry[1]
                waiting = entry[1]
            waiting.wait()
            # Loop: a failed filler clears the slot, and the next puller
            # fills instead of waiting on a stale marker.
        try:
            cached: List[MicroPartition] = []
            gate_on = True
            for mp in self._run_uncached(node):
                # The pinned output is buffered state, held under permits
                # until the query ends. As in _collect, the only releaser is
                # this executor at query end, so a failed acquire disengages
                # the gate instead of waiting again.
                if gate_on:
                    nbytes = mp.size_bytes()
                    if self.memory.acquire(nbytes, timeout=self.PERMIT_WAIT_S,
                                           token=self.cancel_token):
                        limit = self.memory.limit
                        # What acquire granted (it clamps to the limit), so
                        # the release is byte-symmetric with the grant.
                        self._add_held(nbytes if limit is None else min(nbytes, limit),
                                       op="SharedSubtree")
                    else:
                        gate_on = False
                        spill_metrics.record_best_effort("permit_gates_off")
                cached.append(mp)
        except BaseException:
            with self._state_lock:
                self._shared_cache.pop(key, None)
            evt.set()
            raise
        with self._state_lock:
            self._shared_cache[key] = ("done", cached)
        evt.set()
        return cached

    def _run_uncached(self, node: pp.PhysicalPlan) -> Iterator[MicroPartition]:
        handler = getattr(self, f"_run_{type(node).__name__}", None)
        if handler is None:
            raise DaftPlanError(f"No executor for physical node {node.name()}")
        it = self._track(handler(node))
        if self.cancel_token is not None:
            it = self._track(self._cancel_checked(node.name(), it))
        if self.profiler is not None:
            it = self._track(self._profiled(node, it))
        if self.stats is None:
            return it
        return self._track(self._instrumented(node.name(), it))

    def _track(self, it):
        """Register an operator iterator for ``_shutdown`` to close."""
        with self._state_lock:
            self._live_iters.append(it)
        return it

    def _cancel_checked(self, op: str, it: Iterator[MicroPartition]) -> Iterator[MicroPartition]:
        """Observe the query's cancel token at every morsel boundary: a
        cancelled or expired query fails out of the pull chain at the next
        morsel instead of running the plan to its end."""
        token = self.cancel_token
        for mp in it:
            token.check(op)
            yield mp

    def _profiled(self, node: pp.PhysicalPlan,
                  it: Iterator[MicroPartition]) -> Iterator[MicroPartition]:
        """One profiler span per operator iterator (profiling.py): wall and
        thread-CPU time per pull, rows/bytes out per morsel, plus spill /
        permit-wait / device-path tallies attributed through the ambient
        frame stack. The span opens at the FIRST pull and closes on
        exhaustion or abandonment (a limit's early close exits the context
        manager, so abandoned operators still export)."""
        prof = self.profiler
        op = type(node).__name__
        # Locked: first pulls race across the prefetch and feeder threads,
        # and an unguarded read-then-write could give two nodes one number.
        with self._state_lock:
            seq = self._profile_node_ids.setdefault(id(node), len(self._profile_node_ids))
        with prof.operator_span(op, f"{op}#{seq}") as frame:
            # Published for the node's stage workers: a pipelined operator
            # times its per-morsel work AT THE WORKER (run_timed), and the
            # consumer-side pull timing below becomes wait attribution.
            self._op_frames[id(node)] = frame
            try:
                while True:
                    frame.begin_pull()
                    try:
                        mp = next(it)
                    except StopIteration:
                        return
                    finally:
                        frame.end_pull()
                    frame.add_output(len(mp), mp)
                    yield mp
            finally:
                self._op_frames.pop(id(node), None)

    def _instrumented(self, op: str, it: Iterator[MicroPartition]) -> Iterator[MicroPartition]:
        """Per-operator counters with EXCLUSIVE cpu attribution: each level
        subtracts its inclusive time from its parent (the op stack tracks the
        current pull chain, per thread), so summing operator cpu ~= query cpu
        on a serial chain; with parallel stages each thread's chain is
        attributed independently."""
        from daft_tpu_torch import metrics

        # Children resolved ONCE per operator iterator, not per morsel: the
        # hot loop pays one method call + one lock-cheap add.
        morsels = metrics.MORSELS.labels(op)
        morsel_rows = metrics.MORSEL_ROWS.labels(op)
        record = self.stats.record_pull
        stack = getattr(self._op_stacks, "stack", None)
        if stack is None:
            stack = self._op_stacks.stack = []
        while True:
            t0 = time.perf_counter_ns()
            # Unique frame entry: identity-checked pop, so adjacent operators
            # of one name (Project over Project) can never double-pop.
            entry = (object(), op)
            stack.append(entry)
            try:
                mp = next(it)
            except StopIteration:
                return
            finally:
                if stack and stack[-1] is entry:
                    stack.pop()
            dt = time.perf_counter_ns() - t0
            rows = len(mp)
            morsels.inc()
            morsel_rows.inc(rows)
            # The parent's timed region includes ours: remove the double
            # count and credit it with the rows flowing in.
            record(op, stack[-1][1] if stack else None, rows, dt)
            yield mp

    def _stage_frame(self, node):
        """The node's live profiler _OpFrame (None when unprofiled): the
        worker-side timing hook the stages pass as ``timer=``."""
        return self._op_frames.get(id(node))

    def _node_timed(self, node, fn, *args):
        """Run a sink-side kernel (a partial merge, a finalize) under the
        node's frame, so its work is attributed though it runs outside the
        stage workers."""
        frame = self._stage_frame(node)
        if frame is None:
            return fn(*args)
        return frame.run_timed(lambda _: fn(*args), None)

    def _member_frames(self, stack, members) -> Dict[int, object]:
        """Open one profiler span per fused member node for the stage's
        lifetime, so a fused chain stays attributable per plan node: its
        interpreted kernels time under their own node's frame, and every
        fused-away operator still exports a span."""
        frames: Dict[int, object] = {}
        if self.profiler is None:
            return frames
        for nd in members:
            op = type(nd).__name__
            with self._state_lock:
                seq = self._profile_node_ids.setdefault(id(nd), len(self._profile_node_ids))
            frames[id(nd)] = stack.enter_context(self.profiler.operator_span(op, f"{op}#{seq}"))
        return frames

    @staticmethod
    def _member_step(frames, nd, kern, mp: MicroPartition) -> MicroPartition:
        """One fused member's kernel, timed under the member's own frame,
        which also counts the member's output (there is no consumer-side
        pull of a fused-away node)."""
        frame = frames.get(id(nd))
        if frame is None:
            return kern(mp)
        out = frame.run_timed(kern, mp)
        frame.add_worker_output(len(out), out)
        return out

    def _streaming_map(self, fn, source: Iterator[MicroPartition], *, name: str,
                       split: bool = True, node=None) -> Iterator[MicroPartition]:
        """A per-morsel map as one stage on the compute pool. ``split``
        morselizes the input first (at every thread count, so the morsels,
        and everything keyed on them, are the same at 1 and N threads).
        Ordered unless ``default_maintain_order=False``. Each morsel is
        timed under ``node``'s profiler frame, when there is one."""
        if split:
            source = morselize(source, self.min_morsel_rows, self.max_morsel_rows)
        yield from map_stage(source, fn, pool=self._pool(), workers=self.compute_threads,
                             name=name, ordered=self.cfg.default_maintain_order,
                             timer=None if node is None else self._stage_frame(node),
                             ledger=self._stage_ledger(name))

    def _run_InMemorySource(self, node: pp.InMemorySource) -> Iterator[MicroPartition]:
        yield from node.partitions

    def _run_PhysicalScan(self, node: pp.PhysicalScan) -> Iterator[MicroPartition]:
        from daft_tpu_torch.io.formats import read_scan_task

        tasks = node.scan_tasks
        if not tasks:
            yield MicroPartition.empty(node.schema)
            return
        morsel_rows = self.cfg.default_morsel_size
        if len(tasks) == 1:
            yield from read_scan_task(tasks[0], morsel_rows)
            return
        # Parallel prefetch with per-task bounded queues; yield in task order.
        # Readers poll a stop flag so an abandoned consumer (error in another
        # task, early generator close) cannot leave them blocked on a full
        # queue.
        queues: List[queue.Queue] = [queue.Queue(maxsize=4) for _ in tasks]
        stop = threading.Event()
        pool = ThreadPoolExecutor(max_workers=min(self.NUM_IO_THREADS, len(tasks)),
                                  thread_name_prefix="daft-scan")

        def put_or_stop(q, item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def reader(task, q):
            try:
                for mp in read_scan_task(task, morsel_rows):
                    if not put_or_stop(q, mp):
                        return
                put_or_stop(q, _SENTINEL)
            except BaseException as e:  # noqa: BLE001
                put_or_stop(q, e)

        # Reader threads inherit the caller's contextvars (the query's cancel
        # token): a bare pool task starts with an empty context.
        ambient = contextvars.copy_context()
        try:
            for task, q in zip(tasks, queues):
                pool.submit(ambient.copy().run, reader, task, q)
            for q in queues:
                while True:
                    item = q.get()
                    if item is _SENTINEL:
                        break
                    if isinstance(item, BaseException):
                        raise DaftExecutionError(f"Scan failed: {item}") from item
                    yield item
        finally:
            stop.set()
            pool.shutdown(wait=False, cancel_futures=True)

    def _run_Project(self, node: pp.Project) -> Iterator[MicroPartition]:
        yield from self._run_relational_chain(node)

    def _run_Filter(self, node: pp.Filter) -> Iterator[MicroPartition]:
        yield from self._run_relational_chain(node)

    # -- stage + kernel fusion -------------------------------------------
    @staticmethod
    def _node_kernel(nd):
        """The interpreted per-morsel kernel for one Project/Filter node."""
        if isinstance(nd, pp.Filter):
            return lambda mp: mp.filter(nd.predicate)
        return lambda mp: mp.eval_expression_list(nd.exprs)

    def _collect_stage_chain(self, head) -> List[pp.PhysicalPlan]:
        """The maximal Project/Filter chain rooted at ``head``, top-first: a
        pure function of the plan. It stops at a shared subtree, whose output
        materialises once at that boundary for every parent."""
        nodes = [head]
        while True:
            child = nodes[-1].children[0]
            if not isinstance(child, (pp.Project, pp.Filter)) or id(child) in self._shared_ids:
                return nodes
            nodes.append(child)

    @staticmethod
    def _chain_steps(nodes) -> List[tuple]:
        """(kind, payload) steps in EXECUTION (bottom-up) order for a
        top-first node chain."""
        return [("filter", nd.predicate) if isinstance(nd, pp.Filter)
                else ("project", list(nd.exprs)) for nd in reversed(nodes)]

    def _compiled_suffix(self, nodes, steps, out_schema):
        """The longest SUFFIX of a bottom-up step chain that runs on the
        device whole (real plans often carry a prefix it cannot run, such as
        a cast off a 64-bit source): ``(k, spec, reason)`` where steps[:k]
        stay interpreted and steps[k:] run as one program, or
        ``(0, None, reason)`` with the first refusal's reason."""
        exec_order = list(reversed(nodes))  # exec_order[i] produced steps[i]
        first_reason = None
        for k in range(len(steps)):
            input_schema = nodes[-1].children[0].schema if k == 0 else exec_order[k - 1].schema
            spec, reason = compiled_eval.build_chain_spec(steps[k:], input_schema, out_schema,
                                                          self.cfg)
            if spec is not None:
                return k, spec, None
            first_reason = first_reason or reason
        return 0, None, first_reason

    def _run_relational_chain(self, head) -> Iterator[MicroPartition]:
        """A Project/Filter chain as one stage: the interpreted prefix, then
        the device suffix as one program per morsel. Profiled, the head's
        kernels and the device program time under the head's frame and each
        fused member's interpreted kernel under its own."""
        nodes = self._collect_stage_chain(head)
        if len(nodes) > 1:
            device_eval_counters.record_stage_fusions(len(nodes) - 1)
        steps = self._chain_steps(nodes)
        split, spec, reason = self._compiled_suffix(nodes, steps, head.schema)
        kernels = [(nd, self._node_kernel(nd)) for nd in reversed(nodes)]
        with contextlib.ExitStack() as stack:
            frames = self._member_frames(stack, nodes[1:])

            def run_step(nd, kern, mp, head_frame):
                if nd is not head:
                    return self._member_step(frames, nd, kern, mp)
                # The head's output is counted at the consumer (_profiled).
                return kern(mp) if head_frame is None else head_frame.run_timed(kern, mp)

            def composed(mp: MicroPartition) -> MicroPartition:
                head_frame = self._stage_frame(head)
                for nd, kern in kernels[:split]:
                    mp = run_step(nd, kern, mp, head_frame)
                if spec is not None:
                    run = spec.run_morsel
                    out = run(mp) if head_frame is None else head_frame.run_timed(run, mp)
                    if out is not None:
                        return out
                elif reason != "nothing_on_device":
                    device_eval_counters.record_host(f"chain_{reason}", rows=len(mp))
                for nd, kern in kernels[split:]:
                    mp = run_step(nd, kern, mp, head_frame)
                return mp

            yield from self._streaming_map(composed, self._run(nodes[-1].children[0]),
                                           name=type(head).__name__)

    def _run_Explode(self, node: pp.Explode) -> Iterator[MicroPartition]:
        names = [e.name() for e in node.to_explode]
        for mp in self._run(node.children[0]):
            yield mp.explode(names, ignore_empty_and_null=node.ignore_empty_and_null)

    def _run_Unpivot(self, node: pp.Unpivot) -> Iterator[MicroPartition]:
        id_names = [e.name() for e in node.ids]
        val_names = [e.name() for e in node.values]
        for mp in self._run(node.children[0]):
            out = [b.unpivot(id_names, val_names, node.variable_name, node.value_name)
                   for b in mp.record_batches()]
            yield MicroPartition(node.schema, out)

    def _run_Sample(self, node: pp.Sample) -> Iterator[MicroPartition]:
        if node.size is not None:
            combined = self._collect(node.children[0], "Sample")
            yield combined.sample(size=node.size, with_replacement=node.with_replacement,
                                  seed=node.seed)
            return
        seed = node.seed
        for i, mp in enumerate(self._run(node.children[0])):
            yield mp.sample(fraction=node.fraction, with_replacement=node.with_replacement,
                            seed=None if seed is None else seed + i)

    def _run_MonotonicallyIncreasingId(self, node: pp.MonotonicallyIncreasingId
                                       ) -> Iterator[MicroPartition]:
        # id = (partition_index << 36) | row_in_partition (reference:
        # ops/monotonically_increasing_id.rs bit layout).
        offset = 0
        part_hi = np.uint64(node.partition_offset << 36)
        for mp in self._run(node.children[0]):
            rb = mp.combined()
            ids = part_hi | np.arange(offset, offset + len(rb), dtype=np.uint64)
            offset += len(rb)
            cols = [Series.from_numpy(ids, node.column_name)] + rb.columns()
            yield MicroPartition(node.schema, [RecordBatch(node.schema, cols, len(rb))])

    def _run_UDFProject(self, node: pp.UDFProject) -> Iterator[MicroPartition]:
        udf = next(n.udf for n in node.udf_expr.walk() if isinstance(n, UdfCall))
        concurrency = max(1, getattr(udf, "max_concurrency", None) or 1)
        # chips_per_replica: the visible devices in replica slots; each
        # morsel evaluates holding one, so at most one morsel per slot runs
        # at a time (the reference's gpus_per_actor, udf.rs:391-406).
        slots = None
        cpr = getattr(udf, "chips_per_replica", None)
        if cpr:
            slots = ReplicaSlots(cpr)
            concurrency = slots.num_replicas if udf.max_concurrency is None \
                else min(concurrency, slots.num_replicas)
        exprs = node.passthrough + [node.udf_expr]
        source = self._run(node.children[0])
        udf_bs = udf.batch_size
        batch_state = None
        if udf_bs:
            child_iter = split_morsels(source, min(udf_bs * 16, self.cfg.default_morsel_size))
        elif self.cfg.udf_dynamic_batching and slots is None:
            batch_state = LatencyConstrainedBatching(
                target_latency_s=self.cfg.udf_target_batch_latency_s,
                b_max=self.cfg.default_morsel_size).make_state()
            child_iter = dynamic_remorsel(source, batch_state)
        else:
            child_iter = split_morsels(source, self.cfg.default_morsel_size)

        def eval_mp(mp: MicroPartition) -> MicroPartition:
            if slots is not None:
                return slots.run(mp.eval_expression_list, exprs)
            if batch_state is None:
                return mp.eval_expression_list(exprs)
            t0 = time.perf_counter()
            out = mp.eval_expression_list(exprs)
            batch_state.record(len(mp), time.perf_counter() - t0)
            return out

        if concurrency == 1 and slots is None:
            for mp in child_iter:
                yield eval_mp(mp)
            return
        # In order, on a pool of the UDF's own: a slow UDF, or one waiting
        # for a replica slot, must never starve the shared relational pool.
        udf_pool = ThreadPoolExecutor(max_workers=concurrency, thread_name_prefix="daft-udf")
        yield from run_stage(child_iter, eval_mp, pool=udf_pool, workers=concurrency,
                             name="UDFProject", owns_pool=True, timer=self._stage_frame(node),
                             ledger=self._stage_ledger("UDFProject"))

    def _run_Aggregate(self, node: pp.Aggregate) -> Iterator[MicroPartition]:
        def fresh_state() -> AggState:
            return AggState(node.agg_exprs, node.group_by, node.schema,
                            input_schema=node.children[0].schema)

        budget = self._sink_budget()
        if budget is None:
            yield from self._pipelined_agg(node, fresh_state)
            return
        if not node.group_by:
            # A global aggregation reduces to one row of merged state, but
            # raw morsels buffer by rows: under a budget it compresses its
            # state in place whenever the state passes it (no disk needed).
            state = fresh_state()
            for mp in self._run(node.children[0]):
                state.accumulate(mp)
                if state.approx_size_bytes() > budget:
                    state.partial_batches()  # flush the raw rows, merge in place
            yield MicroPartition(node.schema, [state.finalize()])
            return
        yield from self._grace_grouped_agg(self._run(node.children[0]), fresh_state, budget,
                                           node.schema)

    def _grace_grouped_agg(self, items: Iterator[MicroPartition], fresh_state, budget: int,
                           schema: Schema) -> Iterator[MicroPartition]:
        """Grace aggregation: whenever the merged partial state outgrows the
        budget, hash-partition it by group key into disk buckets; each bucket
        is then merged and finalised alone (a group's keys land in exactly
        one bucket, so each bucket's finalize is exact)."""
        state: AggState = fresh_state()
        key_names = state.plan.key_names
        grace: Optional[GracePartitioner] = None

        def spill_state(st: AggState) -> None:
            nonlocal grace
            if grace is None:
                grace = GracePartitioner(lambda rb: [rb.get_column(n) for n in key_names],
                                         num_buckets=self.GRACE_BUCKETS, spill=self._spill(),
                                         total_buffer_bytes=budget, op="Aggregate")
            for partial in st.partial_batches():
                grace.add(partial)

        with budget_reservation(self.memory, budget, token=self.cancel_token, op="Aggregate"):
            for mp in items:
                state.accumulate(mp)
                if state.approx_size_bytes() > budget:
                    spill_state(state)
                    state = fresh_state()
            if grace is None:
                yield MicroPartition(schema, [state.finalize()])
                return
            spill_state(state)
            grace.finish()
            for b in range(grace.num_buckets):
                # Stream the bucket into the merge state, never whole: merged
                # partial state has one row per group, so a skewed bucket
                # stays within the budget.
                bstate = fresh_state()
                seen = False
                for rb in grace.stream_bucket(b):
                    seen = True
                    # A bucket's batch coalesces fragments of several spills,
                    # so group keys can repeat within it: force the merge.
                    bstate.accumulate_unmerged_partial(rb)
                    if bstate.approx_size_bytes() > budget:
                        bstate.partial_batches()  # merge in place
                if not seen:
                    continue
                out = bstate.finalize()
                if len(out):
                    yield MicroPartition(schema, [out])

    def _pipelined_agg(self, node: pp.Aggregate, fresh_state) -> Iterator[MicroPartition]:
        """In-memory aggregation with a cardinality-adaptive strategy:

        * the input is morselized and packed into row-chunks of more than
          ``AGG_CHUNK_ROWS`` rows (pure functions of the stream);
        * a global aggregation absorbs the Filter/Project chain below it: the
          chain and the partial aggregation run as ONE program per chunk where
          the whole of it (or a suffix of the chain with the aggregation) runs
          on the device; otherwise the chain runs as its own stage and the
          partials on the host;
        * a grouped aggregation leaves the chain as its own stage (its
          device suffix still runs as one program per morsel) and aggregates
          each chunk through Acero on the host; the first morsel's partial
          measures the group reduction;
        * low-cardinality aggregations merge the chunks' partials in chunk
          order (each group's per-chunk sums associate at fixed chunk
          boundaries);
        * high-cardinality ones (partials barely shrink, so a merge pass would
          nearly double the work) hash-partition instead.
        """
        state: AggState = fresh_state()
        plan = state.plan
        agg_spec, agg_split, reason = None, 0, "grouped"
        chain_nodes: List[pp.PhysicalPlan] = []
        cur = node.children[0]
        if not plan.group_by:
            reason = None
            while isinstance(cur, (pp.Project, pp.Filter)) and id(cur) not in self._shared_ids:
                chain_nodes.append(cur)
                cur = cur.children[0]
            steps = self._chain_steps(chain_nodes)
            exec_order = list(reversed(chain_nodes))
            partial_schema = state.partial_schema(node.children[0].schema)
            # Longest device suffix; k may reach len(steps): a bare partial
            # reduction still runs on the device when the chain cannot.
            for k in range(len(steps) + 1):
                input_schema = cur.schema if k == 0 else exec_order[k - 1].schema
                agg_spec, why = compiled_eval.build_agg_chain_spec(
                    steps[k:], plan, input_schema, partial_schema, self.cfg)
                reason = reason or why
                if agg_spec is not None:
                    agg_split = k
                    break
        with contextlib.ExitStack() as stack:
            # An absorbed chain's nodes get member spans, opened before the
            # source's first pull so the plan nodes number as in the JAX
            # package.
            frames = self._member_frames(stack, chain_nodes) if agg_spec is not None else {}
            source = self._run(cur) if agg_spec is not None else self._run(node.children[0])
            chunks = chunk_morsels(morselize(source, self.min_morsel_rows, self.max_morsel_rows),
                                   self.AGG_CHUNK_ROWS)
            first = next(chunks, None)
            if first is None:
                yield MicroPartition(node.schema, [state.finalize()])
                return
            chain_kernels = [(nd, self._node_kernel(nd)) for nd in reversed(chain_nodes)]

            def partial_of(chunk: List[MicroPartition]) -> RecordBatch:
                return self._partial_of(chunk, plan, agg_spec, agg_split, cur, chain_kernels,
                                        reason, frames)

            yield from self._pipelined_agg_body(node, fresh_state, state, plan, first, chunks,
                                                partial_of)

    def _pipelined_agg_body(self, node, fresh_state, state, plan, first, chunks,
                            partial_of) -> Iterator[MicroPartition]:
        if plan.group_by:
            # Cardinality probe on the FIRST MORSEL only (bounded waste:
            # probing a whole chunk would hash-aggregate the chunk twice on
            # the high-cardinality path). Data-driven, so every bucket count
            # takes the same branch.
            probe = partial_of(first[:1])
            if len(probe) > len(first[0]) * self.cfg.high_cardinality_aggregation_threshold:
                yield from self._partitioned_agg(node, fresh_state,
                                                 itertools.chain([first], chunks))
                return
        # add_partial defers merging to ONE pass at finalize: the threshold
        # merge would re-aggregate the whole merged state once per chunk as
        # soon as it outgrows the threshold. The partials come in chunk order.
        for partial in map_stage(itertools.chain([first], chunks), partial_of,
                                 pool=self._pool(), workers=self.compute_threads,
                                 name="AggPartial", timer=self._stage_frame(node),
                                 ledger=self._stage_ledger("Aggregate")):
            state.add_partial(partial)
        yield MicroPartition(node.schema, [self._node_timed(node, state.finalize)])

    def _partitioned_agg(self, node: pp.Aggregate, fresh_state,
                         chunks) -> Iterator[MicroPartition]:
        """High-cardinality grouped aggregation: hash-partition each chunk by
        group key into one bucket per worker, then aggregate every bucket
        SINGLE-SHOT. A group's rows land whole in one bucket with input order
        preserved (stable partitioning), so each group's float accumulation
        order, and thus every sum, is the same at any bucket count; only the
        output ROW order varies with it, and grouped output order is
        unspecified engine-wide. The split runs as a stage on the pool, and
        the buckets all at once (``collect_parallel``)."""
        buckets_n = max(self.compute_threads, 1)

        def split_chunk(chunk: List[MicroPartition]) -> List[RecordBatch]:
            rb = RecordBatch.concat([b for mp in chunk for b in mp.record_batches()])
            keys = [evaluate(g, rb) for g in node.group_by]
            parts = self._cheap_int_partition(rb, keys, buckets_n)
            return parts if parts is not None else rb.partition_by_hash(keys, buckets_n)

        buckets: List[List[RecordBatch]] = [[] for _ in range(buckets_n)]
        for parts in map_stage(chunks, split_chunk, pool=self._pool(),
                               workers=self.compute_threads, name="AggPartition",
                               timer=self._stage_frame(node)):
            for i, part in enumerate(parts):
                if len(part):
                    buckets[i].append(part)

        def agg_bucket(rbs: List[RecordBatch]) -> RecordBatch:
            st: AggState = fresh_state()
            if rbs:
                rb = rbs[0] if len(rbs) == 1 else RecordBatch.concat(rbs)
                # One partial pass over the whole bucket (bypassing the flush
                # threshold keeps each group's association a single in-order
                # Acero pass, invariant to the bucket count).
                st.accumulate_partial(self._grouped_partial(rb, st.plan))
            return st.finalize()

        for out in collect_parallel(buckets, agg_bucket, pool=self._pool(),
                                    workers=self.compute_threads,
                                    timer=self._stage_frame(node)):
            if len(out):
                yield MicroPartition(node.schema, [out])

    @staticmethod
    def _cheap_int_partition(rb: RecordBatch, keys,
                             n_buckets: int) -> Optional[List[RecordBatch]]:
        """Bucket rows on a SINGLE int-like group key with one vector
        multiply-shift and per-bucket mask filters, cheaper than the generic
        row hash + stable sort. Order within a bucket is input order (the
        filter is stable), which the float-determinism contract rests on;
        None defers to the generic path. Bucket assignment depends only on
        key values and the bucket count."""
        if len(keys) != 1:
            return None
        kv = _key_values(keys[0])  # the ONE int-like-key eligibility rule
        if kv is None:
            return None
        vals, mask = kv
        # Eligibility is by dtype only, never by data: chunks of one
        # aggregation that disagreed on the bucket function would split a
        # group across buckets. Any int width maps through a wrap-around
        # uint64 cast, the same for every chunk.
        if vals.dtype.kind == "M":
            h = vals.view(np.int64).astype(np.uint64)
        else:
            h = vals.astype(np.uint64)
        # Fibonacci multiplicative hash: one multiply + shift scrambles
        # strided key sets (all-even keys etc.) that a bare modulo clumps.
        with np.errstate(over="ignore"):
            h = (h * np.uint64(0x9E3779B97F4A7C15)) >> np.uint64(17)
        ids = (h % np.uint64(n_buckets)).astype(np.int64)
        if mask is not None:
            ids[mask] = 0  # null group rows all land in bucket 0
        return [rb.filter(Series.from_numpy(ids == b, "m")) for b in range(n_buckets)]

    @staticmethod
    def _grouped_partial(rb: RecordBatch, plan) -> RecordBatch:
        """A grouped partial aggregation, its children included: Acero on
        the host, counted as ``agg_grouped``."""
        device_eval_counters.record_host("agg_grouped", rows=len(rb))
        return rb.agg(plan.partial_exprs, plan.group_by)

    def _partial_of(self, chunk: List[MicroPartition], plan, agg_spec, agg_split: int, cur,
                    chain_kernels, reason: Optional[str], frames) -> RecordBatch:
        rb = RecordBatch.concat([b for mp in chunk for b in mp.record_batches()])
        if plan.group_by:
            return self._grouped_partial(rb, plan)
        if agg_spec is None:
            device_eval_counters.record_host(f"agg_{reason}", rows=len(rb))
            return rb.agg(plan.partial_exprs)
        # The interpreted prefix (steps the device cannot run), then the
        # device suffix with the partial aggregation as one program.
        mp = MicroPartition(cur.schema, [rb])
        for nd, kern in chain_kernels[:agg_split]:
            mp = self._member_step(frames, nd, kern, mp)
        rb = mp.combined()
        out = agg_spec.run_chunk(rb)
        if out is not None:
            return out
        # A data-driven host route (counted by run_chunk): finish the suffix
        # interpreted, each step timed under its node's frame.
        for nd, kern in chain_kernels[agg_split:]:
            mp = self._member_step(frames, nd, kern, mp)
        return mp.combined().agg(plan.partial_exprs)

    def _run_Limit(self, node: pp.Limit) -> Iterator[MicroPartition]:
        to_skip = node.offset
        remaining = node.limit
        for mp in self._run(node.children[0]):
            if to_skip > 0:
                n = len(mp)
                if n <= to_skip:
                    to_skip -= n
                    continue
                mp = mp.slice(to_skip, n - to_skip)
                to_skip = 0
            if remaining <= 0:
                break
            if len(mp) > remaining:
                mp = mp.head(remaining)
            remaining -= len(mp)
            yield mp
            if remaining <= 0:
                break

    # -- blocking sinks ---------------------------------------------------
    def _collect(self, node: pp.PhysicalPlan, op: str,
                 source: Optional[Iterator[MicroPartition]] = None) -> MicroPartition:
        """Materialise a blocking sink's input (``source`` in place of the
        node's own stream, when given) under memory permits, charged in the
        ledger to ``op``, the sink.

        Permits bound memory across concurrent executors; within one
        oversized sink they degrade to best effort: after the first failed
        acquire the gate disengages for this sink (counted), since the only
        releaser is this executor at query end and further waits could only
        stall."""
        parts = []
        limit = self.memory.limit
        gate_on = limit is not None
        for mp in (self._run(node) if source is None else source):
            if gate_on and self._held_bytes < limit:
                nbytes = mp.size_bytes()
                if self.memory.acquire(nbytes, timeout=self.PERMIT_WAIT_S,
                                       token=self.cancel_token):
                    self._add_held(min(nbytes, limit), op=op)
                else:
                    gate_on = False
                    spill_metrics.record_best_effort("permit_gates_off")
            parts.append(mp)
        if not parts:
            return MicroPartition.empty(node.schema)
        return MicroPartition.concat(parts)

    def _run_Sort(self, node: pp.Sort) -> Iterator[MicroPartition]:
        budget = self._sink_budget()
        if budget is None:
            combined = self._collect(node.children[0], "Sort")
            yield combined.sort(node.sort_by, node.descending, node.nulls_first)
            return
        # Out of core: sorted runs, then a k-way streaming merge.
        with budget_reservation(self.memory, budget, token=self.cancel_token, op="Sort"):
            state = ExternalSort(node.sort_by, node.descending, node.nulls_first, node.schema,
                                 budget, self._spill(), morsel_rows=self.cfg.default_morsel_size)
            for mp in self._run(node.children[0]):
                state.add(mp)
            yield from state.results()

    def _run_TopN(self, node: pp.TopN) -> Iterator[MicroPartition]:
        k = node.limit + node.offset
        buffer: Optional[RecordBatch] = None
        for mp in self._run(node.children[0]):
            rb = mp.combined()
            buffer = rb if buffer is None else RecordBatch.concat([buffer, rb])
            if len(buffer) > 4 * max(k, 1):
                buffer = self._topk(buffer, node, k)
        if buffer is None:
            yield MicroPartition.empty(node.schema)
            return
        buffer = self._topk(buffer, node, k)
        yield MicroPartition(node.schema, [buffer.slice(node.offset, node.limit)])

    @staticmethod
    def _topk(rb: RecordBatch, node, k: int) -> RecordBatch:
        # Arrow's sort is stable, so repeated trims keep the rows one sort
        # of the whole input would keep.
        keys = [evaluate(e, rb) for e in node.sort_by]
        return rb.sort(keys, node.descending, node.nulls_first).head(k)

    def _run_Distinct(self, node: pp.Distinct) -> Iterator[MicroPartition]:
        budget = self._sink_budget()
        if budget is None:
            yield from self._distinct(node, None)
            return
        with budget_reservation(self.memory, budget, token=self.cancel_token, op="Distinct"):
            yield from self._distinct(node, budget)

    def _distinct(self, node: pp.Distinct, budget: Optional[int]) -> Iterator[MicroPartition]:
        """Per-morsel dedupe, then the whole input's; past ``budget`` the
        deduped morsels go to grace buckets by key, deduped bucket by
        bucket."""
        on = [e.name() for e in node.on] if node.on else None
        key_names = on or node.schema.column_names()
        grace: Optional[GracePartitioner] = None
        buffer: List[RecordBatch] = []
        buf_bytes = 0
        for mp in self._run(node.children[0]):
            rb = mp.combined().distinct(on)
            buffer.append(rb)
            buf_bytes += rb.size_bytes()
            if budget is not None and buf_bytes > budget:
                if grace is None:
                    grace = GracePartitioner(lambda b: [b.get_column(n) for n in key_names],
                                             num_buckets=self.GRACE_BUCKETS,
                                             spill=self._spill(), total_buffer_bytes=budget,
                                             op="Distinct")
                for b in buffer:
                    grace.add(b)
                buffer, buf_bytes = [], 0
        if grace is not None:
            for b in buffer:
                grace.add(b)
            grace.finish()
            for i in range(grace.num_buckets):
                acc = self._fold_distinct(grace.stream_bucket(i), on)
                if acc is not None and len(acc):
                    yield MicroPartition(node.schema, [acc])
            return
        if not buffer:
            yield MicroPartition.empty(node.schema)
            return
        yield MicroPartition(node.schema, [RecordBatch.concat(buffer).distinct(on)])

    @staticmethod
    def _fold_distinct(batches: Iterator[RecordBatch], on) -> Optional[RecordBatch]:
        """The distinct rows of a grace bucket as it streams, in first-seen
        order. Batches wait until they hold as many rows as the rows kept so
        far, then fold in at once: what is resident stays within twice the
        bucket's distinct rows plus one batch, and each row is folded a
        bounded number of times. The JAX package dedupes every batch and
        folds it into everything kept so far, which is quadratic in a
        bucket's batches (C.37); the rows and their order are the same."""
        acc: Optional[RecordBatch] = None
        pending: List[RecordBatch] = []
        pending_rows = 0
        for rb in batches:
            pending.append(rb)
            pending_rows += len(rb)
            if acc is None or pending_rows >= len(acc):
                acc = RecordBatch.concat(([] if acc is None else [acc]) + pending).distinct(on)
                pending, pending_rows = [], 0
        if pending:
            acc = RecordBatch.concat([acc] + pending).distinct(on)
        return acc

    def _run_Pivot(self, node: pp.Pivot) -> Iterator[MicroPartition]:
        from daft_tpu_torch.expressions.expr import AggOp, Alias

        # Pre-aggregate (group_by + pivot) then pivot to columns.
        agg = Alias(AggOp(node.agg_fn, node.value_col), "__pivot_value")
        combined = self._collect(node.children[0], "Pivot").combined()
        pre = combined.agg([agg], node.group_by + [node.pivot_col])
        group_keys = [pre.get_column(g.name()) for g in node.group_by]
        out = pre.pivot(group_keys, pre.get_column(node.pivot_col.name()),
                        pre.get_column("__pivot_value"), node.names)
        cols = []
        for f in node.schema:
            c = out.get_column(f.name)
            cols.append(c.cast(f.dtype) if c.dtype != f.dtype else c)
        yield MicroPartition(node.schema, [RecordBatch(node.schema, cols, len(out))])

    def _run_Window(self, node: pp.Window) -> Iterator[MicroPartition]:
        from daft_tpu_torch.execution.window_eval import eval_windows

        budget = self._sink_budget()
        part_keys = self._common_window_partition_keys(node.window_exprs)
        if budget is None or part_keys is None:
            # Unpartitioned windows (or no memory limit) need the whole
            # input in one batch.
            combined = self._collect(node.children[0], "Window").combined()
            yield MicroPartition(node.schema,
                                 [eval_windows(combined, node.window_exprs, node.schema)])
            return
        # Grace windows: every window spec partitions by the same keys, so the
        # rows of one window partition land in one disk bucket and each bucket
        # evaluates alone (row order across buckets is unspecified, as
        # everywhere outside Sort).
        with budget_reservation(self.memory, budget, token=self.cancel_token, op="Window"):
            grace: Optional[GracePartitioner] = None
            buffer: List[RecordBatch] = []
            buf_bytes = 0
            for mp in self._run(node.children[0]):
                rb = mp.combined()
                buffer.append(rb)
                buf_bytes += rb.size_bytes()
                if grace is None and buf_bytes > budget:
                    grace = GracePartitioner(
                        lambda b: [evaluate(k, b) for k in part_keys],
                        num_buckets=self.GRACE_BUCKETS, spill=self._spill(),
                        total_buffer_bytes=budget, op="Window")
                if grace is not None:
                    for b in buffer:
                        grace.add(b)
                    buffer, buf_bytes = [], 0
            if grace is None:
                if not buffer:
                    yield MicroPartition.empty(node.schema)
                    return
                yield MicroPartition(node.schema, [eval_windows(
                    RecordBatch.concat(buffer), node.window_exprs, node.schema)])
                return
            grace.finish()
            for b in range(grace.num_buckets):
                # Each window partition must be whole, so one BUCKET (about
                # input / 32, or a skew-hot key) must fit in memory: the
                # single-level grace bound of right and outer joins.
                batches = list(grace.stream_bucket(b))
                if batches:
                    yield MicroPartition(node.schema, [eval_windows(
                        RecordBatch.concat(batches), node.window_exprs, node.schema)])

    @staticmethod
    def _common_window_partition_keys(window_exprs):
        """The shared partition_by exprs when EVERY window spec in the
        projection partitions by the same non-empty key set; None otherwise
        (those windows are global and cannot bucket)."""
        from daft_tpu_torch.expressions.expr import WindowExpr

        common_key = None
        keys = None
        for e in window_exprs:
            for n in e.walk():
                if isinstance(n, WindowExpr):
                    if not n.partition_by:
                        return None
                    k = frozenset(p.key() for p in n.partition_by)
                    if common_key is None:
                        common_key, keys = k, list(n.partition_by)
                    elif k != common_key:
                        return None
        return keys

    # -- joins ------------------------------------------------------------
    @staticmethod
    def _unified_keys(rb: RecordBatch, key_exprs, key_dtypes) -> List[Series]:
        keys = [evaluate(e, rb) for e in key_exprs]
        if key_dtypes is None:
            return keys
        return [k.cast(dt) if dt is not None and k.dtype != dt else k
                for k, dt in zip(keys, key_dtypes)]

    def _run_HashJoin(self, node: pp.HashJoin) -> Iterator[MicroPartition]:
        budget = self._sink_budget()
        if budget is not None:
            # Under a budget the sides own their buffering: no look-ahead.
            with budget_reservation(self.memory, budget, token=self.cancel_token,
                                    op="HashJoin"):
                yield from self._hash_join(node, budget, None)
            return
        # While the build side collects, a bounded prefetch warms the probe
        # side's stages, so the probe starts on full queues. It is closed on
        # any exit, so a failed build cannot leave its thread pulling.
        prefetch = Prefetch(self._run(node.children[0]), capacity=4, name="probe-side") \
            if self.compute_threads > 1 else None
        try:
            yield from self._hash_join(node, None, iter(prefetch) if prefetch is not None
                                       else self._run(node.children[0]))
        finally:
            if prefetch is not None:
                prefetch.close()

    def _collect_or_grace(self, child: pp.PhysicalPlan, key_exprs, budget: Optional[int],
                          key_dtypes=None, source: Optional[Iterator[MicroPartition]] = None,
                          num_buckets: Optional[int] = None, op: str = "HashJoin"):
        """A join side in memory, or, once it outgrows ``budget``, in grace
        buckets by its join key: ``("mem", MicroPartition)`` or ``("grace",
        GracePartitioner)``. The keys are cast to the UNIFIED key dtypes
        first, since the row hash depends on the byte width and equal keys of
        both sides must land in the same bucket. ``source`` stands in for the
        child's own stream; ``num_buckets`` and ``op`` default to the hash
        join's."""
        if budget is None:
            return "mem", self._collect(child, op, source)
        buffer: List[MicroPartition] = []
        buf_bytes = 0
        grace: Optional[GracePartitioner] = None
        for mp in (self._run(child) if source is None else source):
            if grace is not None:
                for rb in mp.record_batches():
                    grace.add(rb)
                continue
            buffer.append(mp)
            buf_bytes += mp.size_bytes()
            if buf_bytes > budget:
                grace = GracePartitioner(
                    lambda rb: self._unified_keys(rb, key_exprs, key_dtypes),
                    num_buckets or self.GRACE_BUCKETS, self._spill(),
                    total_buffer_bytes=budget, op=op)
                for buffered in buffer:
                    for rb in buffered.record_batches():
                        grace.add(rb)
                buffer = []
        if grace is not None:
            grace.finish()
            return "grace", grace
        if not buffer:
            return "mem", MicroPartition.empty(child.schema)
        return "mem", MicroPartition.concat(buffer)

    @staticmethod
    def _grace_bucket_rbs(side, b: int, schema: Schema) -> RecordBatch:
        """Bucket ``b`` of a graced side (or of a side partitioned in
        memory, a list) as one RecordBatch; empty when it has no rows."""
        if isinstance(side, list):
            return side[b]
        bucket = side.read_bucket(b)
        if bucket is None or len(bucket) == 0:
            return RecordBatch.empty(schema)
        return bucket.combined()

    @staticmethod
    def _grace_bucket_stream(side, b: int) -> Iterator[RecordBatch]:
        if isinstance(side, list):
            yield side[b]
            return
        yield from side.stream_bucket(b)

    def _hash_join(self, node: pp.HashJoin, budget: Optional[int],
                   left_source: Optional[Iterator[MicroPartition]]
                   ) -> Iterator[MicroPartition]:
        """The join over the build (right) side, collected or graced, and the
        probe side's stream (``left_source``, else the left child's own,
        started after the build)."""
        lschema, rschema = node.children[0].schema, node.children[1].schema
        # int32 against int64 keys (and the like) index and hash as one dtype.
        key_dtypes = [
            unify_dtypes(lt, rt) if lt != rt else None
            for lt, rt in ((le.to_field(lschema).dtype, re.to_field(rschema).dtype)
                           for le, re in zip(node.left_on, node.right_on))
        ]
        right_state, right_side = self._collect_or_grace(node.children[1], node.right_on,
                                                         budget, key_dtypes)
        on = [e.name() for e in node.left_on]
        if right_state == "grace" or node.how in ("right", "outer"):
            # Unmatched build rows are known only after the whole probe side,
            # and an oversized build side forces grace for every join type.
            left_state, left_side = self._collect_or_grace(
                node.children[0], node.left_on, budget, key_dtypes, source=left_source)
            if right_state == "mem" and left_state == "mem":
                left, right = left_side.combined(), right_side.combined()
                left_keys = [evaluate(e, left) for e in node.left_on]
                right_keys = [evaluate(e, right) for e in node.right_on]
                out = self._join_and_fix(left, right, left_keys, right_keys, node)
                join_counters.record_probe(join_counters.start(node.how, on, len(right)),
                                           "acero", len(left), len(out))
                yield MicroPartition(node.schema, [out])
                return
            yield from self._grace_join(node, key_dtypes, on, left_side, right_side)
            return
        right = right_side.combined()
        right_keys = [evaluate(e, right) for e in node.right_on]
        right_data, coalesce = self._prep_join_right(right, node)
        # Build once, probe many: an index over the build side where the
        # keys and the join type allow (a pure function of plan and data).
        index = JoinIndex.try_build(self._unified_keys(right, node.right_on, key_dtypes),
                                    node.how, right_data)
        build_rb = right_data
        if index is not None and node.how not in ("semi", "anti"):
            lnames = set(lschema.column_names())
            ren = {n: f"{node.suffix}{n}" for n in right_data.schema.column_names()
                   if n in lnames}
            if ren:
                cols = [c.rename(ren[c.name]) if c.name in ren else c
                        for c in right_data.columns()]
                build_rb = RecordBatch(Schema([Field(c.name, c.dtype) for c in cols]),
                                       cols, len(right_data))
        rec = join_counters.start(node.how, on, len(right))
        route = "acero" if index is None else \
            ("dense" if index.offsets is not None else "sorted")

        def probe(mp: MicroPartition) -> MicroPartition:
            left = mp.combined()
            joined = None
            if index is not None:
                joined = index.probe(left, self._unified_keys(left, node.left_on, key_dtypes),
                                     build_rb, node.how)
            if joined is not None:
                out = self._finish_join(joined, coalesce, node)
                join_counters.record_probe(rec, route, len(left), len(out))
            else:
                left_keys = [evaluate(e, left) for e in node.left_on]
                out = self._join_and_fix(left, right, left_keys, right_keys, node)
                join_counters.record_probe(rec, "acero", len(left), len(out))
            return MicroPartition(node.schema, [out])

        # Without an index each probe morsel re-hashes the build side, so the
        # probe keeps its natural (coarse) morsels.
        if left_source is None:
            left_source = self._run(node.children[0])
        yield from self._streaming_map(probe, left_source, name="HashJoin",
                                       split=index is not None, node=node)

    def _grace_join(self, node: pp.HashJoin, key_dtypes, on, left_side,
                    right_side) -> Iterator[MicroPartition]:
        """Grace hash join: equal keys hash to the same bucket on both sides,
        so each bucket joins alone with exact semantics (the unmatched rows
        of outer joins included). A side held in memory is partitioned
        there; ``join_counters`` records the buckets under route ``grace``."""
        nb = self.GRACE_BUCKETS
        sides = []
        for side, key_exprs in ((right_side, node.right_on), (left_side, node.left_on)):
            if isinstance(side, MicroPartition):
                rb = side.combined()
                side = rb.partition_by_hash(self._unified_keys(rb, key_exprs, key_dtypes), nb)
            sides.append(side)
        right_side, left_side = sides
        build_rows = sum(len(p) for p in right_side) if isinstance(right_side, list) \
            else sum(sf.rows for files in right_side.buckets for sf in files)
        rec = join_counters.start(node.how, on, build_rows)
        lschema, rschema = node.children[0].schema, node.children[1].schema
        for b in range(nb):
            right = self._grace_bucket_rbs(right_side, b, rschema)
            if node.how in ("inner", "left", "semi", "anti"):
                if len(right) == 0 and node.how in ("inner", "semi"):
                    continue
                # Left-driven joins stream the probe bucket batch by batch:
                # only the build bucket must fit, so probe-side key skew
                # never materialises a hot bucket whole.
                right_keys = [evaluate(e, right) for e in node.right_on]
                for left in self._grace_bucket_stream(left_side, b):
                    if len(left) == 0:
                        continue
                    left_keys = [evaluate(e, left) for e in node.left_on]
                    out = self._join_and_fix(left, right, left_keys, right_keys, node)
                    join_counters.record_probe(rec, "grace", len(left), len(out))
                    if len(out):
                        yield MicroPartition(node.schema, [out])
                continue
            # Right / outer joins follow unmatched build rows across the whole
            # probe bucket, so both buckets materialise (hot-KEY skew beyond
            # one bucket's budget is the known limit of one-level grace).
            left = self._grace_bucket_rbs(left_side, b, lschema)
            if len(left) == 0 and len(right) == 0:
                continue
            if len(right) == 0 and node.how == "right":
                continue
            left_keys = [evaluate(e, left) for e in node.left_on]
            right_keys = [evaluate(e, right) for e in node.right_on]
            out = self._join_and_fix(left, right, left_keys, right_keys, node)
            join_counters.record_probe(rec, "grace", len(left), len(out))
            if len(out):
                yield MicroPartition(node.schema, [out])

    @staticmethod
    def _conform_to_schema(rb: RecordBatch, schema: Schema) -> RecordBatch:
        """Reorder/cast columns to the planned output schema."""
        import pyarrow as pa

        cols = []
        for f in schema:
            c = rb.get_column(f.name)
            if c.dtype != f.dtype:
                if f.dtype.is_null() and c.to_arrow().null_count == len(rb):
                    # A null-planned column whose runtime values ARE all null
                    # (e.g. the upcast key of a semi join on an all-None
                    # column) substitutes cleanly; arrow has no cast INTO
                    # null. Real values against a null plan still fail loud.
                    c = Series.from_arrow(pa.nulls(len(rb)), f.name, f.dtype)
                else:
                    c = c.cast(f.dtype)
            cols.append(c)
        return RecordBatch(schema, cols, len(rb))

    @staticmethod
    def _prep_join_right(right: RecordBatch, node):
        """Node-constant right-side prep shared by the Acero and probe-index
        paths: drop merged join keys from the right copy and, for
        right/outer joins, carry the right copy under a reserved ``__rk_``
        name so right-only rows can coalesce the null left key after the
        join (the reference coalesces common join columns in
        hash_outer_join). Returns ``(right_data, coalesce_names)``."""
        merged = sorted(node.merged_keys) if node.merged_keys and node.how not in ("semi", "anti") else []
        coalesce = merged if node.how in ("right", "outer") else []
        if not merged:
            return right, coalesce
        keep = right.schema.exclude(merged)
        cols = [right.get_column(n) for n in keep.column_names()]
        cols += [right.get_column(n).rename(f"__rk_{n}") for n in coalesce]
        schema = Schema([Field(c.name, c.dtype) for c in cols])
        return RecordBatch(schema, cols, len(right)), coalesce

    def _finish_join(self, joined: RecordBatch, coalesce, node) -> RecordBatch:
        if coalesce:
            cols = [c.coalesce(joined.get_column(f"__rk_{c.name}")) if c.name in coalesce
                    else c for c in joined.columns() if not c.name.startswith("__rk_")]
            joined = RecordBatch(Schema([Field(c.name, c.dtype) for c in cols]),
                                 cols, len(joined))
        return self._conform_to_schema(joined, node.schema)

    def _join_and_fix(self, left, right, left_keys, right_keys, node) -> RecordBatch:
        right_data, coalesce = self._prep_join_right(right, node)
        joined = left.hash_join(right_data, left_keys, right_keys, node.how, node.suffix)
        return self._finish_join(joined, coalesce, node)

    def _run_AsofJoin(self, node: pp.AsofJoin) -> Iterator[MicroPartition]:
        right = self._collect(node.children[1], "AsofJoin").combined()
        right_on = evaluate(node.right_on, right)
        right_by = [evaluate(e, right) for e in node.right_by]
        for mp in self._run(node.children[0]):
            left = mp.combined()
            left_on = evaluate(node.left_on, left)
            left_by = [evaluate(e, left) for e in node.left_by]
            joined = left.asof_join(right, left_on, right_on, left_by, right_by,
                                    node.direction, node.suffix)
            yield MicroPartition(node.schema, [self._conform_to_schema(joined, node.schema)])

    def _run_CrossJoin(self, node: pp.CrossJoin) -> Iterator[MicroPartition]:
        right = self._collect(node.children[1], "CrossJoin").combined()
        for mp in self._run(node.children[0]):
            joined = mp.combined().cross_join(right, node.suffix)
            yield MicroPartition(node.schema, [self._conform_to_schema(joined, node.schema)])

    # -- multi-input ------------------------------------------------------
    def _run_Concat(self, node: pp.Concat) -> Iterator[MicroPartition]:
        for child in node.children:
            yield from self._run(child)

    # -- write ------------------------------------------------------------
    def _run_Repartition(self, node: pp.Repartition) -> Iterator[MicroPartition]:
        scheme = node.scheme
        kind = scheme[0]
        if kind == "hash":
            _, exprs, n = scheme
            budget = self._sink_budget()
            if budget is not None:
                # Buffer in memory until the sink budget trips, THEN stream
                # into n disk buckets with the hash the in-memory partitioner
                # uses: a small repartition never pays a disk round trip.
                # Every bucket yields, an empty one too (n partitions).
                with budget_reservation(self.memory, budget, token=self.cancel_token,
                                        op="Repartition"):
                    state, side = self._collect_or_grace(
                        node.children[0], exprs, budget, num_buckets=max(n, 1),
                        op="Repartition")
                    if state == "mem":
                        yield from side.partition_by_hash(exprs, n)
                        return
                    for b in range(max(n, 1)):
                        yield MicroPartition(node.schema, list(side.stream_bucket(b)))
                return
            yield from self._collect(node.children[0], "Repartition").partition_by_hash(exprs, n)
            return
        combined = self._collect(node.children[0], "Repartition")
        if kind == "range_bound":
            # Range partition against precomputed boundary rows.
            _, exprs, descending, nulls_first, boundaries = scheme
            rb = combined.combined()
            keys = [evaluate(e, rb) for e in exprs]
            for part in rb.partition_by_range(keys, boundaries, list(descending),
                                              list(nulls_first)):
                yield MicroPartition(node.schema, [part])
        elif kind == "random":
            _, n = scheme
            yield from combined.partition_by_random(n, seed=42)
        elif kind == "into":
            _, n = scheme
            rb = combined.combined()
            base, extra = divmod(len(rb), max(n, 1))
            start = 0
            for i in range(n):
                size = base + (1 if i < extra else 0)
                yield MicroPartition(node.schema, [rb.slice(start, size)])
                start += size
        else:
            raise DaftPlanError(f"Unknown repartition scheme {kind}")

    def _run_Write(self, node: pp.Write) -> Iterator[MicroPartition]:
        from daft_tpu_torch.io.writers import make_writer, overwrite_files

        child = node.children[0]
        info = node.write_info
        writer = make_writer(info, child.schema, self.cfg)
        for mp in self._run(child):
            writer.write(mp)
        results = writer.close()
        if info.write_mode == "overwrite":
            overwrite_files(info.root_dir, [r["path"] for r in results])
        yield MicroPartition.from_pydict({
            "path": [r["path"] for r in results],
            "num_rows": np.array([r["num_rows"] for r in results], dtype=np.uint64),
        }) if results else MicroPartition.empty(node.schema)
