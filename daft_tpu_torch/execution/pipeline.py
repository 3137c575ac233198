"""Morsel-parallel pipelined execution primitives (port of
``daft_tpu/execution/pipeline.py``).

Each streaming operator is a *stage*: a feeder thread pulls the child
iterator and submits one task per morsel to the executor's shared compute
pool through a bounded in-flight queue, and the consumer drains the results.
Backpressure is the queue bound (about 2x ``workers`` morsels running or
done per stage). Cancellation is observed at every morsel boundary: the
feeder pulls through the executor's ``_cancel_checked`` wrapper, each worker
checks the ambient token before it starts a morsel, and an abandoned
consumer sets a stop flag that releases the feeder. A failure anywhere
reaches the consumer as the ORIGINAL exception, unwrapped, so error types
match the serial path whatever the thread count. Feeders and workers run in
a copy of the caller's contextvars (the query's cancel token, its frozen
clock and its ambient task profiler). Only feeders
and consumers wait on futures, never pool workers, so stages stacked on one
pool cannot deadlock. Each pool worker runs its morsels on a CUDA stream of
its own (``device.worker_stream``).

Determinism contract: everything that shapes *what* is computed — morsel
split points, coalesce boundaries, aggregation chunk boundaries — is a pure
function of the input stream, never of ``workers`` or scheduling. The thread
count changes only *where* a morsel runs. Ordered stages restore input order
on the way out (the futures queue in submission order), so order-sensitive
consumers see the serial sequence; unordered stages (``ordered=False``) yield
in completion order and serve order-insensitive sinks only.

Byte account: a stage given ``ledger=(query_id, operator)`` charges the byte
ledger (``execution/memledger.py``, kind ``queue``) for each morsel a worker
has completed and the consumer has not yet taken (``_StageAccount``), and
notes the time its feeder spends blocked on a full queue as a stall. The
serial path charges and releases each morsel in turn, so the cumulative
charged bytes per operator are the same at any worker count.

Profiling: a stage given ``timer=`` (the operator's ``profiling._OpFrame``)
runs each item as ``timer.run_timed(fn, item)`` on the thread that computes
it, serial or on a worker, so the operator's span sums the work of every
worker. The time is host time: it covers the kernels' launches and the
copies back, not device time alone.
"""

from __future__ import annotations

import contextvars
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, List, Optional

from daft_tpu_torch.cancellation import check_current
from daft_tpu_torch.device import worker_stream

_SENTINEL = object()

#: Floor below which morsels coalesce before entering a stage: the per-morsel
#: queue and dispatch cost would dominate tiny morsels' work.
DEFAULT_MIN_MORSEL_ROWS = 16 * 1024


def split_morsels(it, max_rows: int):
    """Split oversized morsels at ``max_rows`` boundaries; smaller morsels
    pass through untouched."""
    for mp in it:
        n = len(mp)
        if n <= max_rows:
            yield mp
            continue
        for start in range(0, n, max_rows):
            yield mp.slice(start, min(max_rows, n - start))


def coalesce_morsels(it, min_rows: int):
    """Merge undersized morsels until they reach ``min_rows``. Zero-row
    morsels are absorbed; an empty or all-empty stream still yields its
    (empty) tail morsel so schema-only results survive."""
    pending: List = []
    pending_rows = 0
    emitted = False
    tail = None
    for mp in it:
        tail = mp
        n = len(mp)
        if n == 0:
            continue
        pending.append(mp)
        pending_rows += n
        if pending_rows >= min_rows:
            yield _concat(pending)
            pending, pending_rows = [], 0
            emitted = True
    if pending:
        yield _concat(pending)
    elif not emitted and tail is not None:
        yield tail


def _concat(parts):
    from daft_tpu_torch.micropartition import MicroPartition

    return parts[0] if len(parts) == 1 else MicroPartition.concat(parts)


def morselize(it, min_rows: int, max_rows: int):
    """Canonical stage-input morsel stream: split oversized, coalesce
    undersized."""
    if min_rows > 1:
        it = coalesce_morsels(it, min(min_rows, max_rows))
    return split_morsels(it, max_rows)


def chunk_morsels(it, chunk_rows: int):
    """Group a morsel stream into lists whose cumulative rows first exceed
    ``chunk_rows``: yields ``List[MicroPartition]``. The boundaries fix the
    association of the aggregation's float partial sums."""
    chunk: List = []
    rows = 0
    for mp in it:
        n = len(mp)
        if n == 0:
            continue
        chunk.append(mp)
        rows += n
        if rows > chunk_rows:
            yield chunk
            chunk, rows = [], 0
    if chunk:
        yield chunk


def _timed(fn: Callable, timer) -> Callable:
    """``fn`` timed under the profiling ``timer`` (an ``_OpFrame``), or
    ``fn`` itself when there is none."""
    return fn if timer is None else (lambda item: timer.run_timed(fn, item))


def _on_worker(fn: Callable) -> Callable:
    """``fn`` as a pool task: the query's cancel token is checked before
    the morsel starts, and the morsel runs on the worker's own stream."""
    def run(item):
        check_current("morsel")
        with worker_stream():
            return fn(item)

    return run


class _StageAccount:
    """The byte account of one stage's bounded queue.

    A morsel is CHARGED the moment a stage worker completes it (completed or
    queued residency nobody downstream has taken) and RELEASED when the
    consumer takes it, so the ledger's ``queue`` kind follows the real
    occupancy of the backpressure buffer. ``drain()`` zeroes what is still
    outstanding on any exit of the stage (abandonment, failure).

    Sizes come from a template, not a walk of each morsel's buffers: a
    stage's outputs share one schema, so the fixed-width columns count
    ``rows x bit width`` (a pure function of schema and rows, so the charged
    totals per operator do not depend on the worker count) and only the
    variable-width columns (strings, lists, and the extension types whose
    Arrow type has no bit width) are measured exactly."""

    __slots__ = ("qid", "op", "outstanding", "closed", "lock", "ledger",
                 "_fixed_bits", "_var", "_sizes")

    def __init__(self, qid: str, op: str):
        from daft_tpu_torch.execution.memledger import get_ledger

        self.qid = qid
        self.op = op
        self.outstanding = 0
        self.closed = False
        self.lock = threading.Lock()
        self.ledger = get_ledger()
        self._fixed_bits = None  # per-row BITS of the fixed-width columns
        self._var = ()           # indices of the variable-width columns
        # id(morsel) -> bytes, written at produced() and popped at
        # consumed(): one sizing per morsel. Popping keeps id reuse safe.
        self._sizes: dict = {}

    def _sized_batch(self, rb) -> int:
        # Always the template, never a memoised exact size: whether a memo
        # exists depends on who else sized the batch, and mixing the two
        # would make the totals depend on that, not on the morsel stream.
        cols = rb.columns()
        if self._fixed_bits is None:
            bits, var = 0, []
            for i, c in enumerate(cols):
                if c.dtype.is_python():
                    bits += 64 * 8  # the engine's flat Python-object estimate
                    continue
                try:
                    # In BITS, so packed types (bool, width 1) still count.
                    bits += c.to_arrow().type.bit_width
                except (ValueError, AttributeError):
                    var.append(i)  # variable width: offsets make it data-bound
            self._fixed_bits, self._var = bits, tuple(var)
        total = (self._fixed_bits * len(rb)) // 8
        for i in self._var:
            total += cols[i].to_arrow().nbytes
        return total

    def measure(self, mp) -> int:
        if hasattr(mp, "record_batches"):
            return sum(self._sized_batch(rb) for rb in mp.record_batches())
        if hasattr(mp, "columns"):
            return self._sized_batch(mp)
        return int(mp.size_bytes())  # batch-shaped stand-ins (tests)

    def produced(self, mp) -> None:
        try:
            nbytes = self.measure(mp)
        except (AttributeError, TypeError):
            return
        # Charge FIRST, book under the lock after: a morsel completed just as
        # the consumer abandons the stage lands in ``outstanding`` (drained
        # below) or is undone right here; the ledger never keeps it.
        self.ledger.charge(self.qid, self.op, nbytes, kind="queue")
        with self.lock:
            if not self.closed:
                self.outstanding += nbytes
                self._sizes[id(mp)] = nbytes
                return
        self.ledger.release(self.qid, self.op, nbytes, kind="queue")

    def consumed(self, mp) -> None:
        with self.lock:
            nbytes = self._sizes.pop(id(mp), None)
            if nbytes is None:
                return  # never produced here, or already drained
            nbytes = min(nbytes, self.outstanding)
            self.outstanding -= nbytes
        if nbytes:
            self.ledger.release(self.qid, self.op, nbytes, kind="queue")

    def stalled(self, seconds: float) -> None:
        self.ledger.note_stall(self.qid, self.op, seconds)

    def drain(self) -> None:
        with self.lock:
            self.closed = True
            leftover, self.outstanding = self.outstanding, 0
            self._sizes.clear()
        if leftover:
            self.ledger.release(self.qid, self.op, leftover, kind="queue")


def _stage_account(ledger: Optional[tuple], name: str) -> Optional[_StageAccount]:
    """The stage's byte account from the executor's ``(query_id, op)`` tag;
    None when untagged or the ledger is off (then no per-morsel work at
    all)."""
    if ledger is None:
        return None
    from daft_tpu_torch.execution.memledger import get_ledger

    if not get_ledger().enabled:
        return None
    qid, op = ledger
    return _StageAccount(qid, op or name)


def run_stage(child_iter: Iterator, fn: Callable, *, pool, workers: int,
              name: str = "stage", ordered: bool = True, timer=None,
              owns_pool: bool = False, ledger: Optional[tuple] = None) -> Iterator:
    """Run ``fn`` over every item of ``child_iter`` on ``pool``'s workers,
    yielding the results: THE pipeline stage primitive.

    A feeder thread pulls the child and submits work through a bounded
    in-flight queue (capacity about 2x ``workers``); the caller's generator
    is the consumer. ``ordered=True`` yields in input order (the future
    queue holds futures in submission order); ``ordered=False`` yields in
    completion order. Exceptions from the child iterator or from ``fn``
    reach the consumer unwrapped. The stop flag lets an abandoned consumer
    (a limit, a failure elsewhere) release the feeder without draining.
    ``owns_pool`` shuts ``pool`` down when the stage ends. ``ledger``, a
    ``(query_id, operator)`` tag, charges the queue's residency and the
    feeder's stalls to the byte ledger. ``timer`` times each item on its
    worker (the profiler's ``_OpFrame.run_timed``)."""
    inflight: "queue.Queue" = queue.Queue(maxsize=max(workers * 2, 2))
    stop = threading.Event()
    ambient = contextvars.copy_context()
    run_one = _on_worker(_timed(fn, timer))
    acct = _stage_account(ledger, name)
    if acct is not None:
        base_run = run_one

        def run_one(item, _run=base_run):
            out = _run(item)
            acct.produced(out)
            return out

    def put_or_stop(item) -> bool:
        stall_t0 = None
        while not stop.is_set():
            try:
                inflight.put(item, timeout=0.1)
                if stall_t0 is not None and acct is not None:
                    acct.stalled(time.monotonic() - stall_t0)
                return True
            except queue.Full:
                # A blocked producer: backpressure is engaged. Timed from the
                # first Full, so the fast path reads no clock.
                if stall_t0 is None:
                    stall_t0 = time.monotonic()
                continue
        if stall_t0 is not None and acct is not None:
            acct.stalled(time.monotonic() - stall_t0)
        return False

    if ordered:
        def submit_all():
            try:
                for item in child_iter:
                    fut = pool.submit(ambient.copy().run, run_one, item)
                    if not put_or_stop(fut):
                        fut.cancel()
                        return
            except BaseException as e:  # noqa: BLE001 — delivered to the consumer
                put_or_stop(e)
                return
            put_or_stop(_SENTINEL)

        def drain():
            while True:
                item = inflight.get()
                if item is _SENTINEL:
                    return
                if isinstance(item, BaseException):
                    raise item  # the child iterator's failure, as raised
                res = item.result()  # fn's failure: the future re-raises it
                if acct is not None:
                    acct.consumed(res)
                yield res
    else:
        # Completions push results directly; a semaphore bounds the work in
        # flight (the queue alone cannot: results arrive out of order).
        slots = threading.Semaphore(max(workers * 2, 2))
        state_lock = threading.Lock()
        state = {"submitted": 0, "done": 0, "feeding": True}

        def finish_one(payload) -> None:
            slots.release()
            put_or_stop(payload)
            with state_lock:
                state["done"] += 1
                last = not state["feeding"] and state["done"] == state["submitted"]
            if last:
                put_or_stop(_SENTINEL)

        def run_and_push(item) -> None:
            try:
                finish_one(run_one(item))
            except BaseException as e:  # noqa: BLE001 — delivered to the consumer
                finish_one(e)

        def submit_all():
            try:
                for item in child_iter:
                    while not slots.acquire(timeout=0.1):
                        if stop.is_set():
                            return
                    with state_lock:
                        state["submitted"] += 1
                    pool.submit(ambient.copy().run, run_and_push, item)
            except BaseException as e:  # noqa: BLE001 — delivered to the consumer
                put_or_stop(e)
                return
            finally:
                with state_lock:
                    state["feeding"] = False
                    drained = state["done"] == state["submitted"]
                if drained:
                    put_or_stop(_SENTINEL)

        def drain():
            while True:
                item = inflight.get()
                if item is _SENTINEL:
                    return
                if isinstance(item, BaseException):
                    raise item
                if acct is not None:
                    acct.consumed(item)
                yield item

    feeder = threading.Thread(target=ambient.copy().run, args=(submit_all,), daemon=True,
                              name=f"daft-feed-{name}")
    feeder.start()
    try:
        yield from drain()
    finally:
        stop.set()
        if acct is not None:
            acct.drain()
        if owns_pool:
            pool.shutdown(wait=False, cancel_futures=True)


def map_stage(child_iter: Iterator, fn: Callable, *, pool, workers: int,
              name: str = "stage", ordered: bool = True, timer=None,
              owns_pool: bool = False, ledger: Optional[tuple] = None) -> Iterator:
    """``run_stage`` when ``workers > 1``, an inline serial map on the
    consumer's thread otherwise: the same stream either way, since the stage
    changes where morsels run, never what they contain. The serial map keeps
    the ``ledger`` hook too (each morsel charged at production and released
    at hand-off), so the charged bytes per operator are the same at 1 and N
    workers; only the peaks differ. So does the ``timer`` hook: a serial
    profiled run attributes its work to the frame as a parallel one does."""
    if workers > 1:
        return run_stage(child_iter, fn, pool=pool, workers=workers, name=name,
                         ordered=ordered, timer=timer, owns_pool=owns_pool, ledger=ledger)
    acct = _stage_account(ledger, name)
    run_one = _timed(fn, timer)

    def serial():
        try:
            for item in child_iter:
                out = run_one(item)
                if acct is not None:
                    acct.produced(out)
                    acct.consumed(out)
                yield out
        finally:
            if acct is not None:
                acct.drain()
            if owns_pool:
                pool.shutdown(wait=False, cancel_futures=True)

    return serial()


def ordered_prefetch_map(items: Iterator, fn: Callable, *, depth: int,
                         name: str = "prefetch-map") -> Iterator:
    """``fn`` over up to ``depth`` items at once on a pool of its own,
    yielding results strictly in item order (bounded look-ahead). The pool
    dies with the iterator, exhausted or abandoned."""
    depth = max(int(depth), 1)
    if depth == 1:
        return (fn(item) for item in items)
    pool = ThreadPoolExecutor(max_workers=depth, thread_name_prefix=f"daft-{name}")
    return map_stage(items, fn, pool=pool, workers=depth, name=name, ordered=True,
                     owns_pool=True)


class Prefetch:
    """Pull an iterator eagerly on a thread of its own into a bounded queue.

    The overlap primitive of blocking sinks with two inputs: a hash join's
    probe side warms its upstream stages while the build side collects. A
    dedicated thread (never a pool worker) pulls, keeping the rule that only
    feeders wait; the bounded queue caps the look-ahead. Exceptions reach
    the consumer unwrapped at the morsel where they occurred. Callers must
    :meth:`close` it (or exhaust it): an error between construction and
    consumption would otherwise leave the puller spinning on a full queue."""

    def __init__(self, it: Iterator, capacity: int = 4, name: str = "prefetch"):
        self._q: "queue.Queue" = queue.Queue(maxsize=max(capacity, 1))
        self._stop = threading.Event()
        ambient = contextvars.copy_context()

        def put_or_stop(item) -> bool:
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def pull_all():
            try:
                for item in it:
                    if not put_or_stop(item):
                        return
            except BaseException as e:  # noqa: BLE001 — delivered to the consumer
                put_or_stop(e)
                return
            put_or_stop(_SENTINEL)

        self._thread = threading.Thread(target=ambient.copy().run, args=(pull_all,),
                                        daemon=True, name=f"daft-{name}")
        self._thread.start()

    def close(self) -> None:
        self._stop.set()

    def __iter__(self):
        try:
            while True:
                try:
                    item = self._q.get(timeout=0.1)
                except queue.Empty:
                    # Closed while the puller was inside a slow pull: it
                    # will put nothing more once it sees the stop flag, so a
                    # consumer still waiting (a stage's feeder during
                    # teardown) must not wait forever.
                    if self._stop.is_set() and not self._thread.is_alive():
                        return
                    continue
                if item is _SENTINEL:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            self._stop.set()


def collect_parallel(items: List, fn: Callable, *, pool, workers: int,
                     timer=None) -> List:
    """``fn`` over every item at once, results in item order: the barrier
    helper of blocking sinks (partitioned buckets). Items never pull a child
    iterator, so sharing the compute pool stays deadlock-free. Every future
    is waited for; the first error (in item order) is raised after.
    ``timer`` times each item as ``run_stage``'s does."""
    fn = _timed(fn, timer)
    if workers <= 1 or len(items) <= 1:
        return [fn(it) for it in items]
    ambient = contextvars.copy_context()
    run_one = _on_worker(fn)
    futs = [pool.submit(ambient.copy().run, run_one, it) for it in items]
    out = []
    first_err: Optional[BaseException] = None
    for f in futs:
        try:
            out.append(f.result())
        except BaseException as e:  # noqa: BLE001 — re-raised after the drain
            if first_err is None:
                first_err = e
            out.append(None)
    if first_err is not None:
        raise first_err
    return out
