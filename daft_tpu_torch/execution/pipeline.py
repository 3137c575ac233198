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
a copy of the caller's contextvars (the query's cancel token). Only feeders
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

Not ported yet: the per-stage byte account of the memory observatory
(``_StageAccount`` and the ``ledger=`` hook, ROADMAP A.3) and the ``timer=``
profiling hook (A.9.5).
"""

from __future__ import annotations

import contextvars
import queue
import threading
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


def _on_worker(fn: Callable) -> Callable:
    """``fn`` as a pool task: the query's cancel token is checked before
    the morsel starts, and the morsel runs on the worker's own stream."""
    def run(item):
        check_current("morsel")
        with worker_stream():
            return fn(item)

    return run


def run_stage(child_iter: Iterator, fn: Callable, *, pool, workers: int,
              name: str = "stage", ordered: bool = True,
              owns_pool: bool = False) -> Iterator:
    """Run ``fn`` over every item of ``child_iter`` on ``pool``'s workers,
    yielding the results: THE pipeline stage primitive.

    A feeder thread pulls the child and submits work through a bounded
    in-flight queue (capacity about 2x ``workers``); the caller's generator
    is the consumer. ``ordered=True`` yields in input order (the future
    queue holds futures in submission order); ``ordered=False`` yields in
    completion order. Exceptions from the child iterator or from ``fn``
    reach the consumer unwrapped. The stop flag lets an abandoned consumer
    (a limit, a failure elsewhere) release the feeder without draining.
    ``owns_pool`` shuts ``pool`` down when the stage ends."""
    inflight: "queue.Queue" = queue.Queue(maxsize=max(workers * 2, 2))
    stop = threading.Event()
    ambient = contextvars.copy_context()
    run_one = _on_worker(fn)

    def put_or_stop(item) -> bool:
        while not stop.is_set():
            try:
                inflight.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
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
                yield item.result()  # fn's failure: the future re-raises it
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
                yield item

    feeder = threading.Thread(target=ambient.copy().run, args=(submit_all,), daemon=True,
                              name=f"daft-feed-{name}")
    feeder.start()
    try:
        yield from drain()
    finally:
        stop.set()
        if owns_pool:
            pool.shutdown(wait=False, cancel_futures=True)


def map_stage(child_iter: Iterator, fn: Callable, *, pool, workers: int,
              name: str = "stage", ordered: bool = True,
              owns_pool: bool = False) -> Iterator:
    """``run_stage`` when ``workers > 1``, an inline serial map on the
    consumer's thread otherwise: the same stream either way, since the stage
    changes where morsels run, never what they contain."""
    if workers > 1:
        return run_stage(child_iter, fn, pool=pool, workers=workers, name=name,
                         ordered=ordered, owns_pool=owns_pool)

    def serial():
        try:
            for item in child_iter:
                yield fn(item)
        finally:
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
                item = self._q.get()
                if item is _SENTINEL:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            self._stop.set()


def collect_parallel(items: List, fn: Callable, *, pool, workers: int) -> List:
    """``fn`` over every item at once, results in item order: the barrier
    helper of blocking sinks (partitioned buckets). Items never pull a child
    iterator, so sharing the compute pool stays deadlock-free. Every future
    is waited for; the first error (in item order) is raised after."""
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
