"""The query profiler: one coherent trace per query (port of
``daft_tpu/profiling.py``).

The metrics plane (metrics.py) answers "how much"; this module
answers "where did the time go" at sub-task granularity. It builds on the
span model in ``tracing.py`` (OTel-shaped :class:`~daft_tpu_torch.tracing.Span`,
monotonic epoch via :func:`~daft_tpu_torch.tracing.span_clock_ns`) and adds the
pieces the reference engine's Swordfish runtime stats + TensorFlow's
step-timeline profiler demonstrated a dataflow engine needs:

* **One trace per query** — the driver opens one trace per query
  (:class:`QueryProfile`) and hands its executor a :class:`TaskProfiler`
  whose completed spans land in the trace as span wires
  (:func:`span_to_wire`). The port runs the local executor only. The
  JAX package's distributed side of the trace waits for the distributed
  runner (ROADMAP A.8): the trace context on every task, the workers' span
  buffers and their heartbeat piggyback, the clock-skew offsets, the
  driver's ingestion (``deliver_spans``) and the dispatcher's task spans
  (``ProfilingSubscriber``). :func:`force_begin_query` opens a profile
  after planning for the SLO plane's tail sampler.
* **Operator-level timing** — the executor wraps each physical operator's
  morsel loop in a span keyed by plan-node id, recording wall time per
  pull, CPU time (``time.thread_time_ns``), rows/bytes out, and — via the
  ambient frame stack (:func:`note_permit_wait` / :func:`note_spill` /
  :func:`note_device`) — memory-permit waits, spill volume, and the
  device-vs-numpy eval split. When no profiler is active every hook is a
  single int check (the unprofiled fast path; ``chip_smoke.py``'s phase 19
  measures the enabled path against it, paired in one process, as the JAX
  package's ``bench.py --profile-overhead`` does against its 2% budget).
  Spans are host time: a span times the kernel's launches and the copies
  back to the host on the thread that ran it, not device time alone (a
  ``torch.profiler`` trace gives that).
* **Timeline export** — ``df.collect(profile="trace.json")`` /
  ``profile_export_path`` writes Chrome trace-event JSON (pid = worker,
  tid = operator lane) loadable in Perfetto / chrome://tracing, and
  :func:`timeline_json` gives the same span store as a per-query Gantt
  timeline (the dashboard's route that serves it is ROADMAP A.8).

``DAFT_PROFILE`` / ``DAFT_PROFILE_FILE`` (read live at every query, as in
the JAX package) and the config fields ``profile_enabled`` /
``profile_export_path`` profile every query; ``DAFT_PROFILE_CPU`` forces the
per-pull CPU clock on or off.

Spans are ALWAYS opened through context managers: an
un-ended span silently drops from export and leaks the thread-local parent
stack. ``ExitStack.enter_context`` is the escape hatch for conditionals.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import json
import os
import random
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Tuple

from daft_tpu_torch.tracing import Span, span_clock_ns

# Span ids: one urandom read per PROCESS, then a counter — secrets.token_hex
# per span costs a full urandom syscall (~100µs under sandboxed kernels),
# which alone would blow the 2% overhead budget. XOR with a random 64-bit
# base keeps ids unique within a process and collision-negligible across
# processes; trace ids (one per query) stay fully random.
_ID_BASE = int.from_bytes(os.urandom(8), "big")
_id_counter = itertools.count()


def new_span_id() -> str:
    return f"{(_ID_BASE ^ next(_id_counter)) & 0xFFFFFFFFFFFFFFFF:016x}"


# Trace ids (one per query) come from a PRNG seeded once from urandom —
# same per-query-syscall argument; 128 random bits keep cross-driver
# collisions negligible. Seeded explicitly.
_TRACE_RNG = random.Random(int.from_bytes(os.urandom(16), "big"))


def new_trace_id() -> str:
    return f"{_TRACE_RNG.getrandbits(128):032x}"


# Thread-CPU clock with a perf_counter guard: CLOCK_THREAD_CPUTIME_ID is a
# real syscall (no vDSO — ~1µs normally, ~70µs under sandboxed kernels),
# while perf_counter is vDSO-cheap. Adjacent frame boundaries in a pull
# chain (parent.begin → child.begin, child.end → parent.end) are µs apart,
# so one syscall serves the whole cluster; boundaries of REAL work (pulls
# long enough to matter) always exceed the window and read fresh. The
# attribution fuzz this introduces is bounded by the window itself.
_CPU_CACHE_WINDOW_NS = 100_000
_cpu_cache = threading.local()


def _thread_cpu_ns() -> int:
    c = _cpu_cache
    pc = time.perf_counter_ns()
    if pc - getattr(c, "pc", -_CPU_CACHE_WINDOW_NS) < _CPU_CACHE_WINDOW_NS:
        return c.value
    v = time.thread_time_ns()
    c.value = v
    c.pc = time.perf_counter_ns()
    return v


# Per-PULL CPU sampling is self-calibrating: on normal kernels the thread
# clock costs ~1µs and every pull gets an exact CPU delta; under sandboxed
# kernels (gVisor-style) the same read costs 50µs+, which alone would blow
# the <2% overhead budget — there, per-pull sampling switches off and CPU
# is recorded at TASK granularity only (two reads per task).
# DAFT_PROFILE_CPU=1 (force per-pull) / =0 (task-level only).
_CPU_CLOCK_BUDGET_NS = 5_000
_sample_cpu: Optional[bool] = None


def cpu_sampling_enabled() -> bool:
    global _sample_cpu
    if _sample_cpu is None:
        from daft_tpu_torch.config import daft_env

        raw = (daft_env("DAFT_PROFILE_CPU") or "").strip().lower()
        if raw and raw != "auto":
            _sample_cpu = raw not in ("0", "false", "no", "off")
        else:
            t0 = time.perf_counter_ns()
            for _ in range(4):
                time.thread_time_ns()
            _sample_cpu = \
                (time.perf_counter_ns() - t0) / 4 < _CPU_CLOCK_BUDGET_NS
    return _sample_cpu

# --------------------------------------------------------------------- #
# Enablement                                                            #
# --------------------------------------------------------------------- #
#: Task profilers currently open in THIS process. The note_* hot-path hooks
#: gate on this plain int so the disabled path costs one comparison and
#: allocates nothing (the metrics plane's noop-child discipline).
_active_count = 0
_active_lock = threading.Lock()

#: Per-query profiling request set by ``df.collect(profile=...)`` — a
#: :class:`ProfileRequest` (export path + result handle), None when the
#: ambient scope requests no profiling.
_request: contextvars.ContextVar[Optional["ProfileRequest"]] = \
    contextvars.ContextVar("daft_profile_request", default=None)

#: The ambient TaskProfiler: set by ``TaskProfiler.task_scope`` and COPIED
#: into executor pool threads (contextvars propagate through the executor's
#: ambient-context submission), so tallies from parallel morsel workers
#: still reach the task even when no operator frame is on their stack.
_current_profiler: contextvars.ContextVar[Optional["TaskProfiler"]] = \
    contextvars.ContextVar("daft_current_profiler", default=None)

_tls = threading.local()


def _stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


class ProfileRequest:
    """Handle yielded by :func:`collect_profile`: ``.profile`` is set to the
    scope's finished QueryProfile at end_query — a race-free alternative to
    the process-global :func:`last_profile` (a concurrently finishing
    profiled query can replace the global between collect and read)."""

    __slots__ = ("path", "profile")

    def __init__(self, path: Optional[str]):
        self.path = path
        self.profile: Optional["QueryProfile"] = None


@contextlib.contextmanager
def collect_profile(path: Optional[str] = None):
    """Mark queries materialized inside this scope for profiling; ``path``
    additionally writes the Chrome trace-event JSON there at query end.
    Yields a :class:`ProfileRequest` whose ``.profile`` holds the scope's
    own finished profile."""
    req = ProfileRequest(path)
    token = _request.set(req)
    try:
        yield req
    finally:
        _request.reset(token)


@contextlib.contextmanager
def _activation():
    global _active_count
    with _active_lock:
        _active_count += 1
    try:
        yield
    finally:
        with _active_lock:
            _active_count -= 1


# --------------------------------------------------------------------- #
# Span wire format                                                      #
# --------------------------------------------------------------------- #
def span_to_wire(span: Span) -> dict:
    """JSON/pickle-safe span for the task-reply / heartbeat wires."""
    return {"name": span.name, "trace_id": span.trace_id,
            "span_id": span.span_id, "parent_id": span.parent_id,
            "start_ns": span.start_ns, "end_ns": span.end_ns,
            "status": span.status, "attributes": dict(span.attributes)}


def span_from_wire(d: dict) -> Span:
    return Span(name=d.get("name", ""), trace_id=d.get("trace_id", ""),
                span_id=d.get("span_id", ""), parent_id=d.get("parent_id"),
                start_ns=int(d.get("start_ns", 0)),
                end_ns=int(d.get("end_ns", 0)),
                status=d.get("status", "OK"),
                attributes=dict(d.get("attributes") or {}))


def iter_with_profiler_scope(gen, profiler: Optional["TaskProfiler"]):
    """Drain ``gen`` with ``profiler`` ambient during each resumption only —
    same shape as ``context.iter_with_frozen_clock`` / cancellation's
    ``iter_with_cancel_scope``: set/reset around every ``next()`` so
    interleaved lazy queries on one thread can't clobber each other's
    profiler (the paired ``task_scope(ambient=False)`` keeps the span open
    for the generator's whole lifetime without touching the contextvar)."""
    if profiler is None:
        yield from gen
        return
    while True:
        token = _current_profiler.set(profiler)
        try:
            try:
                item = next(gen)
            finally:
                _current_profiler.reset(token)
        except StopIteration:
            return
        yield item


# --------------------------------------------------------------------- #
# Hot-path attribution hooks                                            #
# --------------------------------------------------------------------- #
def note_permit_wait(seconds: float) -> None:
    """Attribute a memory-permit wait to the operator whose pull is on this
    thread's frame stack (falling back to the ambient task profiler)."""
    if not _active_count:
        return
    st = getattr(_tls, "stack", None)
    if st:
        st[-1].permit_wait_ns += int(seconds * 1e9)
        return
    prof = _current_profiler.get()
    if prof is not None:
        prof.tally("permit_wait_ns", int(seconds * 1e9))


def note_spill(nbytes: int) -> None:
    if not _active_count:
        return
    st = getattr(_tls, "stack", None)
    if st:
        st[-1].spill_bytes += int(nbytes)
        return
    prof = _current_profiler.get()
    if prof is not None:
        prof.tally("spill_bytes", int(nbytes))


def note_device(rows: int, fused: bool) -> None:
    """Record the eval path taken (device XLA vs numpy fallback) for the
    ambient operator/task — pool threads resolve through the contextvar."""
    if not _active_count:
        return
    field = "device_rows" if fused else "fallback_rows"
    st = getattr(_tls, "stack", None)
    if st:
        setattr(st[-1], field, getattr(st[-1], field) + int(rows))
        return
    prof = _current_profiler.get()
    if prof is not None:
        prof.tally(field, int(rows))


# --------------------------------------------------------------------- #
# Operator frames + TaskProfiler (worker side)                          #
# --------------------------------------------------------------------- #
class _OpFrame:
    """Mutable per-operator accumulator behind one operator span.

    Two timing modes feed ONE frame (and so one span per plan node):

    * **pull timing** (serial operators, blocking sinks) — the executor's
      morsel loop brackets ``next(child)`` with begin_pull/end_pull on the
      consumer thread; busy/cpu measure the pull chain as before.
    * **worker timing** (pipeline stages) — every stage worker runs the
      morsel kernel through :meth:`run_timed`, which measures wall/CPU
      tight around the kernel on the worker thread and aggregates under
      the frame lock. Concurrent per-morsel walls SUM (they are work, and
      may legitimately exceed the span's open interval on multi-core);
      the consumer-side pull times degrade to queue-wait attribution and
      export separately as ``consumer_wait_ns``, so inclusive time is
      never double-counted between an operator's own span and its
      parent's (operator_table subtracts a stage child's *consumer-
      visible* wait from the parent, not its parallel work).
    """

    __slots__ = ("span", "busy_ns", "cpu_ns", "morsels", "rows_out",
                 "bytes_out", "spill_bytes", "permit_wait_ns",
                 "device_rows", "fallback_rows", "_t0", "_c0",
                 "_row_width", "_sample_cpu", "work_ns", "work_cpu_ns",
                 "work_morsels", "self_timed", "_lock")

    def __init__(self, span: Span):
        self.span = span
        self._sample_cpu = cpu_sampling_enabled()
        self.busy_ns = 0
        self.cpu_ns = 0
        self.morsels = 0
        self.rows_out = 0
        self.bytes_out = 0
        self.spill_bytes = 0
        self.permit_wait_ns = 0
        self.device_rows = 0
        self.fallback_rows = 0
        self.work_ns = 0
        self.work_cpu_ns = 0
        self.work_morsels = 0
        self.self_timed = False
        self._lock = threading.Lock()
        self._t0 = 0
        self._c0 = 0
        self._row_width = 0.0

    def begin_pull(self) -> None:
        _stack().append(self)
        self._t0 = time.perf_counter_ns()
        if self._sample_cpu:
            self._c0 = _thread_cpu_ns()

    def end_pull(self) -> None:
        self.busy_ns += time.perf_counter_ns() - self._t0
        if self._sample_cpu:
            self.cpu_ns += _thread_cpu_ns() - self._c0
        st = _stack()
        # Identity-checked pop: a frame whose pull raised may unwind through
        # several frames at once; never pop someone else's entry.
        if st and st[-1] is self:
            st.pop()

    def run_timed(self, fn, item):
        """Run one morsel kernel on a stage WORKER thread, attributing its
        wall + thread-CPU to this frame. Local clocks + a locked add keep
        concurrent workers race-free; the frame also rides this thread's
        attribution stack so note_spill/note_permit_wait/note_device land
        on the right operator from pool threads."""
        st = _stack()
        st.append(self)
        t0 = time.perf_counter_ns()
        c0 = _thread_cpu_ns() if self._sample_cpu else 0
        try:
            return fn(item)
        finally:
            dt = time.perf_counter_ns() - t0
            dc = (_thread_cpu_ns() - c0) if self._sample_cpu else 0
            with self._lock:
                self.work_ns += dt
                self.work_cpu_ns += dc
                self.work_morsels += 1
                self.self_timed = True
            if st and st[-1] is self:
                st.pop()

    def add_worker_output(self, rows: int, mp) -> None:
        """Output accounting from a stage WORKER thread (fused-chain member
        operators record their per-node output inside the composed morsel
        fn): same bookkeeping as :meth:`add_output`, under the frame lock
        because concurrent workers race on the counters."""
        with self._lock:
            self.add_output(rows, mp)

    def add_output(self, rows: int, mp) -> None:
        """Per-morsel output accounting. ``size_bytes()`` walks every
        column buffer, so bytes are SAMPLED (first morsel, then every
        16th) and extrapolated by row width between samples — morsels of
        one operator are near-uniform, and exact-per-morsel byte walks
        would cost more than the rest of the frame combined."""
        self.morsels += 1
        self.rows_out += rows
        if (self.morsels & 0xF) == 1:
            nbytes = mp.size_bytes()
            if rows:
                self._row_width = nbytes / rows
            self.bytes_out += nbytes
        else:
            self.bytes_out += int(rows * self._row_width)


class TaskProfiler:
    """Per-task span collector on a worker (or the driver, for the native
    runner). Spans parent onto the shipped ``(trace_id, parent span_id)``
    context so the driver's exporter assembles ONE trace per query. Finished
    spans go to ``sink`` immediately (daemon buffer / driver store) or stay
    in a local buffer drained onto the task reply."""

    def __init__(self, trace_id: str, parent_span_id: Optional[str],
                 query_id: str, worker_id: str = "driver",
                 sink: Optional[Callable[[List[dict]], None]] = None):
        self.trace_id = trace_id
        self.parent_span_id = parent_span_id
        self.query_id = query_id
        self.worker_id = worker_id
        self._sink = sink
        self._lock = threading.Lock()
        self._buffer: List[dict] = []
        self._root: Optional[Span] = None
        self._tallies: Dict[str, int] = {}

    # -- plumbing ---------------------------------------------------------
    def tally(self, key: str, value: int) -> None:
        """Task-level accumulator for attributions that could not reach an
        operator frame (pool threads); exported on the task root span."""
        with self._lock:
            self._tallies[key] = self._tallies.get(key, 0) + value

    def _finish(self, span: Span) -> None:
        span.attributes.setdefault("query_id", self.query_id)
        span.attributes.setdefault("worker_id", self.worker_id)
        wire = span_to_wire(span)
        if self._sink is not None:
            self._sink([wire])
            return
        with self._lock:
            self._buffer.append(wire)

    def drain(self) -> List[dict]:
        with self._lock:
            out, self._buffer = self._buffer, []
        return out

    def _new_span(self, name: str, parent_id: Optional[str],
                  attrs: Dict[str, Any]) -> Span:
        return Span(name=name, trace_id=self.trace_id,
                    span_id=new_span_id(), parent_id=parent_id,
                    start_ns=span_clock_ns(), attributes=attrs)

    def _parent_id(self) -> Optional[str]:
        st = getattr(_tls, "stack", None)
        if st:
            return st[-1].span.span_id
        if self._root is not None:
            return self._root.span_id
        return self.parent_span_id

    # -- span openers (context-manager API only) -------------------------
    @contextlib.contextmanager
    def task_scope(self, task=None, name: str = "daft.task.run",
                   ambient: bool = True, **attrs):
        """Root span covering the whole task execution on this worker.

        ``ambient=False`` skips publishing this profiler on the ambient
        contextvar — required when the scope lives inside a GENERATOR
        (native runner): a set() executed during a resumption mutates the
        caller's shared context (generators own no Context of their own),
        so interleaved lazy queries would clobber each other and a close
        from a GC thread would reset a foreign token. Such callers pair
        this with :func:`iter_with_profiler_scope`, which set/resets
        around every ``next()`` instead."""
        if task is not None:
            attrs.setdefault("task_id", task.task_id)
            attrs.setdefault("partition_idx", task.partition_idx)
            attrs.setdefault("attempt", getattr(task, "attempt", 0))
        span = self._new_span(name, self.parent_span_id, attrs)
        self._root = span
        token = _current_profiler.set(self) if ambient else None
        # Task-level CPU is always recorded (two clock reads per task):
        # the per-pull sampling below it is what self-calibrates away on
        # expensive-clock kernels.
        cpu0 = time.thread_time_ns()
        try:
            with _activation():
                yield span
        except BaseException as e:  # noqa: BLE001 — annotate + re-raise
            if not isinstance(e, GeneratorExit):
                # GeneratorExit is normal early close (limit pushdown); a
                # real failure exports a PARTIAL span so a worker dying
                # mid-task still shows up on the timeline.
                span.status = "ERROR"
                span.attributes["error"] = repr(e)
                span.attributes["partial"] = True
            raise
        finally:
            if token is not None:
                _current_profiler.reset(token)
            span.end_ns = span_clock_ns()
            span.attributes["cpu_ns"] = time.thread_time_ns() - cpu0
            with self._lock:
                tallies = dict(self._tallies)
            for k, v in tallies.items():
                span.attributes[k] = v
            self._finish(span)

    @contextlib.contextmanager
    def operator_span(self, op: str, node_id: str):
        """One span per operator iterator; yields the mutable frame the
        executor's morsel loop accumulates into."""
        span = self._new_span(f"daft.op.{op}", self._parent_id(),
                              {"operator": op, "plan_node": node_id})
        frame = _OpFrame(span)
        try:
            yield frame
        except BaseException as e:  # noqa: BLE001 — annotate + re-raise
            if not isinstance(e, GeneratorExit):
                span.status = "ERROR"
                span.attributes["error"] = repr(e)
            raise
        finally:
            span.end_ns = span_clock_ns()
            a = span.attributes
            if frame.self_timed:
                # Stage-timed operator: busy/cpu are worker-side WORK
                # (summed across concurrent pulls — can exceed the span
                # interval); the consumer-side pull time is queue wait,
                # exported separately so parents subtract the wait they
                # actually saw instead of parallel work they never paid.
                a["busy_ns"] = frame.work_ns
                a["cpu_ns"] = frame.work_cpu_ns
                a["consumer_wait_ns"] = frame.busy_ns
                a["worker_morsels"] = frame.work_morsels
                a["self_timed"] = True
            else:
                a["busy_ns"] = frame.busy_ns
                a["cpu_ns"] = frame.cpu_ns
            a["morsels"] = frame.morsels
            a["rows_out"] = frame.rows_out
            a["bytes_out"] = frame.bytes_out
            for k in ("spill_bytes", "permit_wait_ns", "device_rows",
                      "fallback_rows"):
                v = getattr(frame, k)
                if v:
                    a[k] = v
            self._finish(span)

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        """Generic child span (input binding, shuffle fetch, …)."""
        span = self._new_span(name, self._parent_id(), attrs)
        try:
            yield span
        except BaseException as e:  # noqa: BLE001 — annotate + re-raise
            if not isinstance(e, GeneratorExit):
                span.status = "ERROR"
                span.attributes["error"] = repr(e)
            raise
        finally:
            span.end_ns = span_clock_ns()
            self._finish(span)


def profiled_task_scope(prof: Optional[TaskProfiler], task=None, **kw):
    """Nullcontext when ``prof`` is None, else the worker-side task root
    span — the ONE conditional-entry choreography every wire path
    (LocalWorker, process worker, daemon, native runner) shares, so a
    task-span change lands identically on all of them. ``kw`` passes
    through to :meth:`TaskProfiler.task_scope` (``name=``, ``ambient=``,
    span attributes)."""
    if prof is None:
        return contextlib.nullcontext()
    return prof.task_scope(task, **kw)


# --------------------------------------------------------------------- #
# QueryProfile (driver side)                                            #
# --------------------------------------------------------------------- #
class QueryProfile:
    """The driver's per-query trace: the root span, the driver's spans and
    every operator span of its task profiler, exported as Chrome
    trace-event JSON."""

    MAX_SPANS = 50_000

    def __init__(self, query_id: str, export_path: Optional[str] = None):
        self.query_id = query_id
        self.export_path = export_path
        self.trace_id = new_trace_id()
        self.root = Span(name="daft.query", trace_id=self.trace_id,
                         span_id=new_span_id(),
                         start_ns=span_clock_ns(),
                         attributes={"query_id": query_id,
                                     "worker_id": "driver"})
        self.finished = False
        self.error: Optional[str] = None
        self.request: Optional[ProfileRequest] = None
        self._lock = threading.Lock()
        self._wires: List[dict] = []
        self._dropped = 0
        # (monotonic stamp | None-when-final, rows) — see timeline().
        self._timeline_cache: Optional[Tuple[Optional[float], dict]] = None

    def local_task_profiler(self) -> TaskProfiler:
        """A driver-local TaskProfiler feeding this profile directly (the
        native runner's executor runs in-process)."""
        return TaskProfiler(self.trace_id, self.root.span_id, self.query_id,
                            worker_id="driver", sink=self.add_wires)

    # -- ingestion --------------------------------------------------------
    def add_wires(self, wires: Optional[List[dict]]) -> None:
        if not wires:
            return
        with self._lock:
            for w in wires:
                if len(self._wires) >= self.MAX_SPANS:
                    self._dropped += 1
                    continue
                self._wires.append(w)

    @contextlib.contextmanager
    def driver_span(self, name: str, **attrs):
        """Driver-side child span of the query root (plan/optimize etc.)."""
        span = Span(name=name, trace_id=self.trace_id,
                    span_id=new_span_id(),
                    parent_id=self.root.span_id, start_ns=span_clock_ns(),
                    attributes=dict(attrs, query_id=self.query_id,
                                    worker_id="driver"))
        try:
            yield span
        except BaseException as e:  # noqa: BLE001 — annotate + re-raise
            if not isinstance(e, GeneratorExit):
                span.status = "ERROR"
                span.attributes["error"] = repr(e)
            raise
        finally:
            span.end_ns = span_clock_ns()
            self.add_wires([span_to_wire(span)])

    # -- finalization -----------------------------------------------------
    def finish(self, error: Optional[str] = None) -> None:
        self.root.end_ns = span_clock_ns()
        if error:
            self.root.status = "ERROR"
            self.root.attributes["error"] = str(error)[:200]
        self.error = error
        self.finished = True
        if self.export_path:
            self.write_chrome_trace(self.export_path)

    # -- assembly / export ------------------------------------------------
    def spans(self) -> List[Span]:
        """Every collected span plus the root."""
        with self._lock:
            wires = list(self._wires)
        root = Span(name=self.root.name, trace_id=self.trace_id,
                    span_id=self.root.span_id, start_ns=self.root.start_ns,
                    end_ns=self.root.end_ns or span_clock_ns(),
                    status=self.root.status,
                    attributes=dict(self.root.attributes))
        out = [root]
        out.extend(span_from_wire(w) for w in wires)
        return out

    def to_chrome_trace(self) -> dict:
        """Chrome trace-event JSON (the Perfetto/chrome://tracing format):
        one process per worker, one thread lane per operator, complete
        ("X") events carrying span attributes as args."""
        spans = sorted(self.spans(), key=lambda s: s.start_ns)
        base = spans[0].start_ns if spans else 0
        pids: Dict[str, int] = {}
        tids: Dict[Tuple[int, str], int] = {}
        events: List[dict] = []
        for s in spans:
            wid = str(s.attributes.get("worker_id") or "driver")
            pid = pids.get(wid)
            if pid is None:
                pid = pids[wid] = len(pids) + 1
                events.append({"ph": "M", "name": "process_name",
                               "pid": pid, "tid": 0,
                               "args": {"name": wid}})
            lane = str(s.attributes.get("operator") or s.name)
            tid = tids.get((pid, lane))
            if tid is None:
                tid = tids[(pid, lane)] = \
                    sum(1 for k in tids if k[0] == pid) + 1
                events.append({"ph": "M", "name": "thread_name",
                               "pid": pid, "tid": tid,
                               "args": {"name": lane}})
            end = s.end_ns or s.start_ns
            events.append({
                "ph": "X", "cat": "daft", "name": s.name,
                "pid": pid, "tid": tid,
                "ts": (s.start_ns - base) / 1000.0,
                "dur": max(end - s.start_ns, 0) / 1000.0,
                "args": dict(s.attributes, status=s.status),
            })
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": {"trace_id": self.trace_id,
                              "query_id": self.query_id,
                              "dropped_spans": self._dropped}}

    def write_chrome_trace(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f)

    def operator_table(self, by: str = "operator") -> List[dict]:
        """Per-operator aggregate over the trace's ``daft.op.*`` spans:
        rows/bytes out, inclusive wall, SELF wall/CPU (inclusive minus
        direct children — on a serial chain self sums ≈ query time), spill
        bytes, and memory-permit wait; sorted by self wall descending (the
        EXPLAIN ANALYZE table). ``by="plan_node"`` keys rows on the plan
        node id (``HashJoin#3``) instead of the operator name, so two
        instances of one operator stay attributable — the granularity the
        perf observatory's span-diff reports regress against."""
        ops = [s for s in self.spans() if s.name.startswith("daft.op.")]
        # Parent-child subtraction uses each child's CONSUMER-VISIBLE time:
        # a pull-timed child's busy IS what its parent's pull included, but
        # a stage-timed (self_timed) child's busy is parallel worker WORK
        # the parent never paid — the parent only saw the child's queue
        # wait (consumer_wait_ns). CPU of a stage child burns on pool
        # threads, never inside the parent's pull, so it subtracts as 0.
        child_busy: Dict[str, int] = {}
        child_cpu: Dict[str, int] = {}
        by_id = {s.span_id for s in ops}
        for s in ops:
            p = s.parent_id
            if p in by_id:
                a = s.attributes
                if a.get("self_timed"):
                    visible_busy = int(a.get("consumer_wait_ns", 0))
                    visible_cpu = 0
                else:
                    visible_busy = int(a.get("busy_ns", 0))
                    visible_cpu = int(a.get("cpu_ns", 0))
                child_busy[p] = child_busy.get(p, 0) + visible_busy
                child_cpu[p] = child_cpu.get(p, 0) + visible_cpu
        agg: Dict[str, dict] = {}
        for s in ops:
            a = s.attributes
            op = str(a.get("operator") or s.name)
            key = op if by != "plan_node" else str(a.get("plan_node") or op)
            busy = int(a.get("busy_ns", 0))
            cpu = int(a.get("cpu_ns", 0))
            r = agg.setdefault(key, {
                "operator": op, "rows": 0, "wall_ns": 0, "self_wall_ns": 0,
                "self_cpu_ns": 0, "bytes_out": 0, "spill_bytes": 0,
                "permit_wait_ns": 0, "morsels": 0, "device_rows": 0,
                "fallback_rows": 0})
            if by == "plan_node":
                r["plan_node"] = key
            r["rows"] += int(a.get("rows_out", 0))
            r["morsels"] += int(a.get("morsels", 0))
            r["wall_ns"] += busy
            if a.get("self_timed"):
                # Stage-timed: busy is already SELF work (the kernel never
                # pulls its child — the feeder does), aggregated into the
                # one span this plan node owns.
                r["self_wall_ns"] += busy
                r["self_cpu_ns"] += cpu
            else:
                r["self_wall_ns"] += max(busy - child_busy.get(s.span_id, 0), 0)
                r["self_cpu_ns"] += max(cpu - child_cpu.get(s.span_id, 0), 0)
            r["bytes_out"] += int(a.get("bytes_out", 0))
            r["spill_bytes"] += int(a.get("spill_bytes", 0))
            r["permit_wait_ns"] += int(a.get("permit_wait_ns", 0))
            r["device_rows"] += int(a.get("device_rows", 0))
            r["fallback_rows"] += int(a.get("fallback_rows", 0))
        return sorted(agg.values(), key=lambda r: -r["self_wall_ns"])

    #: The dashboard polls the timeline every second; more rows than this
    #: freezes the browser tab long before they are readable as a Gantt.
    #: Longest-duration spans win — the bottleneck bars are the point.
    MAX_TIMELINE_ROWS = 2_000
    #: While the query still runs, serve a snapshot at most this stale:
    #: rebuilding a near-MAX_SPANS store per 1s poll would monopolize the
    #: dashboard's single-threaded HTTP handler.
    TIMELINE_TTL_S = 0.9

    def timeline(self) -> dict:
        """Flat span rows for the dashboard's Gantt view (ms relative to
        the query root). A FINISHED profile never changes, so its rows are
        built once and cached; a RUNNING one is rebuilt at most once per
        TTL — the dashboard's 1s poll must not re-deserialize a 50k-span
        store on the single-threaded handler."""
        cached = self._timeline_cache
        if cached is not None:
            if self.finished and cached[0] is None:
                return cached[1]
            if cached[0] is not None \
                    and time.monotonic() - cached[0] < self.TIMELINE_TTL_S:
                return cached[1]
        spans = sorted(self.spans(), key=lambda s: s.start_ns)
        base = spans[0].start_ns if spans else 0
        if len(spans) > self.MAX_TIMELINE_ROWS:
            spans = sorted(
                spans,
                key=lambda s: (s.end_ns or s.start_ns) - s.start_ns,
                reverse=True)[:self.MAX_TIMELINE_ROWS]
            spans.sort(key=lambda s: s.start_ns)
        rows = []
        for s in spans:
            end = s.end_ns or s.start_ns
            rows.append({
                "name": s.name,
                "worker": str(s.attributes.get("worker_id") or "driver"),
                "lane": str(s.attributes.get("operator") or s.name),
                "start_ms": (s.start_ns - base) / 1e6,
                "dur_ms": max(end - s.start_ns, 0) / 1e6,
                "status": s.status,
                "rows": s.attributes.get("rows_out"),
            })
        out = {"query_id": self.query_id, "trace_id": self.trace_id,
               "finished": self.finished, "spans": rows}
        # (None, out) = immutable finished snapshot; (stamp, out) = TTL'd.
        self._timeline_cache = (None if self.finished else time.monotonic(),
                                out)
        return out


# --------------------------------------------------------------------- #
# Driver-side store + lifecycle                                         #
# --------------------------------------------------------------------- #
_profiles_lock = threading.Lock()
_PROFILES: Dict[str, QueryProfile] = {}
_FINISHED: "OrderedDict[str, QueryProfile]" = OrderedDict()
_MAX_FINISHED = 8
_LAST: Optional[QueryProfile] = None


def begin_query(query_id: str, cfg=None) -> Optional[QueryProfile]:
    """Open a QueryProfile when profiling is requested — by the ambient
    ``collect(profile=...)`` scope, ``DAFT_PROFILE``, or the config knob
    (``profile_enabled``). Returns None (and costs nothing downstream)
    otherwise."""
    req = _request.get()
    active = req is not None
    path = req.path if req is not None else None
    if not active:
        from daft_tpu_torch.config import daft_env, daft_env_flag

        # An explicitly set DAFT_PROFILE wins in both directions (the live
        # process-wide switch); the config decides only when it is unset.
        if daft_env("DAFT_PROFILE") is not None:
            active = daft_env_flag("DAFT_PROFILE", False)
        else:
            active = bool(getattr(cfg, "profile_enabled", False))
        # The env/config export path applies only to env/config-triggered
        # profiling: an explicit collect(profile=True) scope asked for an
        # IN-MEMORY trace (and explain-analyze's internal scope must not
        # overwrite a file DAFT_PROFILE_FILE was set to keep).
        if active:
            path = daft_env("DAFT_PROFILE_FILE") \
                or getattr(cfg, "profile_export_path", None)
    if not active:
        return None
    prof = QueryProfile(query_id, export_path=path)
    prof.request = req
    with _profiles_lock:
        _PROFILES[query_id] = prof
    return prof


def force_begin_query(query_id: str,
                      export_path: Optional[str] = None) -> Optional[QueryProfile]:
    """Open a QueryProfile unconditionally for a query already started:
    the tail sampler's entry point (``querylog.maybe_autoprofile``), which
    decides after planning that this plan fingerprint deserves a trace,
    after :func:`begin_query` said no. Idempotent per query id (an open
    profile is returned); the runner's ``end_query`` finishes it like any
    other."""
    with _profiles_lock:
        existing = _PROFILES.get(query_id)
        if existing is not None:
            return existing
    prof = QueryProfile(query_id, export_path=export_path)
    with _profiles_lock:
        return _PROFILES.setdefault(query_id, prof)


def end_query(query_id: str, error: Optional[str] = None) -> Optional[QueryProfile]:
    """Finalize + export the query's profile (root span closed, Chrome
    trace written when a path was configured)."""
    global _LAST
    with _profiles_lock:
        prof = _PROFILES.pop(query_id, None)
    if prof is None:
        return None
    prof.finish(error=error)
    if prof.request is not None:
        # Hand the finished profile back to ITS collect_profile scope —
        # last_profile() is a process-global that a concurrent query's
        # end_query can replace before the caller reads it.
        prof.request.profile = prof
    with _profiles_lock:
        _FINISHED[query_id] = prof
        while len(_FINISHED) > _MAX_FINISHED:
            _FINISHED.popitem(last=False)
        _LAST = prof
    return prof


def last_profile() -> Optional[QueryProfile]:
    """The most recently finished QueryProfile (collect(profile=True))."""
    return _LAST


def profile_for(query_id: str) -> Optional[QueryProfile]:
    with _profiles_lock:
        return _PROFILES.get(query_id) or _FINISHED.get(query_id)


def timeline_json(query_id: str) -> Optional[dict]:
    prof = profile_for(query_id)
    return prof.timeline() if prof is not None else None

