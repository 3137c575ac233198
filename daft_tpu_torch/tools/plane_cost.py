"""What the observability plane costs the host per operator-morsel and per
query, timed in tight loops.

The metrics registry and ``RuntimeStats`` are on for every query. Each
operator's stream runs through ``Executor._instrumented``: a generator layer,
two clock reads, a pull-stack entry, two counter increments and one
``RuntimeStats.record_pull``. The device layer adds counter increments per
morsel (``record_fused``, ``record_chain``, ``record_fallback``), and each
query adds its prologue and epilogue (``QueryStart`` / ``QueryEnd`` through
``context.notify`` and one ``OperatorStats`` event per operator). A query's
wall varies from rep to rep by more than the JAX package's 2 % budget, so the
costs are taken here where they resolve to the nanosecond:

* ``bare_ns``: one morsel through a chain of ``depth`` pass-through
  generators (the operators' own streams), per morsel and level;
* ``instrumented_ns`` / ``instrumented_off_ns``: the same chain with each
  level wrapped in ``_instrumented``, with the registry on / off
  (``RuntimeStats`` records either way);
* ``per_morsel_ns``: ``instrumented_ns - bare_ns``, the plane's cost of one
  operator-morsel (one count of ``daft_executor_morsels_total``), and
  ``registry_per_morsel_ns``: ``instrumented_ns - instrumented_off_ns``, the
  registry's share of it;
* ``profiled_ns``: the same chain profiled as ``collect(profile=True)``
  profiles it (each level also in ``Executor._profiled``'s span), and
  ``profiled_per_morsel_ns``: ``profiled_ns - instrumented_ns``, what the
  profiler adds to one operator-morsel;
* ``counter_inc_ns`` / ``counter_inc_off_ns``: one labelled counter
  ``labels(...).inc()`` with the registry on / off, less an empty loop;
* ``per_query_ns``: ``QueryStart`` and ``QueryEnd`` notified and a
  ``RuntimeStats`` of ``ops`` operators flushed, with the subscribers the
  context holds (the registry's own attaches at the first notify);
* ``profiled_query_ns``: what a profiled query adds once: its
  ``QueryProfile`` opened and closed, the planning span, the task
  profiler's ``daft.execute`` span;
* ``recorder_query_ns``: the flight recorder's price per query: an entry
  begun, its admission, plan, cache and memory facts noted, one partition
  counted, and finished into a record (the ring, the counters, the SLO
  tracker's observation); ``admission_query_ns``: one uncontended
  ``admit`` and ``release`` of the admission controller; and
  ``front_door_query_ns``, their sum (:func:`front_door_ns`, on instances of
  its own under a tenant of its own, so the process's ring and tracker keep
  their state). These are bursts: the SLO tracker evaluates its windows
  every ``MIN_SAMPLES`` records, which spaced queries pay once per 0.25 s;
* :func:`front_door_spaced_ns`: the same price as a spaced query pays it:
  each record read the peak RSS and evaluates its tenant's windows, which
  hold ``window`` earlier records (``window=0``: a tenant's first queries;
  :data:`STEADY_WINDOW`: a tenant that has sent one query every 0.26 s for
  the whole slow window), each query timed alone, back to back
  (``gap_s=0``) or each after a pause of ``gap_s`` (its caches cold).

:func:`plane_seconds` turns a run's registry deltas into the seconds the
plane added to it; :func:`loop_overheads` turns one query's deltas into the
registry's and the profiler's own cost in % of the query's time. Each figure is the median of ``reps`` reps, the variants
interleaved rep by rep.

    python3 -m daft_tpu_torch.tools.plane_cost [--morsels N] [--reps R]

prints the figures as one JSON object. Host code only: it needs no device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time
from typing import Dict, Iterator

DEPTH = 3
OPS_PER_QUERY = 4


def _pass(it: Iterator) -> Iterator:
    for mp in it:
        yield mp


def _source(mp, n: int) -> Iterator:
    for _ in range(n):
        yield mp


def _drain(it: Iterator) -> None:
    for _ in it:
        pass


class PlaneCostOp:
    """A plan node for ``Executor._profiled``: its span takes the class's
    name, its label the node's id."""


def _chain_s(executor, mp, morsels: int, instrumented: bool) -> float:
    it = _source(mp, morsels)
    for level in range(DEPTH):
        it = _pass(it)
        if executor is not None and executor.profiler is not None:
            it = executor._profiled(PlaneCostOp(), it)
        if instrumented:
            it = executor._instrumented(f"Op{level}", it)
    t0 = time.perf_counter()
    _drain(it)
    return time.perf_counter() - t0


def _counter_s(child, calls: int) -> float:
    t0 = time.perf_counter()
    for _ in range(calls):
        child.inc()
    return time.perf_counter() - t0


def _empty_s(calls: int) -> float:
    t0 = time.perf_counter()
    for _ in range(calls):
        pass
    return time.perf_counter() - t0


def _query_s(queries: int) -> float:
    from daft_tpu_torch.context import get_context
    from daft_tpu_torch.execution.resource_manager import RuntimeStats
    from daft_tpu_torch.subscribers.events import QueryEnd, QueryStart

    ctx = get_context()
    t0 = time.perf_counter()
    for q in range(queries):
        qid = f"plane-cost-{q}"
        ctx.notify(QueryStart(query_id=qid, plan="Project"))
        stats = RuntimeStats(qid)
        for op in range(OPS_PER_QUERY):
            stats.record_pull(f"Op{op}", None, 1, 1)
        stats.flush()
        ctx.notify(QueryEnd(query_id=qid, duration_s=0.0, error=None))
    return time.perf_counter() - t0


def _profiled_query_s(queries: int) -> float:
    from daft_tpu_torch import profiling
    from daft_tpu_torch.context import get_context

    cfg = get_context().execution_config
    t0 = time.perf_counter()
    for q in range(queries):
        qid = f"plane-cost-profiled-{q}"
        with profiling.collect_profile():
            prof = profiling.begin_query(qid, cfg)
            with prof.driver_span("daft.plan"):
                pass
            tprof = prof.local_task_profiler()
            with profiling.profiled_task_scope(tprof, name="daft.execute", ambient=False):
                pass
            profiling.end_query(qid)
    return time.perf_counter() - t0


def _recorder_query_s(recorder, cfg, mp, queries: int) -> float:
    t0 = time.perf_counter()
    for q in range(queries):
        entry = recorder.begin(f"plane-cost-rec-{q}", cfg)
        entry.note_admission(0.0, 0)
        entry.observe_plan("Project")
        entry.note_caches(plan_hit=False, result_hit=False)
        entry.note_memory({"peak_held_bytes": 8})
        entry.count(mp)
        entry.finish()
    return time.perf_counter() - t0


def _admission_query_s(controller, cfg, queries: int) -> float:
    t0 = time.perf_counter()
    for q in range(queries):
        controller.admit(f"plane-cost-adm-{q}", tenant="plane-cost", cfg=cfg).release()
    return time.perf_counter() - t0


def front_door_ns(queries: int = 2000, reps: int = 5) -> Dict[str, float]:
    """The front door's price per query on this host, in ns (the medians of
    ``reps`` reps of ``queries`` each): ``recorder_query_ns``,
    ``admission_query_ns`` and their sum ``front_door_query_ns``."""
    from daft_tpu_torch import querylog, slo
    from daft_tpu_torch.context import get_context
    from daft_tpu_torch.execution import admission
    from daft_tpu_torch.micropartition import MicroPartition

    mp = MicroPartition.from_pydict({"x": [1]})
    cfg = get_context().execution_config
    recorder = querylog.FlightRecorder(ring_size=512)
    controller = admission.AdmissionController()
    saved_tracker = slo._TRACKER
    slo._TRACKER = slo.SLOTracker()
    tenant = admission._tenant_var.set("plane-cost")
    rec_s, adm_s = [], []
    try:
        for _ in range(reps):
            rec_s.append(_recorder_query_s(recorder, cfg, mp, queries))
            adm_s.append(_admission_query_s(controller, cfg, queries))
    finally:
        admission._tenant_var.reset(tenant)
        slo._TRACKER = saved_tracker
    rec_ns = statistics.median(rec_s) * 1e9 / queries
    adm_ns = statistics.median(adm_s) * 1e9 / queries
    return {"recorder_query_ns": rec_ns, "admission_query_ns": adm_ns,
            "front_door_query_ns": rec_ns + adm_ns}


#: Records in the slow window (300 s) of a tenant that sends one query per
#: 0.26 s, just over the SLO tracker's 0.25 s evaluation throttle.
STEADY_WINDOW = int(300.0 / 0.26)


def front_door_spaced_ns(queries: int = 200, window: int = 0,
                         gap_s: float = 0.0) -> Dict[str, float]:
    """The front door's price per query on this host, in ns, as spaced
    queries pay it (see the module's docstring): the medians over
    ``queries``, each timed alone, of ``recorder_query_ns``,
    ``admission_query_ns`` and ``front_door_query_ns``. Every record is
    evaluated (the tracker's throttle is 0 while this runs); ``window``
    earlier records, one per 0.26 s, sit in the tenant's windows; each query
    starts ``gap_s`` after the one before."""
    from daft_tpu_torch import querylog, slo
    from daft_tpu_torch.context import get_context
    from daft_tpu_torch.execution import admission
    from daft_tpu_torch.micropartition import MicroPartition

    mp = MicroPartition.from_pydict({"x": [1]})
    cfg = get_context().execution_config
    recorder = querylog.FlightRecorder(ring_size=512)
    controller = admission.AdmissionController()
    saved_tracker, saved_refresh = slo._TRACKER, slo._EVAL_REFRESH_S
    slo._TRACKER = tracker = slo.SLOTracker()
    slo._EVAL_REFRESH_S = 0.0
    tenant = admission._tenant_var.set("plane-cost")
    rec_s, adm_s = [], []
    try:
        _recorder_query_s(recorder, cfg, mp, 1)
        records = tracker._tenants["plane-cost"].records
        records.clear()
        now = time.monotonic()
        for i in range(window, 0, -1):
            records.append((now - i * 0.26, 0.001, False, False, True))
        for _ in range(queries):
            if gap_s:
                time.sleep(gap_s)
            rec_s.append(_recorder_query_s(recorder, cfg, mp, 1))
            adm_s.append(_admission_query_s(controller, cfg, 1))
    finally:
        admission._tenant_var.reset(tenant)
        slo._TRACKER, slo._EVAL_REFRESH_S = saved_tracker, saved_refresh
    return {"recorder_query_ns": statistics.median(rec_s) * 1e9,
            "admission_query_ns": statistics.median(adm_s) * 1e9,
            "front_door_query_ns": statistics.median(
                (r + a) * 1e9 for r, a in zip(rec_s, adm_s)),
            "window": window, "queries": queries, "gap_s": gap_s}


def measure(morsels: int = 200_000, reps: int = 9) -> Dict[str, float]:
    """The plane's costs on this host, in ns (see the module's docstring)."""
    from daft_tpu_torch import metrics, profiling
    from daft_tpu_torch.context import get_context
    from daft_tpu_torch.execution.executor import Executor
    from daft_tpu_torch.execution.resource_manager import RuntimeStats
    from daft_tpu_torch.micropartition import MicroPartition

    reg = metrics.get_registry()
    was = reg.enabled
    mp = MicroPartition.from_pydict({"x": [1]})
    calls = morsels * DEPTH
    queries = max(morsels // 100, 100)
    cfg = get_context().execution_config
    times = {k: [] for k in ("bare", "on", "off", "profiled", "inc_on", "inc_off", "empty",
                             "query", "profiled_query")}
    try:
        for _ in range(reps):
            times["bare"].append(_chain_s(None, mp, morsels, False))
            for key, enabled in (("on", True), ("off", False)):
                reg.enabled = enabled
                ex = Executor(cfg, stats=RuntimeStats("plane-cost"))
                times[key].append(_chain_s(ex, mp, morsels, True))
                times["inc_" + key].append(
                    _counter_s(metrics.COMPILED_CHAIN_MORSELS.labels("plane_cost"), calls))
            reg.enabled = True
            tprof = profiling.TaskProfiler(profiling.new_trace_id(), None, "plane-cost",
                                           sink=lambda wires: None)
            ex = Executor(cfg, stats=RuntimeStats("plane-cost"), profiler=tprof)
            times["profiled"].append(_chain_s(ex, mp, morsels, True))
            times["empty"].append(_empty_s(calls))
            times["query"].append(_query_s(queries))
            times["profiled_query"].append(_profiled_query_s(queries))
    finally:
        reg.enabled = was
    med = {k: statistics.median(v) for k, v in times.items()}
    per = 1e9 / calls
    return {
        "morsels": morsels, "depth": DEPTH, "reps": reps,
        "bare_ns": med["bare"] * per,
        "instrumented_ns": med["on"] * per,
        "instrumented_off_ns": med["off"] * per,
        "per_morsel_ns": (med["on"] - med["bare"]) * per,
        "registry_per_morsel_ns": (med["on"] - med["off"]) * per,
        "profiled_ns": med["profiled"] * per,
        "profiled_per_morsel_ns": (med["profiled"] - med["on"]) * per,
        "counter_inc_ns": (med["inc_on"] - med["empty"]) * per,
        "counter_inc_off_ns": (med["inc_off"] - med["empty"]) * per,
        "per_query_ns": med["query"] * 1e9 / queries,
        "profiled_query_ns": med["profiled_query"] * 1e9 / queries,
        "ops_per_query": OPS_PER_QUERY,
        **front_door_ns(queries, reps),
    }


def plane_seconds(cost: Dict[str, float], deltas: Dict[str, float]) -> Dict[str, float]:
    """The seconds the plane added to a run, from the run's registry deltas
    (``counter_deltas``) and :func:`measure`'s costs: its operator-morsels
    times ``per_morsel_ns``; the device layer's increments times
    ``counter_inc_ns``, counted high (two per fused expression, one per
    fallen-back expression, two per chain morsel: a call records one or
    more expressions); its queries times ``per_query_ns``."""
    morsels = deltas.get("daft_executor_morsels_total", 0.0)
    incs = (2 * deltas.get("daft_device_fused_exprs_total", 0.0)
            + deltas.get("daft_device_fallback_exprs_total", 0.0)
            + 2 * deltas.get("daft_compiled_chain_morsels_total", 0.0))
    queries = deltas.get("daft_queries_started_total", 0.0)
    parts = {"morsels_s": morsels * cost["per_morsel_ns"] / 1e9,
             "device_incs_s": incs * cost["counter_inc_ns"] / 1e9,
             "queries_s": queries * cost["per_query_ns"] / 1e9}
    parts["total_s"] = sum(parts.values())
    parts.update(morsels=morsels, device_incs=incs, queries=queries)
    return parts


def loop_overheads(cost: Dict[str, float], deltas: Dict[str, float],
                   off_s: float) -> Dict[str, float]:
    """The registry's and the profiler's own cost in one query whose run
    counted ``deltas`` (registry on), in % of ``off_s``, the query's time
    without the plane under test: the registry's share of each
    operator-morsel and each device-layer increment (counted high, as
    :func:`plane_seconds` counts them); the profiler's addition to each
    operator-morsel, and once its query-level spans."""
    morsels = deltas.get("daft_executor_morsels_total", 0.0)
    incs = plane_seconds(cost, deltas)["device_incs"]
    registry_s = (morsels * cost["registry_per_morsel_ns"]
                  + incs * (cost["counter_inc_ns"] - cost["counter_inc_off_ns"])) / 1e9
    profiler_s = (morsels * cost["profiled_per_morsel_ns"] + cost["profiled_query_ns"]) / 1e9
    return {"morsels": morsels, "device_incs": incs,
            "registry_s": registry_s, "registry_pct": 100.0 * registry_s / off_s,
            "profiler_s": profiler_s, "profiler_pct": 100.0 * profiler_s / off_s}


COUNTED = ("daft_executor_morsels_total", "daft_device_fused_exprs_total",
           "daft_device_fallback_exprs_total", "daft_compiled_chain_morsels_total",
           "daft_queries_started_total")


def counter_totals() -> Dict[str, float]:
    """The process registry's totals of the series :func:`plane_seconds`
    reads; subtract two of these for a run's deltas."""
    from daft_tpu_torch import metrics

    snap = metrics.get_registry().snapshot()
    return {name: snap.counter_total(name) for name in COUNTED}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--morsels", type=int, default=200_000)
    ap.add_argument("--reps", type=int, default=9)
    ap.add_argument("--spaced", type=int, default=0, metavar="QUERIES",
                    help="also price QUERIES spaced queries, at a fresh and a steady "
                         "window, back to back and 0.26 s apart")
    args = ap.parse_args(argv)
    out = measure(args.morsels, args.reps)
    if args.spaced:
        for window in (0, STEADY_WINDOW):
            for gap_s in (0.0, 0.26):
                out[f"spaced_window{window}_gap{gap_s}"] = front_door_spaced_ns(
                    args.spaced, window, gap_s)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
