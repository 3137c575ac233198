"""The query profiler in the port (``daft_tpu_torch/profiling.py``, the
executor's spans and ``DataFrame.collect(profile=...)``) beside the JAX
package's, on the CPU.

Mirrors ``tests/test_profiler.py`` case for case: the span clock, the Chrome
trace schema (golden-pinned, and the same keys as the JAX package's trace of
the same query), operator spans and their rows, the self-time table, the
inert disabled path, the profile on the DataFrame, a planning failure that
must not leak its profile, interleaved lazy profiled queries, the span wire,
EXPLAIN ANALYZE's operator table, the timeline (through
``profiling.timeline_json``, the data the dashboard's route serves) and the
parallel stage attribution at the default pool and at
``num_compute_threads=1``. The ``DAFT_PROFILE`` / ``DAFT_PROFILE_FILE``
cases set the variables as the JAX test does. Beyond the JAX file: the span cap's dropped count (beside the JAX
package's), a failing driver span, a profile finished with an error, the
ambient task profiler per resumption, and the ``note_*`` hooks' fallback
onto the task profiler.

Left out, with the modules they need: ``test_trace_context_rides_task_
through_pickle_wire``, ``test_distributed_single_trace_covers_driver_and_
workers``, ``test_distributed_operator_table_merges_worker_spans``,
``test_worker_killed_mid_task_exports_partial_error_span``,
``test_speculative_attempt_carries_attempt_number``, ``test_daemon_
heartbeat_ships_spans_and_clock``, ``test_clock_skew_rtt_midpoint_
correction``, ``test_clock_skew_noisy_sample_does_not_clobber_crisp_one``,
``test_clock_skew_reanchors_after_lasting_rtt_shift`` and ``test_worker_
buffer_overflow_is_counted_not_silent`` (the distributed runner's tasks,
workers, daemon, dispatcher, span buffers and clock offsets, ROADMAP A.8),
and ``test_dtl009_span_outside_with`` (the JAX package's lint, which the
port does not have).
"""

import json
import time
import types
import warnings

import numpy as np
import pytest

import daft_tpu
import daft_tpu_torch
from daft_tpu_torch import col, profiling
from daft_tpu_torch.tracing import Span, span_clock_ns

pytestmark = pytest.mark.filterwarnings("ignore:Specifying null_placement:FutureWarning")


@pytest.fixture(autouse=True)
def _clean_profiler_state():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        with daft_tpu_torch.execution_config_ctx(device="cpu"):
            yield


def small_df(pkg=daft_tpu_torch):
    return pkg.from_pydict({"a": list(range(400)), "b": [i % 5 for i in range(400)]})


def profiled_query(path=None, pkg=daft_tpu_torch):
    q = (small_df(pkg).where(pkg.col("a") > 10)
         .groupby("b").agg(pkg.col("a").sum().alias("s")).sort("s"))
    q.collect(profile=path or True)
    return q.query_profile


# ------------------------------------------------------------------ #
# Span clock                                                           #
# ------------------------------------------------------------------ #
def test_span_clock_monotonic_and_wall_anchored():
    t0 = span_clock_ns()
    samples = [span_clock_ns() for _ in range(100)]
    assert all(b >= a for a, b in zip(samples, samples[1:]))
    assert abs(span_clock_ns() - time.time_ns()) < 60 * 1_000_000_000
    assert span_clock_ns() >= t0


def test_spans_never_negative_duration():
    prof = profiled_query()
    for s in prof.spans():
        assert s.end_ns >= s.start_ns, s.name


# ------------------------------------------------------------------ #
# Chrome trace-event export: golden schema pin                         #
# ------------------------------------------------------------------ #
def _chrome_schema(trace):
    """The schema of a Chrome trace: top-level keys, event phases, the keys
    of each phase's events and the named lanes."""
    events = trace["traceEvents"]
    return (sorted(trace), sorted(trace["otherData"]), trace["displayTimeUnit"],
            sorted({(e["ph"], tuple(sorted(e))) for e in events}),
            sorted({e["args"]["name"] for e in events
                    if e["ph"] == "M" and e["name"] == "thread_name"}))


def test_chrome_trace_schema_golden(tmp_path):
    path = str(tmp_path / "trace.json")
    profiled_query(path)
    with open(path) as f:
        trace = json.load(f)  # must be valid JSON (Perfetto loads it)
    assert sorted(trace.keys()) == ["displayTimeUnit", "otherData", "traceEvents"]
    assert trace["displayTimeUnit"] == "ms"
    assert sorted(trace["otherData"].keys()) == ["dropped_spans", "query_id", "trace_id"]
    events = trace["traceEvents"]
    assert events
    assert {e["ph"] for e in events} == {"M", "X"}
    for e in events:
        if e["ph"] == "M":
            assert e["name"] in ("process_name", "thread_name")
            assert set(e) >= {"ph", "name", "pid", "tid", "args"}
            assert "name" in e["args"]
        else:
            assert set(e) == {"ph", "cat", "name", "pid", "tid", "ts", "dur", "args"}
            assert e["ts"] >= 0 and e["dur"] >= 0
            assert e["args"]["status"] in ("OK", "ERROR")
    proc_names = {e["args"]["name"] for e in events
                  if e["ph"] == "M" and e["name"] == "process_name"}
    assert "driver" in proc_names
    lanes = {e["args"]["name"] for e in events
             if e["ph"] == "M" and e["name"] == "thread_name"}
    assert any(lane.startswith("Agg") or lane == "Filter" for lane in lanes)
    # The JAX package's trace of the same query has the same schema and lanes.
    jax_path = str(tmp_path / "jax_trace.json")
    with daft_tpu.execution_config_ctx(result_cache_enabled=False):
        profiled_query(jax_path, pkg=daft_tpu)
    with open(jax_path) as f:
        assert _chrome_schema(json.load(f)) == _chrome_schema(trace)


def test_operator_spans_record_timing_and_rows():
    prof = profiled_query()
    ops = [s for s in prof.spans() if s.name.startswith("daft.op.")]
    assert ops
    by_op = {s.attributes["operator"]: s for s in ops}
    assert "Filter" in by_op and "Sort" in by_op
    f = by_op["Filter"].attributes
    assert f["rows_out"] == 389 and f["morsels"] >= 1
    assert f["busy_ns"] >= 0 and f["cpu_ns"] >= 0 and f["bytes_out"] > 0
    assert f["plan_node"].startswith("Filter#")
    # Every span shares ONE trace id, parented under the query root.
    roots = [s for s in prof.spans() if s.name == "daft.query"]
    assert len(roots) == 1
    assert {s.trace_id for s in prof.spans()} == {prof.trace_id}


def test_operator_table_self_time_sorted():
    prof = profiled_query()
    table = prof.operator_table()
    assert table
    selfs = [r["self_wall_ns"] for r in table]
    assert selfs == sorted(selfs, reverse=True)
    total = {r["operator"]: r for r in table}
    assert total["InMemorySource"]["rows"] == 400
    for r in table:
        assert 0 <= r["self_wall_ns"] <= r["wall_ns"] or r["wall_ns"] == 0


def test_profile_disabled_is_inert():
    df = small_df().where(col("a") > 10)
    before = profiling.last_profile()
    df.collect()  # no profile requested
    assert profiling.last_profile() is before
    # Hot-path hooks are no-ops with nothing active.
    profiling.note_spill(123)
    profiling.note_permit_wait(0.5)
    profiling.note_device(10, fused=True)


def test_daft_profile_0_overrides_baked_config(monkeypatch):
    # DAFT_PROFILE is the live process-wide switch: explicitly =0 wins over a
    # config that says profile_enabled=True; unset, the config decides.
    baked = types.SimpleNamespace(profile_enabled=True)
    monkeypatch.setenv("DAFT_PROFILE", "0")
    assert profiling.begin_query("q-env-off", baked) is None
    monkeypatch.delenv("DAFT_PROFILE")
    assert profiling.begin_query("q-cfg-off", types.SimpleNamespace(profile_enabled=False)) \
        is None
    prof = profiling.begin_query("q-cfg-on", baked)
    assert prof is not None
    profiling.end_query("q-cfg-on")
    before = profiling.last_profile()
    with daft_tpu_torch.execution_config_ctx(profile_enabled=True):
        small_df().where(col("a") > 10).collect()
    assert profiling.last_profile() is not before


def test_collect_profile_true_lands_on_dataframe():
    df = small_df().where(col("a") > 10)
    assert df.query_profile is None
    df.collect(profile=True)
    # THIS query's finished profile, not the racy process-global.
    assert df.query_profile is not None and df.query_profile.finished
    assert df.query_profile.operator_table()


def test_planning_failure_does_not_leak_profile(monkeypatch):
    # begin_query registers the profile before the execution's try/finally
    # exists: a failure in translate must still close it.
    import daft_tpu_torch.physical.translate as translate_mod

    def boom(plan, *args, **kwargs):
        raise RuntimeError("untranslatable")

    monkeypatch.setattr(translate_mod, "translate", boom)
    with profiling.collect_profile() as req:
        with pytest.raises(RuntimeError, match="untranslatable"):
            small_df().where(col("a") > 10).collect()
    assert profiling._PROFILES == {}
    assert req.profile is not None and req.profile.error is not None


def test_interleaved_lazy_profiled_queries_do_not_clobber(monkeypatch):
    # The native runner's run_iter is a GENERATOR: its ambient-profiler
    # contextvar must be set per resumption, not for the generator's
    # lifetime.
    monkeypatch.setenv("DAFT_PROFILE", "1")
    it_a = small_df().where(col("a") > 10).iter_partitions()
    it_b = small_df().where(col("a") > 100).iter_partitions()
    next(it_a)
    next(it_b)  # B's scope opens while A is mid-flight
    # Between resumptions the caller's context carries NO profiler.
    assert profiling._current_profiler.get() is None
    for it in (it_a, it_b):
        for _ in it:
            pass
    assert profiling._current_profiler.get() is None


# ------------------------------------------------------------------ #
# Wire round-trips                                                     #
# ------------------------------------------------------------------ #
def test_span_wire_roundtrip():
    span = Span(name="daft.op.Filter", trace_id="t" * 32, span_id="s" * 16,
                parent_id="p" * 16, start_ns=123, end_ns=456,
                status="ERROR", attributes={"operator": "Filter",
                                            "rows_out": 7, "partial": True})
    wire = profiling.span_to_wire(span)
    assert profiling.span_from_wire(wire) == span
    # The JAX package's wire for the same span is the same dict.
    from daft_tpu import profiling as jax_profiling
    from daft_tpu.tracing import Span as JaxSpan

    assert jax_profiling.span_to_wire(JaxSpan(**vars(span))) == wire


def test_query_profile_caps_spans_and_counts_the_rest(monkeypatch):
    from daft_tpu import profiling as jax_profiling
    from daft_tpu.tracing import Span as JaxSpan

    dropped = []
    for mod, span_cls in ((profiling, Span), (jax_profiling, JaxSpan)):
        monkeypatch.setattr(mod.QueryProfile, "MAX_SPANS", 5)
        prof = mod.QueryProfile("q-cap")
        span = span_cls(name="daft.op.X", trace_id=prof.trace_id, span_id="a" * 16,
                        start_ns=1, end_ns=2, attributes={"query_id": "q-cap"})
        prof.add_wires([mod.span_to_wire(span)] * 8)
        assert len(prof.spans()) == 1 + 5
        dropped.append(prof.to_chrome_trace()["otherData"]["dropped_spans"])
    assert dropped == [3, 3]


def test_driver_span_marks_an_error_and_reraises():
    prof = profiling.QueryProfile("q-drv")
    with pytest.raises(ValueError, match="bad plan"):
        with prof.driver_span("daft.plan", step="optimize"):
            raise ValueError("bad plan")
    (span,) = [s for s in prof.spans() if s.name == "daft.plan"]
    assert span.status == "ERROR" and "bad plan" in span.attributes["error"]
    assert span.parent_id == prof.root.span_id and span.attributes["step"] == "optimize"
    assert span.attributes["worker_id"] == "driver" and span.end_ns >= span.start_ns


def test_finish_with_an_error_marks_the_root_and_writes_the_export(tmp_path):
    path = tmp_path / "trace.json"
    prof = profiling.QueryProfile("q-fin", export_path=str(path))
    prof.finish(error="boom")
    assert prof.finished and prof.error == "boom"
    root = prof.spans()[0]
    assert root.status == "ERROR" and root.attributes["error"] == "boom"
    trace = json.loads(path.read_text())
    assert trace["otherData"]["query_id"] == "q-fin"
    (event,) = [e for e in trace["traceEvents"] if e["ph"] == "X"]
    assert event["name"] == "daft.query" and event["args"]["status"] == "ERROR"


def test_profiler_is_ambient_only_inside_each_resumption():
    tp = profiling.TaskProfiler("t" * 32, None, "q-amb")
    inside = []

    def gen():
        for i in range(3):
            inside.append(profiling._current_profiler.get())
            yield i

    outside = [profiling._current_profiler.get()
               for _ in profiling.iter_with_profiler_scope(gen(), tp)]
    assert inside == [tp] * 3 and outside == [None] * 3


def test_notes_without_a_frame_tally_on_the_ambient_task_profiler():
    tp = profiling.TaskProfiler("t" * 32, None, "q-notes")

    def gen():
        profiling.note_spill(100)
        profiling.note_device(5, fused=True)
        profiling.note_device(2, fused=False)
        profiling.note_permit_wait(0.25)
        yield 0

    # With no profiler open anywhere, every hook returns at its int check.
    list(profiling.iter_with_profiler_scope(gen(), tp))
    assert tp._tallies == {}
    with profiling._activation():
        list(profiling.iter_with_profiler_scope(gen(), tp))
    assert tp._tallies == {"spill_bytes": 100, "device_rows": 5, "fallback_rows": 2,
                           "permit_wait_ns": 250_000_000}


@pytest.mark.parametrize("via", ["env", "config"])
def test_profile_true_stays_in_memory_despite_env_file(tmp_path, monkeypatch, via):
    # DAFT_PROFILE_FILE (and its config spelling profile_export_path)
    # applies to env- or config-triggered profiling only: an explicit
    # collect(profile=True) asked for an in-memory trace.
    target = tmp_path / "keep.json"
    target.write_text("sentinel")
    overrides = {}
    if via == "env":
        monkeypatch.setenv("DAFT_PROFILE_FILE", str(target))
    else:
        overrides["profile_export_path"] = str(target)
    with daft_tpu_torch.execution_config_ctx(**overrides):
        with profiling.collect_profile() as req:
            small_df().where(col("a") > 10).collect()
    assert req.profile is not None and req.profile.export_path is None
    assert target.read_text() == "sentinel"


# ------------------------------------------------------------------ #
# EXPLAIN ANALYZE per-operator table, timeline                         #
# ------------------------------------------------------------------ #
def test_explain_analyze_operator_table(capsys):
    q = small_df().where(col("a") > 100).groupby("b").agg(col("a").sum().alias("s"))
    q.explain(analyze=True)
    out = capsys.readouterr().out
    assert "== Analyze ==" in out
    assert "operators (by self time):" in out
    assert "permit_ms" in out and "spill" in out
    assert "Filter" in out


def test_dashboard_timeline_endpoint():
    # The dashboard's /api/queries/<id>/timeline route (ROADMAP A.8) serves
    # profiling.timeline_json: the port holds the data it would serve.
    prof = profiled_query()
    tl = profiling.timeline_json(prof.query_id)
    assert tl is not None and tl["query_id"] == prof.query_id
    assert tl["trace_id"] == prof.trace_id and tl["finished"]
    assert tl["spans"]
    for row in tl["spans"]:
        assert row["start_ms"] >= 0 and row["dur_ms"] >= 0
        assert row["worker"] and row["lane"]
    # An unknown query has no timeline (the route's 404).
    assert profiling.timeline_json("nope") is None


# ------------------------------------------------------------------ #
# Parallel stage attribution                                            #
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("threads", [4, 1])
def test_parallel_stage_span_attribution(threads):
    """A stage's morsels are pulled by several pool threads (or, at one
    thread, serially), yet per-pull wall/CPU aggregates into exactly ONE span
    per plan node, the worker-side work is the span's self time, and the
    consumer-side queue wait is exported separately."""
    n = 400_000
    rng = np.random.default_rng(5)
    df = daft_tpu_torch.from_pydict({
        "a": rng.integers(0, 1_000_000, n),
        "b": rng.random(n),
        "g": rng.integers(0, 64, n)})
    dim = daft_tpu_torch.from_pydict({"k": np.arange(1_000_000, dtype=np.int64),
                                      "w": rng.random(1_000_000)})
    q = (df.where((col("a") % 7 > 0) & (col("b") < 0.97))
           .with_column("c", col("b") * 2.0 + 1.0)
           .where(col("c") > 1.1)
           .join(dim, left_on="a", right_on="k")
           .groupby("g").agg(col("c").sum().alias("s"), col("w").mean().alias("m"))
           .sort("g"))
    with daft_tpu_torch.execution_config_ctx(num_compute_threads=threads,
                                             default_morsel_size=16_384):
        t0 = time.perf_counter()
        q.collect(profile=True)
        wall_ns = (time.perf_counter() - t0) * 1e9
    prof = q.query_profile
    ops = [s for s in prof.spans() if s.name.startswith("daft.op.")]
    nodes = [s.attributes["plan_node"] for s in ops]
    assert len(nodes) == len(set(nodes))
    staged = [s for s in ops if s.attributes.get("self_timed")]
    assert staged, "no stage-timed spans"
    for s in staged:
        a = s.attributes
        assert a["busy_ns"] > 0
        assert "consumer_wait_ns" in a
    filt = next(s for s in ops
                if s.attributes["operator"] == "Filter" and s.attributes.get("self_timed"))
    assert filt.attributes["worker_morsels"] >= 4
    assert filt.attributes["morsels"] >= 4
    assert filt.attributes["rows_out"] > 0
    table = prof.operator_table(by="plan_node")
    assert sum(r["self_wall_ns"] for r in table) <= 4 * wall_ns
