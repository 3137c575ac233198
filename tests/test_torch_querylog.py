"""The flight recorder and the per-tenant SLO plane in the port
(``daft_tpu_torch/querylog.py``, ``slo.py``, the native runner's record on
every exit, ``subscribers/dashboard.py``'s ``/api/querylog`` and ``/api/slo``)
beside the JAX package's, on the CPU with ``device="cpu"``.

Mirrors ``tests/test_querylog.py`` case for case, less
``test_worker_kill_failed_then_recovery_success_records``: the distributed
runner and its worker kills are ROADMAP A.8.5. The SLO tracker's cases feed
the same records through both packages' trackers and compare their tables.
The dashboard case's web-app assets answer 501 naming A.8.6 (the app is not
ported). Beyond the JAX file:

* for each of 10 queries, the port's record has the JAX record's keys (less
  the feedback store's optional ``query_fingerprint`` / ``estimates``,
  ROADMAP A.8.6) and the same ``plan_fingerprint``, the two optimized plans
  being equal node for node;
* each package's JSONL lines load through the other's ``load_query_log``
  and pass its ``validate_record``;
* a recorder failure drops the record and keeps the query's own result or
  error; the view and feedback stubs raise naming their items.

Rows are exact; the records compare key for key.
"""

import json
import os
import threading
import time

import numpy as np
import pytest

import daft_tpu
import daft_tpu_torch
from daft_tpu import querylog as jql
from daft_tpu import slo as jslo
from daft_tpu.execution import admission as jadm
from daft_tpu_torch import col, querylog, slo
from daft_tpu_torch.context import execution_config_ctx
from daft_tpu_torch.errors import (
    DaftAdmissionError,
    DaftCancelledError,
    DaftError,
    DaftNotImplementedError,
    DaftTimeoutError,
)
from daft_tpu_torch.execution import admission as tadm
from daft_tpu_torch.querylog import (
    QUERYLOG_SCHEMA_VERSION,
    RECORD_REQUIRED,
    get_recorder,
    load_query_log,
    plan_fingerprint,
    validate_record,
)

#: The JAX record's optional keys that come from the feedback store
#: (ROADMAP A.8.6): the port never stamps them.
FEEDBACK_KEYS = {"query_fingerprint", "estimates"}


@pytest.fixture(autouse=True)
def _fresh_planes():
    """Both packages' recorders, SLO trackers and admission state fresh per
    test: process globals every collect feeds. The port on the CPU."""
    for rec, tracker, adm in ((get_recorder(), slo.get_tracker(), tadm),
                              (jql.get_recorder(), jslo.get_tracker(), jadm)):
        rec.reset()
        tracker.reset()
        adm.get_controller().reset()
        adm.set_tenant(None)
    with execution_config_ctx(device="cpu"):
        yield
    for rec, tracker, adm in ((get_recorder(), slo.get_tracker(), tadm),
                              (jql.get_recorder(), jslo.get_tracker(), jadm)):
        rec.reset()
        tracker.reset()
        adm.get_controller().reset()
        adm.set_tenant(None)


def make_df(data):
    return daft_tpu_torch.from_pydict(data)


def _one_new_record(before: int) -> dict:
    stats = get_recorder().stats()
    assert stats["total"] == before + 1, stats
    return get_recorder().recent(1)[0]


# --------------------------------------------------------------------- #
# The record: its schema and one record per outcome                      #
# --------------------------------------------------------------------- #
def test_success_record_schema_golden():
    make_df({"a": [1, 2, 3], "b": [1.0, 2.0, 3.0]}).where(col("a") > 1).collect()
    rec = _one_new_record(0)
    assert set(RECORD_REQUIRED) <= set(rec)
    assert rec["schema_version"] == QUERYLOG_SCHEMA_VERSION == jql.QUERYLOG_SCHEMA_VERSION
    assert RECORD_REQUIRED == jql.RECORD_REQUIRED
    assert rec["outcome"] == "success" and rec["error_kind"] == ""
    assert rec["tenant"] == "default" and rec["runner"] == "native"
    assert rec["rows_out"] == 2 and rec["bytes_out"] > 0
    assert len(rec["plan_fingerprint"]) == 16
    int(rec["plan_fingerprint"], 16)  # hex
    assert rec["duration_s"] >= 0 and rec["peak_rss_bytes"] > 0
    assert rec["view"] == {} and isinstance(rec["mem"], dict)
    assert validate_record(rec) == [] and jql.validate_record(rec) == []


def test_fingerprint_stable_across_repeats():
    def build():
        return make_df({"a": [1, 2, 3]}).where(col("a") > 1)

    build().collect()
    build().collect()
    make_df({"z": [5]}).collect()  # another shape
    recs = get_recorder().recent()
    assert recs[1]["plan_fingerprint"] == recs[2]["plan_fingerprint"]
    assert recs[0]["plan_fingerprint"] != recs[1]["plan_fingerprint"]
    assert plan_fingerprint("x") != plan_fingerprint("y")
    assert plan_fingerprint("x") == jql.plan_fingerprint("x")


def test_timeout_outcome():
    @daft_tpu_torch.udf.func(return_dtype=daft_tpu_torch.DataType.int64())
    def slow_fn(s):
        time.sleep(0.4)
        return s

    df = make_df({"x": list(range(9))}).into_partitions(3).select(slow_fn(col("x")))
    with pytest.raises(DaftTimeoutError):
        df.collect(timeout=0.3)
    rec = _one_new_record(0)
    assert rec["outcome"] == "timeout"
    assert rec["error_kind"] == "DaftTimeoutError"
    assert rec["plan_fingerprint"]  # planned before it died


def test_failed_outcome():
    @daft_tpu_torch.udf.func(return_dtype=daft_tpu_torch.DataType.int64())
    def boom(s):
        raise RuntimeError("kaboom")

    with pytest.raises(DaftError):
        make_df({"x": [1, 2, 3]}).select(boom(col("x"))).collect()
    rec = _one_new_record(0)
    assert rec["outcome"] == "failed"
    assert rec["error_kind"] and "kaboom" in rec["error"]


def test_cancelled_outcome():
    from daft_tpu_torch.subscribers.events import QueryStart

    @daft_tpu_torch.udf.func(return_dtype=daft_tpu_torch.DataType.int64())
    def slow_fn(s):
        time.sleep(0.3)
        return s

    started = threading.Event()
    qids = []

    class Watcher:
        def on_event(self, e):
            if isinstance(e, QueryStart):
                qids.append(e.query_id)
                started.set()

    ctx = daft_tpu_torch.get_context()
    w = Watcher()
    ctx.attach_subscriber(w)

    def cancel_soon():
        started.wait(10.0)
        time.sleep(0.1)
        daft_tpu_torch.cancel_query(qids[-1], reason="operator-abort")

    try:
        threading.Thread(target=cancel_soon, daemon=True).start()
        df = make_df({"x": list(range(9))}).into_partitions(3).select(slow_fn(col("x")))
        with pytest.raises(DaftCancelledError):
            df.collect()
    finally:
        ctx.detach_subscriber(w)
    rec = _one_new_record(0)
    assert rec["outcome"] == "cancelled"
    assert rec["error_kind"] == "DaftCancelledError"


def test_shed_outcome():
    """A queue-full rejection (the query never planned) lands one record."""
    ctl = tadm.get_controller()
    daft_tpu_torch.set_tenant_policy("crowded", max_concurrent_queries=1, queue_depth=1)
    cfg = daft_tpu_torch.get_context().execution_config
    held = ctl.admit("held-q", tenant="crowded", cfg=cfg)
    queued_release = threading.Event()

    def queued():
        t = ctl.admit("queued-q", tenant="crowded", cfg=cfg)
        queued_release.wait(10)
        t.release()

    blocker = threading.Thread(target=queued, daemon=True)
    blocker.start()
    deadline = time.monotonic() + 5
    while ctl.snapshot().get("crowded", {}).get("queued", 0) < 1 \
            and time.monotonic() < deadline:
        time.sleep(0.005)
    tadm.set_tenant("crowded")
    try:
        with pytest.raises(DaftAdmissionError):
            make_df({"a": [1]}).collect()
    finally:
        tadm.set_tenant(None)
        held.release()
        queued_release.set()
        blocker.join(timeout=10)
    rec = _one_new_record(0)
    assert rec["outcome"] == "shed"
    assert rec["tenant"] == "crowded"
    assert rec["error_kind"] == "DaftAdmissionError"
    assert rec["plan_fingerprint"] == ""  # rejected before planning


def test_recorder_kill_switch(monkeypatch):
    monkeypatch.setenv("DAFT_QUERY_RECORDER", "0")
    make_df({"a": [1]}).collect()
    assert get_recorder().stats()["total"] == 0
    monkeypatch.setenv("DAFT_QUERY_RECORDER", "1")
    make_df({"a": [1]}).collect()
    assert get_recorder().stats()["total"] == 1


def test_ring_is_bounded():
    rec = get_recorder()
    for i in range(rec.ring_size + 40):
        rec._publish({"schema_version": 1, "query_id": f"q{i}", "tenant": "default",
                      "runner": "native", "ts": time.time(), "outcome": "success",
                      "error_kind": "", "error": "", "duration_s": 0.001,
                      "plan_fingerprint": "", "admission_wait_s": 0.0, "shed_level": 0,
                      "rows_out": 0, "bytes_out": 0})
    stats = rec.stats()
    assert stats["ring"] == rec.ring_size == jql.get_recorder().ring_size
    assert stats["total"] == rec.ring_size + 40  # the totals keep counting
    assert rec.recent(1)[0]["query_id"] == f"q{rec.ring_size + 39}"


def test_recent_queries_filters():
    make_df({"a": [1, 2]}).collect()

    @daft_tpu_torch.udf.func(return_dtype=daft_tpu_torch.DataType.int64())
    def boom(s):
        raise ValueError("no")

    with pytest.raises(DaftError):
        make_df({"x": [1]}).select(boom(col("x"))).collect()
    assert len(daft_tpu_torch.recent_queries()) == 2
    assert [r["outcome"] for r in daft_tpu_torch.recent_queries(outcome="failed")] == ["failed"]
    assert daft_tpu_torch.recent_queries(tenant="nobody") == []


# --------------------------------------------------------------------- #
# The JSONL sink: golden lines, torn lines, rotation                     #
# --------------------------------------------------------------------- #
def test_sink_writes_schema_valid_jsonl(tmp_path, monkeypatch):
    path = str(tmp_path / "qlog.jsonl")
    monkeypatch.setenv("DAFT_QUERY_LOG", path)
    make_df({"a": [1, 2, 3]}).collect()
    make_df({"a": [4]}).collect()
    lines = [json.loads(ln) for ln in open(path) if ln.strip()]
    assert len(lines) == 2
    for rec in lines:
        assert validate_record(rec) == [], rec
    assert load_query_log(path) == lines


def test_sink_torn_line_resilience(tmp_path):
    path = str(tmp_path / "qlog.jsonl")
    good = {"schema_version": 1, "query_id": "q1", "tenant": "default", "runner": "native",
            "ts": 1.0, "outcome": "success", "error_kind": "", "error": "",
            "duration_s": 0.5, "plan_fingerprint": "ab", "admission_wait_s": 0.0,
            "shed_level": 0, "rows_out": 1, "bytes_out": 8}
    with open(path, "w") as f:
        f.write(json.dumps(good) + "\n")
        f.write('{"schema_version": 1, "query_id": "torn')  # died mid-write
        f.write("\n")
        f.write("not json at all\n")
        f.write(json.dumps({"schema_version": 99, "query_id": "q2"}) + "\n")
        f.write(json.dumps(dict(good, query_id="q3")) + "\n")
    assert [r["query_id"] for r in load_query_log(path)] == ["q1", "q3"]
    assert load_query_log(path) == jql.load_query_log(path)


def test_sink_rotation_size_cap(tmp_path, monkeypatch):
    path = str(tmp_path / "qlog.jsonl")
    monkeypatch.setenv("DAFT_QUERY_LOG", path)
    monkeypatch.setenv("DAFT_QUERY_LOG_MAX_BYTES", "4096")
    for _ in range(20):
        make_df({"a": [1, 2]}).collect()
    assert os.path.exists(path + ".1")  # rotated at the cap
    assert os.path.getsize(path) <= 4096
    assert os.path.getsize(path + ".1") <= 4096 + 600  # one line's slop
    all_recs = load_query_log(path, include_rotated=True)
    assert all_recs and all(validate_record(r) == [] for r in all_recs)
    assert len(all_recs) == len(jql.load_query_log(path, include_rotated=True))


def test_jsonl_lines_load_across_packages(tmp_path, monkeypatch):
    """Each package's lines load through the other's reader whole, and pass
    the other's schema check."""
    port_path, jax_path = str(tmp_path / "port.jsonl"), str(tmp_path / "jax.jsonl")
    monkeypatch.setenv("DAFT_QUERY_LOG", port_path)
    make_df({"a": [1, 2, 3]}).where(col("a") > 1).collect()
    make_df({"a": [1, 2, 3]}).where(col("a") > 1).collect()
    monkeypatch.setenv("DAFT_QUERY_LOG", jax_path)
    daft_tpu.from_pydict({"a": [1, 2, 3]}).where(daft_tpu.col("a") > 1).collect()
    daft_tpu.from_pydict({"a": [1, 2, 3]}).where(daft_tpu.col("a") > 1).collect()
    ours = load_query_log(port_path)
    theirs = jql.load_query_log(jax_path)
    assert len(ours) == len(theirs) == 2
    assert jql.load_query_log(port_path) == ours
    assert load_query_log(jax_path) == theirs
    for rec in ours + theirs:
        assert validate_record(rec) == [] and jql.validate_record(rec) == []
    for o, t in zip(ours, theirs):
        assert set(o) == set(t) - FEEDBACK_KEYS
        assert o["plan_fingerprint"] == t["plan_fingerprint"]
        assert (o["plan_cache_hit"], o["result_cache_hit"]) == \
            (t["plan_cache_hit"], t["result_cache_hit"])


# --------------------------------------------------------------------- #
# The record beside the JAX package's                                    #
# --------------------------------------------------------------------- #
def _queries(p):
    c = p.col
    rng = np.random.default_rng(3)
    data = {"g": rng.integers(0, 8, 400), "k": rng.integers(0, 50, 400),
            "v": rng.standard_normal(400)}
    dim = {"k": np.arange(50), "w": np.arange(50) * 0.5}
    df = p.from_pydict(data)
    return {
        "filter": lambda: df.where(c("v") > 0),
        "project": lambda: df.select((c("v") * 2).alias("v2"), "g"),
        "global_agg": lambda: df.agg(c("v").sum().alias("s")),
        "groupby": lambda: df.groupby("g").agg(c("v").mean().alias("m")),
        "sort": lambda: df.sort(["g", "v"]),
        "limit": lambda: df.sort("v").limit(5),
        "distinct": lambda: df.select("g").distinct(),
        "join": lambda: df.join(p.from_pydict(dim), on="k").select("g", "w"),
        "filter_groupby_sort": lambda: df.where(c("k") < 25).groupby("g").agg(
            c("v").sum().alias("s")).sort("g"),
        "sql": lambda: p.sql("SELECT g, SUM(v) AS s FROM t WHERE k < 10 GROUP BY g", t=df),
    }


@pytest.mark.parametrize("name", list(_queries(daft_tpu_torch)))
def test_record_keys_and_fingerprint_equal_the_jax_packages(name):
    ours = _queries(daft_tpu_torch)[name]()
    ours.collect()
    rec = get_recorder().recent(1)[0]
    theirs = _queries(daft_tpu)[name]()
    theirs.collect()
    jrec = jql.get_recorder().recent(1)[0]
    assert set(rec) == set(jrec) - FEEDBACK_KEYS
    assert repr(ours._builder.optimize().plan) == repr(theirs._builder.optimize().plan)
    assert rec["plan_fingerprint"] == jrec["plan_fingerprint"]
    for key in ("tenant", "runner", "outcome", "error_kind", "rows_out", "admission_wait_s",
                "shed_level", "plan_cache_hit", "result_cache_hit", "view", "profiled",
                "autoprofiled", "schema_version"):
        assert rec[key] == jrec[key], key
    assert set(rec["mem"]) == set(jrec["mem"])


def test_a_recorder_failure_keeps_the_querys_result_and_error(monkeypatch):
    """A recording failure is logged and dropped (``daft_querylog_dropped``):
    the query returns its rows, or raises its own error."""
    from daft_tpu_torch import metrics

    def broken(*args, **kwargs):
        raise RuntimeError("recorder bug")

    monkeypatch.setattr(querylog.FlightRecorder, "_record_entry", broken)
    dropped = metrics.QUERYLOG_DROPPED._default_child().value()
    assert make_df({"a": [1, 2]}).where(col("a") > 1).to_pydict() == {"a": [2]}

    @daft_tpu_torch.udf.func(return_dtype=daft_tpu_torch.DataType.int64())
    def boom(s):
        raise ValueError("the query's own error")

    with pytest.raises(DaftError, match="the query's own error"):
        make_df({"x": [1]}).select(boom(col("x"))).collect()
    assert metrics.QUERYLOG_DROPPED._default_child().value() == dropped + 2
    assert get_recorder().stats()["total"] == 0


def test_the_stubs_name_their_items():
    entry = get_recorder().begin("stub-q", daft_tpu_torch.get_context().execution_config)
    for call in (lambda: entry.note_view({"view": "v"}), lambda: entry.note_query_fp("ab"),
                 lambda: entry.note_feedback(True, 1), lambda: entry.note_estimates([])):
        with pytest.raises(DaftNotImplementedError, match="ROADMAP A.8.6"):
            call()
    with pytest.raises(DaftNotImplementedError, match="ROADMAP A.8.6"):
        with querylog.view_scope({"view": "v"}):
            pass
    for call in (lambda: querylog.record_fleet_event("scale-decision"),
                 lambda: querylog.recent_fleet_events()):
        with pytest.raises(DaftNotImplementedError, match="ROADMAP A.8.5"):
            call()


# --------------------------------------------------------------------- #
# The SLO plane: burn-rate alerts and tail-based auto-profiling          #
# --------------------------------------------------------------------- #
def _fake_record(tenant: str, outcome: str = "success", duration_s: float = 0.001,
                 fingerprint: str = "") -> dict:
    return {"schema_version": 1, "query_id": "q", "tenant": tenant, "runner": "native",
            "ts": time.time(), "outcome": outcome, "error_kind": "", "error": "",
            "duration_s": duration_s, "plan_fingerprint": fingerprint,
            "admission_wait_s": 0.0, "shed_level": 0, "rows_out": 0, "bytes_out": 0}


def _table(snapshot):
    """The SLO table keyed by tenant (the fake records carry their
    durations, so the percentiles compare too)."""
    return {t["tenant"]: t for t in snapshot}


def test_burn_rate_alert_fires_and_is_episodic():
    from daft_tpu_torch.subscribers.events import SLOBurnRateAlert

    events = []

    class Tap:
        def on_event(self, e):
            if isinstance(e, SLOBurnRateAlert):
                events.append(e)

    ctx = daft_tpu_torch.get_context()
    tap = Tap()
    ctx.attach_subscriber(tap)
    tracker = slo.get_tracker()
    cfg = ctx.execution_config
    try:
        # 30 bad queries: a bad fraction of 1.0 over the 0.05 budget, 20x.
        for i in range(30):
            tracker.observe(_fake_record("victim", outcome="failed"), cfg)
            if i == 15:
                time.sleep(0.3)  # past the evaluation throttle
        time.sleep(0.3)
        tracker.observe(_fake_record("victim", outcome="failed"), cfg)
    finally:
        ctx.detach_subscriber(tap)
    assert len(events) == 1, [e.tenant for e in events]  # once per episode
    assert events[0].tenant == "victim" and events[0].fast_burn_rate >= 14.0
    snap = _table(tracker.snapshot(cfg))
    assert snap["victim"]["alerting"] and snap["victim"]["alerts_fired"] == 1


def _feed_both(records, jax_cfg=None, port_cfg=None):
    """Feed the same records to both trackers; their tables."""
    jcfg = jax_cfg or daft_tpu.get_context().execution_config
    tcfg = port_cfg or daft_tpu_torch.get_context().execution_config
    for r in records:
        jslo.get_tracker().observe(r, jcfg)
        slo.get_tracker().observe(r, tcfg)
    return _table(slo.get_tracker().snapshot(tcfg)), _table(jslo.get_tracker().snapshot(jcfg))


@pytest.mark.parametrize("error", [None, DaftTimeoutError("deadline"), ValueError("boom")],
                         ids=["success", "timeout", "failed"])
def test_each_record_reads_peak_rss_at_its_finish(monkeypatch, error):
    """A record's ``peak_rss_bytes`` is read when it finishes, in both
    packages: of two records finished back to back, the second carries the
    peak as of its own finish, never the first's read."""
    import resource

    reads = iter(range(1, 1000))

    class _Usage:
        def __init__(self):
            self.ru_maxrss = next(reads)

    monkeypatch.setattr(resource, "getrusage", lambda who: _Usage())
    for recorder, cfg in ((get_recorder(), daft_tpu_torch.get_context().execution_config),
                          (jql.get_recorder(), daft_tpu.get_context().execution_config)):
        first = recorder.begin("rss-first", cfg).finish(error=error)
        second = recorder.begin("rss-second", cfg).finish(error=error)
        assert second["outcome"] == first["outcome"]
        assert second["peak_rss_bytes"] > first["peak_rss_bytes"] > 0


def test_healthy_tenant_stays_green():
    ours, theirs = _feed_both([_fake_record("calm")] * 30)
    time.sleep(0.3)
    ours, theirs = _feed_both([_fake_record("calm")])
    assert ours == theirs
    assert not ours["calm"]["alerting"]
    assert ours["calm"]["alerts_fired"] == 0
    assert ours["calm"]["fast_burn_rate"] == 0.0


def test_cancelled_excluded_from_slo():
    _feed_both([_fake_record("c", outcome="cancelled")] * 40)
    time.sleep(0.3)
    ours, theirs = _feed_both([_fake_record("c", outcome="cancelled")])
    assert ours == theirs
    assert ours["c"]["queries"] == 0  # a client's cancels do not move the SLO


def test_slow_query_arms_fingerprint_and_consumes():
    out = []
    for tracker, cfg in ((slo.get_tracker(), daft_tpu_torch.get_context().execution_config),
                         (jslo.get_tracker(), daft_tpu.get_context().execution_config)):
        cfg = cfg.with_changes(slo_latency_p99_s=0.01, slo_autoprofile_count=2)
        tracker.observe(_fake_record("t", duration_s=5.0, fingerprint="f" * 16), cfg)
        out.append([tracker.autoprofile_state(), tracker.consume_autoprofile("f" * 16),
                    tracker.consume_autoprofile("f" * 16),
                    tracker.consume_autoprofile("f" * 16),  # the budget is spent
                    tracker.consume_autoprofile("unseen")])
    assert out[0] == out[1] == [{"armed": {"f" * 16: 2}, "armed_total": 1},
                                True, True, False, False]


def test_tail_autoprofile_end_to_end():
    """A query over its tenant's latency objective arms its plan
    fingerprint; the next query of that shape is profiled in full, its
    profile retrievable as a timeline."""
    from daft_tpu_torch import profiling

    @daft_tpu_torch.udf.func(return_dtype=daft_tpu_torch.DataType.int64())
    def slowish(s):
        time.sleep(0.05)
        return s

    def build():
        return make_df({"x": [1, 2, 3]}).select(slowish(col("x")))

    with execution_config_ctx(slo_latency_p99_s=0.001, slo_autoprofile_count=1):
        build().collect()  # slow: arms the fingerprint
        first = get_recorder().recent(1)[0]
        assert not first["autoprofiled"]
        assert slo.get_tracker().autoprofile_state()["armed"]
        build().collect()  # the same shape: auto-profiled
        second = get_recorder().recent(1)[0]
    assert second["plan_fingerprint"] == first["plan_fingerprint"]
    assert second["autoprofiled"] and second["profiled"]
    assert second["operators"], second
    prof = profiling.profile_for(second["query_id"])
    assert prof is not None and prof.finished
    assert prof.root.attributes.get("autoprofile") is True
    assert profiling.timeline_json(second["query_id"]) is not None
    # The budget of 1 is spent: a third run is not profiled.
    with execution_config_ctx(slo_latency_p99_s=10.0):
        build().collect()
    assert not get_recorder().recent(1)[0]["autoprofiled"]


def test_slo_objectives_from_admission_policy():
    daft_tpu_torch.set_tenant_policy("gold", slo_latency_p99_s=0.25, slo_error_rate=0.01)
    daft_tpu.set_tenant_policy("gold", slo_latency_p99_s=0.25, slo_error_rate=0.01)
    cfg = daft_tpu_torch.get_context().execution_config
    jcfg = daft_tpu.get_context().execution_config
    assert slo._objectives_for("gold", cfg) == jslo._objectives_for("gold", jcfg) == (0.25, 0.01)
    assert slo._objectives_for("unknown", cfg) == jslo._objectives_for("unknown", jcfg) == (
        cfg.slo_latency_p99_s, cfg.slo_error_rate)


def test_admission_policy_json_accepts_slo_keys():
    raw = '{"t": {"queue_depth": 4, "slo_latency_p99_s": 0.5, "slo_error_rate": 0.02}}'
    pols = []
    for adm, cfg in ((tadm, daft_tpu_torch.get_context().execution_config),
                     (jadm, daft_tpu.get_context().execution_config)):
        ctl = adm.AdmissionController()
        ctl._sync_policies(cfg.with_changes(admission_policies=raw))
        pol = ctl.policy_for("t")
        pols.append((pol.queue_depth, pol.slo_latency_p99_s, pol.slo_error_rate))
    assert pols[0] == pols[1] == (4, 0.5, 0.02)


# --------------------------------------------------------------------- #
# EXPLAIN ANALYZE                                                        #
# --------------------------------------------------------------------- #
def test_explain_analyze_surfaces_flight_record(capsys):
    make_df({"a": [1, 2, 3, 4]}).where(col("a") > 1).explain(analyze=True)
    out = capsys.readouterr().out
    assert "flight record:" in out
    rec = get_recorder().recent(1)[0]
    # The analyzed text and the query log agree: the same record.
    assert f"tenant={rec['tenant']}" in out
    assert f"outcome={rec['outcome']}" in out
    assert f"fingerprint={rec['plan_fingerprint']}" in out
    assert rec["outcome"] == "success"


# --------------------------------------------------------------------- #
# Bounded stores: the event log and the dashboard                        #
# --------------------------------------------------------------------- #
def test_event_log_ring_and_rotation(tmp_path):
    from daft_tpu_torch.subscribers.event_log import EventLogSubscriber
    from daft_tpu_torch.subscribers.events import QueryStart

    path = str(tmp_path / "events.jsonl")
    sub = EventLogSubscriber(path, max_bytes=4096, max_events=50)
    try:
        for i in range(300):
            sub.on_event(QueryStart(query_id=f"q{i}", plan="p"))
        recent = sub.recent()
        assert len(recent) == 50  # the ring is bounded
        assert recent[0]["query_id"] == "q299"  # newest first
        assert sub.recent(5, event="QueryStart")[0]["query_id"] == "q299"
        assert os.path.getsize(path) <= 4096 + 200
        assert os.path.exists(path + ".1")
    finally:
        sub.close()


def test_dashboard_query_store_bounded():
    from daft_tpu_torch.subscribers.dashboard import DashboardState
    from daft_tpu_torch.subscribers.events import QueryEnd, QueryStart

    st = DashboardState()
    n = DashboardState.MAX_QUERIES + 100
    for i in range(n):
        st.on_event(QueryStart(query_id=f"q{i}", plan="p"))
        st.on_event(QueryEnd(query_id=f"q{i}", duration_s=0.01,
                             error="x" if i % 7 == 0 else None))
    assert len(st.queries) <= DashboardState.MAX_QUERIES
    summary = st.engine_summary()
    # Evicted queries still count in the cumulative summary.
    assert summary["queries_total"] == n
    assert summary["queries_failed"] == sum(1 for i in range(n) if i % 7 == 0)
    assert st.query_detail(f"q{n - 1}") is not None


# --------------------------------------------------------------------- #
# The dashboard's endpoints                                              #
# --------------------------------------------------------------------- #
def _get(url):
    import urllib.error
    import urllib.request

    try:
        resp = urllib.request.urlopen(url, timeout=30)
        return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_dashboard_querylog_and_slo_endpoints():
    from daft_tpu_torch.subscribers.dashboard import DashboardServer

    server = DashboardServer(port=0).start()
    ctx = daft_tpu_torch.get_context()
    sub = server.subscriber()
    ctx.attach_subscriber(sub)
    try:
        make_df({"a": [1, 2, 3]}).where(col("a") > 1).collect()
        s, ql = _get(f"{server.url}/api/querylog?n=10")
        assert s == 200 and ql["records"] and ql["records"][0]["outcome"] == "success"
        assert ql["stats"]["total"] >= 1
        s, empty = _get(f"{server.url}/api/querylog?outcome=failed&n=10")
        assert s == 200 and empty["records"] == []
        s, panel = _get(f"{server.url}/api/slo")
        assert s == 200 and "default" in {t["tenant"] for t in panel["tenants"]}
        assert "armed" in panel["autoprofile"] and panel["views"] == []
        s, adm = _get(f"{server.url}/api/admission")
        assert s == 200 and adm["totals"]["running"] == 0
        assert {r["tenant"] for r in adm["tenants"]} == {"default"}
        assert adm["tenants"][0]["admitted"] == 1
        assert _get(f"{server.url}/api/health") == (200, {"status": "ok"})
        # The web app and its assets are not ported: 501 naming the item.
        for route in ("/", "/assets/app.js", "/api/queries", "/metrics"):
            s, body = _get(server.url + route)
            assert s == 501 and "ROADMAP A.8.6" in body["error"], route
    finally:
        ctx.detach_subscriber(sub)
        server.shutdown()


# --------------------------------------------------------------------- #
# One record per query under concurrency                                 #
# --------------------------------------------------------------------- #
def test_shed_timeout_success_tally_under_concurrency():
    """Concurrent traffic of mixed outcomes: the by-outcome tallies sum to
    the queries issued, none lost, none twice."""
    daft_tpu_torch.set_tenant_policy("narrow", max_concurrent_queries=1, queue_depth=2)
    outcomes = []
    lock = threading.Lock()

    def job(i):
        tadm.set_tenant("narrow")
        try:
            with execution_config_ctx(device="cpu"):
                make_df({"a": list(range(200))}).where(col("a") > 50).collect()
            got = "success"
        except DaftAdmissionError:
            got = "shed"
        except DaftError as e:
            got = type(e).__name__
        finally:
            tadm.set_tenant(None)
        with lock:
            outcomes.append(got)

    base = get_recorder().stats()["total"]
    threads = [threading.Thread(target=job, args=(i,)) for i in range(12)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    stats = get_recorder().stats()
    assert stats["total"] - base == 12, (stats, outcomes)
    by = stats["by_outcome"]
    assert by["success"] == outcomes.count("success")
    assert by["shed"] == outcomes.count("shed")
