"""The metrics plane in the port (``daft_tpu_torch/metrics.py``) beside the JAX
package's ``daft_tpu/metrics.py``, on the CPU.

Mirrors ``tests/test_metrics.py`` case for case: the registry's semantics,
both exporters' schemas (golden-pinned, and the same text from the same
increments in both packages), the worker-wire merge with its staleness rules
(pure registry code, in one process), the disabled registry's
zero-allocation path, the engine's counters, the token shim, per-query IO
attribution, the circuit gauge and ``EXPLAIN ANALYZE``. The ``DAFT_METRICS``
case sets the variable as the JAX test does. Beyond the JAX file: its config
spelling (``metrics_enabled=False``), ``RuntimeStats.record_pull`` (the
rows in and the exclusive time credited to the parent operator), and ``tools/plane_cost.py``, which
times the plane's hot paths and turns a run's registry deltas into the
seconds the plane added to it.

Left out, with the modules they need: ``test_dashboard_metrics_routes`` (the
dashboard server, A.8), ``test_killed_worker_series_go_stale_under_fault_
injector`` (the distributed runner and the fault injector, A.8) and
``test_daemon_heartbeat_ships_metrics_snapshot`` (the worker daemon, A.8).

The registry is process-global and the suite runs files in parallel
processes: engine counters are read as snapshot deltas, never as absolutes.
"""

import json
import threading
import warnings

import pytest

import daft_tpu
import daft_tpu_torch
from daft_tpu import metrics as jax_metrics
from daft_tpu_torch import col, metrics
from daft_tpu_torch.metrics import (
    BYTES_BUCKETS,
    LATENCY_BUCKETS_S,
    NOOP,
    MetricRegistry,
    exponential_buckets,
    get_registry,
)

pytestmark = pytest.mark.filterwarnings("ignore:Specifying null_placement:FutureWarning")


@pytest.fixture(autouse=True)
def _cpu():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        with daft_tpu_torch.execution_config_ctx(device="cpu"):
            yield


def fresh():
    return MetricRegistry(enabled=True)


# ------------------------------------------------------------------ #
# Registry semantics                                                   #
# ------------------------------------------------------------------ #
def test_instrument_registration_is_idempotent_and_type_checked():
    r = fresh()
    c1 = r.counter("x_total", "help", ("a",))
    assert r.counter("x_total", "help", ("a",)) is c1
    with pytest.raises(ValueError):
        r.gauge("x_total")
    with pytest.raises(ValueError):
        r.counter("x_total", labelnames=("b",))


def test_labels_positional_kwargs_and_validation():
    r = fresh()
    c = r.counter("req_total", "", ("endpoint", "verb"))
    c.labels("e1", "GET").inc(2)
    c.labels(verb="GET", endpoint="e1").inc(3)
    assert c.labels("e1", "GET").value() == 5
    with pytest.raises(ValueError):
        c.labels("only-one")
    with pytest.raises(ValueError):
        c.labels(endpoint="e1")  # missing verb


def test_concurrent_increment_correctness():
    r = fresh()
    c = r.counter("hits_total", "", ("k",))
    h = r.histogram("lat_seconds", "", buckets=(0.5, 1.0))
    child = c.labels("a")

    def work():
        for _ in range(10_000):
            child.inc()
            c.labels("b").inc(2)
            h.observe(0.25)

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert c.labels("a").value() == 80_000
    assert c.labels("b").value() == 160_000
    state = h.labels().hist_state()
    assert state["count"] == 80_000
    assert state["bucket_counts"][0] == 80_000


def test_histogram_bucket_boundaries():
    assert exponential_buckets(1, 2, 4) == (1.0, 2.0, 4.0, 8.0)
    assert LATENCY_BUCKETS_S[0] == 0.001 and len(LATENCY_BUCKETS_S) == 16
    assert BYTES_BUCKETS[0] == 1024.0
    assert (LATENCY_BUCKETS_S, BYTES_BUCKETS) == (jax_metrics.LATENCY_BUCKETS_S,
                                                  jax_metrics.BYTES_BUCKETS)
    with pytest.raises(ValueError):
        exponential_buckets(0, 2, 4)
    r = fresh()
    h = r.histogram("h_seconds", "", buckets=(1.0, 10.0))
    # le semantics: a value equal to a bound lands IN that bucket.
    for v in (0.5, 1.0, 1.5, 10.0, 11.0):
        h.observe(v)
    state = h.labels().hist_state()
    assert state["bucket_counts"] == [2, 2, 1]
    assert state["count"] == 5 and state["sum"] == pytest.approx(24.0)


def test_reset_zeroes_but_keeps_instruments():
    r = fresh()
    c = r.counter("n_total")
    c.inc(5)
    child = c.labels()
    r.reset()
    assert child.value() == 0
    c.inc(1)
    assert r.snapshot().counter_total("n_total") == 1
    r.reset("n_total")
    assert r.snapshot().counter_total("n_total") == 0


# ------------------------------------------------------------------ #
# Exposition goldens (schema pins for both exporters)                  #
# ------------------------------------------------------------------ #
def golden_registry(m=metrics):
    r = m.MetricRegistry(enabled=True)
    r.counter("daft_demo_requests_total", "Requests served",
              ("endpoint", "verb")).labels("s3://x", "GET").inc(3)
    r.gauge("daft_demo_up", "Liveness", ("worker_id",)).labels("w1").set(1)
    h = r.histogram("daft_demo_seconds", "Latency", buckets=(0.1, 1.0))
    h.observe(0.05)
    h.observe(0.5)
    h.observe(5.0)
    return r


GOLDEN_PROMETHEUS = (
    "# HELP daft_demo_requests_total Requests served\n"
    "# TYPE daft_demo_requests_total counter\n"
    'daft_demo_requests_total{endpoint="s3://x",verb="GET"} 3\n'
    "# HELP daft_demo_seconds Latency\n"
    "# TYPE daft_demo_seconds histogram\n"
    'daft_demo_seconds_bucket{le="0.1"} 1\n'
    'daft_demo_seconds_bucket{le="1"} 2\n'
    'daft_demo_seconds_bucket{le="+Inf"} 3\n'
    "daft_demo_seconds_sum 5.55\n"
    "daft_demo_seconds_count 3\n"
    "# HELP daft_demo_up Liveness\n"
    "# TYPE daft_demo_up gauge\n"
    'daft_demo_up{worker_id="w1"} 1\n'
)


def test_prometheus_exposition_golden():
    text = golden_registry().to_prometheus()
    assert text == GOLDEN_PROMETHEUS
    # The same increments give the same exposition in the JAX package.
    assert golden_registry(jax_metrics).to_prometheus() == text


def test_prometheus_label_escaping():
    lines = []
    for m in (jax_metrics, metrics):
        r = m.MetricRegistry(enabled=True)
        r.counter("esc_total", "", ("p",)).labels('a"b\\c\nd').inc()
        lines.append(r.to_prometheus().splitlines()[-1])
    assert lines[1] == lines[0] == 'esc_total{p="a\\"b\\\\c\\nd"} 1'


def _strip_times(obj):
    """The OTLP payload with its timestamps dropped (they differ by the read)."""
    if isinstance(obj, dict):
        return {k: _strip_times(v) for k, v in obj.items()
                if k not in ("timeUnixNano", "startTimeUnixNano")}
    if isinstance(obj, list):
        return [_strip_times(v) for v in obj]
    return obj


def test_otlp_json_schema_pin():
    payload = golden_registry().to_otlp(service_name="svc")
    json.dumps(payload)  # must be JSON-serializable end to end
    rm = payload["resourceMetrics"][0]
    assert rm["resource"]["attributes"][0] == {
        "key": "service.name", "value": {"stringValue": "svc"}}
    scope = rm["scopeMetrics"][0]
    assert scope["scope"] == {"name": "daft_tpu_torch.metrics"}
    by_name = {m["name"]: m for m in scope["metrics"]}
    counter = by_name["daft_demo_requests_total"]["sum"]
    assert counter["isMonotonic"] is True
    assert counter["aggregationTemporality"] == 2
    dp = counter["dataPoints"][0]
    assert dp["asDouble"] == 3.0
    assert {"key": "verb", "value": {"stringValue": "GET"}} in dp["attributes"]
    assert "timeUnixNano" in dp
    gauge = by_name["daft_demo_up"]["gauge"]["dataPoints"][0]
    assert gauge["asDouble"] == 1.0
    hist = by_name["daft_demo_seconds"]["histogram"]
    assert hist["aggregationTemporality"] == 2
    hdp = hist["dataPoints"][0]
    assert hdp["explicitBounds"] == [0.1, 1.0]
    assert hdp["bucketCounts"] == ["1", "1", "1"]  # proto uint64 -> strings
    assert hdp["count"] == "3" and hdp["sum"] == pytest.approx(5.55)
    # The JAX package's payload for the same increments, but for the scope's
    # name (each package names itself) and the read times.
    theirs = golden_registry(jax_metrics).to_otlp(service_name="svc")
    theirs["resourceMetrics"][0]["scopeMetrics"][0]["scope"] = scope["scope"]
    assert _strip_times(payload) == _strip_times(theirs)


def test_otlp_file_exporter_writes_resource_metrics_lines(tmp_path):
    from daft_tpu_torch.metrics import OTLPJsonMetricsFileExporter

    path = tmp_path / "metrics.jsonl"
    exp = OTLPJsonMetricsFileExporter(str(path))
    exp.export(golden_registry())
    exp.export(golden_registry())
    lines = path.read_text().strip().splitlines()
    assert len(lines) == 2
    assert "resourceMetrics" in json.loads(lines[0])


def test_the_series_inventory_is_the_jax_packages():
    """Every named series the JAX package registers, with its kind, labels
    and help, is registered in the port."""
    def inventory(m):
        return {name: (inst.kind, tuple(inst.labelnames), inst.help)
                for name, inst in m.get_registry()._instruments.items()
                if name.startswith("daft_")}

    ours, theirs = inventory(metrics), inventory(jax_metrics)
    assert {k: v for k, v in ours.items() if k in theirs} == theirs


# ------------------------------------------------------------------ #
# Worker aggregation over the heartbeat wire                           #
# ------------------------------------------------------------------ #
def test_worker_wire_merge_is_idempotent_and_labeled():
    worker = fresh()
    worker.counter("daft_w_total", "", ("reason",)).labels("t").inc(3)
    worker.histogram("daft_w_seconds", "", buckets=(1.0,)).observe(0.5)
    driver = fresh()
    wire = worker.to_wire()
    json.dumps(wire)  # the wire must survive JSON/pickle transports
    driver.merge_worker_wire("w1", wire)
    driver.merge_worker_wire("w1", wire)  # re-delivered heartbeat: no double
    snap = driver.snapshot()
    assert snap.counter_total("daft_w_total") == 3
    assert snap.value("daft_w_total", worker_id="w1", reason="t") == 3
    assert snap.hist("daft_w_seconds")["count"] == 1
    text = driver.to_prometheus()
    assert 'daft_w_total{reason="t",worker_id="w1"} 3' in text
    assert 'daft_worker_up{worker_id="w1"} 1' in text
    # A newer cumulative snapshot replaces the old one.
    worker.counter("daft_w_total", "", ("reason",)).labels("t").inc(2)
    driver.merge_worker_wire("w1", worker.to_wire())
    assert driver.snapshot().counter_total("daft_w_total") == 5
    # The JAX package's driver reads the port's wire to the same text.
    jax_driver = jax_metrics.MetricRegistry(enabled=True)
    jax_driver.merge_worker_wire("w1", worker.to_wire())
    assert jax_driver.to_prometheus() == driver.to_prometheus()


def test_stale_worker_series_leave_the_scrape():
    worker = fresh()
    worker.counter("daft_w_total").inc(7)
    driver = fresh()
    driver.merge_worker_wire("w1", worker.to_wire())
    driver.mark_worker_stale("w1")
    assert driver.stale_workers() == {"w1"}
    text = driver.to_prometheus()
    assert "daft_w_total" not in text
    assert 'daft_worker_up{worker_id="w1"} 0' in text
    assert driver.snapshot().counter_total("daft_w_total") == 0
    # A fresh snapshot from a revived worker un-stales it.
    driver.merge_worker_wire("w1", worker.to_wire())
    assert driver.stale_workers() == set()
    assert driver.snapshot().counter_total("daft_w_total") == 7


def test_late_task_reply_does_not_revive_stale_worker():
    worker = fresh()
    worker.counter("daft_w3_total").inc(9)
    driver = fresh()
    driver.merge_worker_wire("w1", worker.to_wire())
    driver.mark_worker_stale("w1")  # WorkerLost fired
    # A task reply that raced the death merges with revive=False: the wire
    # updates for post-mortems, but the worker stays stale.
    driver.merge_worker_wire("w1", worker.to_wire(), revive=False)
    assert driver.stale_workers() == {"w1"}
    assert 'daft_worker_up{worker_id="w1"} 0' in driver.to_prometheus()
    # The heartbeat path (an answered ping) IS liveness evidence.
    driver.merge_worker_wire("w1", worker.to_wire())
    assert driver.stale_workers() == set()


def test_clear_stale_workers_forgets_wires_and_liveness_series():
    worker = fresh()
    worker.counter("daft_w4_total").inc(5)
    driver = fresh()
    driver.merge_worker_wire("w1", worker.to_wire())
    driver.mark_worker_stale("w1")
    driver.clear_stale_workers()
    assert driver.stale_workers() == set()
    text = driver.to_prometheus()
    # Neither the dead worker's final snapshot nor a contradictory up=0
    # series survives.
    assert "daft_w4_total" not in text
    assert 'worker_id="w1"' not in text


def test_snapshot_does_not_race_per_metric_reset():
    worker = fresh()
    for i in range(50):
        worker.counter(f"daft_r{i}_total").inc(1)
    driver = fresh()
    driver.merge_worker_wire("w1", worker.to_wire())
    errors = []

    def scrape():
        try:
            for _ in range(200):
                driver.to_prometheus()
        except Exception as e:  # noqa: BLE001 — the failure IS the assertion
            errors.append(e)

    def resetter():
        try:
            for i in range(200):
                driver.reset(f"daft_r{i % 50}_total")
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=scrape), threading.Thread(target=resetter)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert errors == []


def test_per_metric_reset_strips_worker_wires_too():
    worker = fresh()
    worker.counter("daft_w2_total").inc(555)
    worker.counter("daft_keep_total").inc(1)
    driver = fresh()
    driver.merge_worker_wire("w1", worker.to_wire())
    driver.reset("daft_w2_total")
    snap = driver.snapshot()
    assert snap.counter_total("daft_w2_total") == 0
    assert snap.counter_total("daft_keep_total") == 1  # untouched


def test_per_metric_reset_survives_next_cumulative_heartbeat():
    worker = fresh()
    worker.counter("daft_w5_total").inc(100)
    driver = fresh()
    driver.merge_worker_wire("w1", worker.to_wire())
    driver.reset("daft_w5_total")
    # Workers count cumulatively through a driver reset: the next heartbeat
    # re-delivers the full total, which must read as post-reset delta only.
    worker.counter("daft_w5_total").inc(7)
    driver.merge_worker_wire("w1", worker.to_wire())
    assert driver.snapshot().counter_total("daft_w5_total") == 7
    # A worker RESTART (counter below the baseline) reads raw, not negative.
    restarted = fresh()
    restarted.counter("daft_w5_total").inc(3)
    driver.merge_worker_wire("w1", restarted.to_wire())
    assert driver.snapshot().counter_total("daft_w5_total") == 3


def test_per_query_series_stay_off_the_wire():
    from daft_tpu_torch.cancellation import CancelToken, cancel_scope
    from daft_tpu_torch.metrics import record_io

    reg = get_registry()
    reg.reset("daft_query_io_requests_total")
    with cancel_scope(CancelToken(query_id="q-wire")):
        record_io("s3://b", "GET", nbytes=10, seconds=0.001)
    # Driver-local snapshot/scrape see the per-query series...
    assert reg.snapshot().value("daft_query_io_requests_total", query_id="q-wire") == 1
    # ...but the heartbeat wire never ships them.
    assert "daft_query_io_requests_total" not in reg.to_wire()
    assert "daft_query_io_bytes_total" not in reg.to_wire()


def test_query_series_capped_and_evicted_at_query_end():
    from daft_tpu_torch.metrics import QUERY_IO_BYTES, MetricsSubscriber
    from daft_tpu_torch.subscribers.events import QueryEnd

    r = fresh()
    capped = r.counter("cap_total", "", ("query_id",), max_series=4)
    for i in range(10):
        capped.labels(f"q{i}").inc()
    assert len(capped.series()) == 4  # oldest evicted, newest kept
    assert capped.labels("q9").value() == 1

    QUERY_IO_BYTES.labels("q-end-test").inc(10)
    MetricsSubscriber().on_event(QueryEnd(query_id="q-end-test"))
    assert get_registry().snapshot().value(
        "daft_query_io_bytes_total", query_id="q-end-test") == 0


# ------------------------------------------------------------------ #
# metrics_enabled=False: zero-allocation fast path                     #
# ------------------------------------------------------------------ #
def test_disabled_registry_fast_path_allocates_nothing():
    r = MetricRegistry(enabled=False)
    c = r.counter("off_total", "", ("k",))
    # Every labels() call returns the SAME module singleton: no per-call
    # child allocation, no series accumulation.
    assert c.labels("a") is NOOP
    assert c.labels("b") is c.labels("c")
    c.labels("a").inc(100)
    c.inc(5)
    g = r.gauge("off_gauge")
    g.set(3)
    r.histogram("off_seconds").observe(1.0)
    assert r.to_wire() == {}
    assert r.to_prometheus() == "\n"
    assert r.snapshot().counter_total("off_total") == 0
    # Worker merges are dropped too (a disabled driver must stay empty).
    r.merge_worker_wire("w1", {"x_total": {
        "kind": "counter", "help": "", "series": [{"labels": {}, "value": 1}]}})
    assert r.to_wire() == {}


def test_disabled_registry_allocation_count():
    import tracemalloc

    r = MetricRegistry(enabled=False)
    c = r.counter("off2_total", "", ("k",))
    c.labels("warm").inc()  # warm any lazy imports before measuring
    tracemalloc.start()
    for _ in range(1000):
        c.labels("hot").inc()
    _, peak = tracemalloc.get_traced_memory()
    tracemalloc.stop()
    # The hot loop allocates only transient argument tuples (sub-KB peak),
    # never children/series.
    assert peak < 4096, f"disabled fast path allocated {peak} bytes"


def test_daft_metrics_env_gates_registry(monkeypatch):
    monkeypatch.setenv("DAFT_METRICS", "0")
    assert MetricRegistry().enabled is False
    monkeypatch.setenv("DAFT_METRICS", "1")
    assert MetricRegistry().enabled is True
    monkeypatch.delenv("DAFT_METRICS")
    assert MetricRegistry().enabled is True  # default on


def test_metrics_enabled_false_turns_the_process_registry_off():
    """The config spelling of the switch: the first event under
    ``metrics_enabled=False`` turns the process registry off."""
    reg = get_registry()
    was = reg.enabled
    try:
        with daft_tpu_torch.execution_config_ctx(metrics_enabled=False):
            daft_tpu_torch.from_pydict({"x": [1]}).collect()
        assert reg.enabled is False
        s0 = reg.snapshot()
        daft_tpu_torch.from_pydict({"x": [1, 2]}).collect()
        assert reg.snapshot().counter_total("daft_executor_rows_total") \
            == s0.counter_total("daft_executor_rows_total")
    finally:
        reg.enabled = was


# ------------------------------------------------------------------ #
# Engine integration                                                   #
# ------------------------------------------------------------------ #
def test_query_increments_engine_counters():
    reg = get_registry()
    s0 = reg.snapshot()
    df = daft_tpu_torch.from_pydict({"x": list(range(512)), "g": [i % 4 for i in range(512)]})
    df.groupby("g").agg(col("x").sum().alias("s")).to_pydict()
    s1 = reg.snapshot()
    for name in ("daft_queries_started_total", "daft_executor_morsels_total",
                 "daft_executor_rows_total"):
        assert s1.counter_total(name) > s0.counter_total(name), name


def test_token_metrics_string_keys_json_and_tuple_compat():
    from daft_tpu_torch.ai.metrics import (
        record_token_metrics,
        reset_token_metrics,
        token_metrics,
    )

    reset_token_metrics()
    record_token_metrics("openai", "emb-small", input_tokens=9, output_tokens=4, requests=2)
    tm = token_metrics()
    assert set(tm) == {"openai/emb-small"}
    assert tm["openai/emb-small"]["input_tokens"] == 9
    # Legacy tuple keys keep resolving.
    assert tm[("openai", "emb-small")]["output_tokens"] == 4
    assert ("openai", "emb-small") in tm
    assert tm.get(("nope", "x")) is None
    json.dumps(tm)
    reset_token_metrics()
    assert token_metrics() == {}


def test_per_query_io_attribution_via_cancel_scope():
    from daft_tpu_torch.cancellation import CancelToken, cancel_scope
    from daft_tpu_torch.metrics import record_io

    reg = get_registry()
    reg.reset("daft_query_io_requests_total")
    reg.reset("daft_query_io_bytes_total")
    with cancel_scope(CancelToken(query_id="qm1")):
        record_io("s3://bucket", "GET", nbytes=100, seconds=0.01)
    record_io("s3://bucket", "GET", nbytes=50, seconds=0.01)  # no scope
    snap = reg.snapshot()
    assert snap.value("daft_query_io_requests_total", query_id="qm1") == 1
    assert snap.value("daft_query_io_bytes_total", query_id="qm1") == 100
    assert snap.counter_total("daft_query_io_bytes_total") == 100


def test_circuit_breaker_state_gauge_transitions():
    from daft_tpu_torch.errors import DaftCircuitOpenError
    from daft_tpu_torch.io.circuit import CircuitBreaker

    reg = get_registry()
    s0 = reg.snapshot()
    b = CircuitBreaker("https://metrics.test", failure_threshold=2,
                       open_base_s=30.0, open_cap_s=30.0, half_open_probes=1)
    b.record_failure()
    b.record_failure()  # trips open
    snap = reg.snapshot()
    assert snap.value("daft_circuit_state", endpoint="https://metrics.test") == 2
    assert snap.value("daft_circuit_transitions_total", endpoint="https://metrics.test",
                      to="open") - s0.value("daft_circuit_transitions_total",
                                            endpoint="https://metrics.test", to="open") == 1
    with pytest.raises(DaftCircuitOpenError):
        b.allow()
    b.record_success()  # half-open probe succeeded -> closed
    snap = reg.snapshot()
    assert snap.value("daft_circuit_state", endpoint="https://metrics.test") == 0
    assert snap.value("daft_circuit_transitions_total", endpoint="https://metrics.test",
                      to="closed") - s0.value("daft_circuit_transitions_total",
                                              endpoint="https://metrics.test", to="closed") == 1


def test_explain_analyze_reads_registry_deltas(capsys):
    df = daft_tpu_torch.from_pydict({"x": list(range(64))})
    df.select((col("x") * 2).alias("y")).explain(analyze=True)
    text = capsys.readouterr().out
    assert "== Analyze ==" in text
    assert "device eval: fused_exprs=" in text


@pytest.mark.parametrize("series", ["spill", "device"])
def test_legacy_tallies_are_registry_shims(series):
    """``spill_metrics`` reads the registry's ``daft_spill_*`` series, as in
    the JAX package; ``device_eval_counters`` keeps its own tallies and
    increments the registry's ``daft_device_*`` series beside them."""
    from daft_tpu_torch.execution.spill import spill_metrics
    from daft_tpu_torch.ops.device_eval import device_eval_counters

    reg = get_registry()
    s0 = reg.snapshot()
    if series == "spill":
        before = spill_metrics.snapshot()
        spill_metrics.record(1000, 2)
        after = spill_metrics.snapshot()
        assert after["bytes_spilled"] - before["bytes_spilled"] == 1000
        assert after["files"] - before["files"] == 2
        assert reg.snapshot().counter_total("daft_spill_bytes_total") \
            - s0.counter_total("daft_spill_bytes_total") == 1000
    else:
        before = device_eval_counters.snapshot()["fused_rows"]
        device_eval_counters.record_fused(3, 10)
        assert device_eval_counters.snapshot()["fused_rows"] - before == 30
        assert reg.snapshot().counter_total("daft_device_fused_rows_total") \
            - s0.counter_total("daft_device_fused_rows_total") == 30


# ------------------------------------------------------------------ #
# Beyond the JAX file: the plane's own cost                            #
# ------------------------------------------------------------------ #
def test_record_pull_credits_rows_in_and_exclusive_time_to_the_parent():
    from daft_tpu_torch.execution.resource_manager import RuntimeStats

    stats = RuntimeStats("q")
    for op, parent, rows, ns in (("Filter", "Project", 5, 100), ("InMemorySource", "Filter", 9, 40),
                                 ("Project", None, 5, 300), ("Filter", "Project", 2, 7)):
        stats.record_pull(op, parent, rows, ns)
    assert stats.to_wire() == {
        "Filter": {"rows_in": 9, "rows_out": 7, "cpu_ns": 107 - 40},
        "Project": {"rows_in": 7, "rows_out": 5, "cpu_ns": 300 - 107},
        "InMemorySource": {"rows_in": 0, "rows_out": 9, "cpu_ns": 40}}
    assert list(stats.snapshot()) == ["Filter", "Project", "InMemorySource"]  # metrics()' order


def test_plane_cost_times_each_path_and_restores_the_registry():
    from daft_tpu_torch.tools import plane_cost

    reg = get_registry()
    was = reg.enabled
    cost = plane_cost.measure(morsels=300, reps=3)
    assert reg.enabled == was
    for key in ("bare_ns", "instrumented_ns", "instrumented_off_ns", "profiled_ns",
                "per_query_ns", "profiled_query_ns"):
        assert cost[key] > 0, key
    assert cost["per_morsel_ns"] == pytest.approx(cost["instrumented_ns"] - cost["bare_ns"])
    assert cost["profiled_per_morsel_ns"] == pytest.approx(
        cost["profiled_ns"] - cost["instrumented_ns"])


def test_plane_seconds_reads_a_querys_registry_deltas():
    from daft_tpu_torch.tools import plane_cost

    before = plane_cost.counter_totals()
    q = (daft_tpu_torch.from_pydict({"a": list(range(1000))}).where(col("a") > 10)
         .select((col("a") * 2).alias("b")))
    q.collect()
    after = plane_cost.counter_totals()
    deltas = {k: after[k] - before[k] for k in after}
    cost = {"per_morsel_ns": 1000.0, "counter_inc_ns": 100.0, "per_query_ns": 1e6}
    est = plane_cost.plane_seconds(cost, deltas)
    assert est["queries"] == 1
    assert est["morsels"] == deltas["daft_executor_morsels_total"] >= len(q.metrics()) > 0
    assert est["total_s"] == pytest.approx(
        est["morsels"] * 1e-6 + est["device_incs"] * 1e-7 + 1e-3)
    cost.update(registry_per_morsel_ns=400.0, counter_inc_off_ns=20.0,
                profiled_per_morsel_ns=2000.0, profiled_query_ns=5e4)
    loop = plane_cost.loop_overheads(cost, deltas, off_s=0.01)
    assert loop["registry_pct"] == pytest.approx(
        100 * (est["morsels"] * 4e-7 + est["device_incs"] * 8e-8) / 0.01)
    assert loop["profiler_pct"] == pytest.approx(100 * (est["morsels"] * 2e-6 + 5e-5) / 0.01)
