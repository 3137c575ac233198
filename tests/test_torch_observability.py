"""Events, subscribers, the event log and OTel-shaped tracing in the port
(``daft_tpu_torch/subscribers/``, ``context.notify``, ``tracing.py``) beside
the JAX package's, on the CPU.

Mirrors ``tests/test_observability.py``: query events, the JSONL event log,
in-memory OTel-style tracing, the OTLP file exporter, the
``DAFT_DEV_ENABLE_TRACING`` / ``DAFT_TRACE_FILE`` auto-attach and the CLI's
``version`` (with its ``sql`` beside the JAX CLI's text, and ``dashboard``
raising naming ROADMAP A.8.6). Beyond the JAX file: the event dataclasses are the JAX package's field for field, a
raising subscriber loses only its own event, the event log's ring and
rotation, the circuit breaker's and the digest check's events, and
``OperatorStats`` from the query's ``RuntimeStats``.

Left out, with the modules they need: ``test_dashboard_server``,
``test_dashboard_live_operator_state``, ``test_dashboard_static_app_and_
dataframe_display`` and ``test_dataframe_repr_html`` (the dashboard's server,
state and assets, ROADMAP A.8.6; the port's notebook table is held in
``tests/test_torch_dataframe_surface.py``), ``test_heartbeat`` (the
distributed runner's heartbeat, A.8.5) and
``test_components_tally_not_stale`` (the JAX package's component tally).
``test_checkpoint_resume`` and ``test_checkpoint_mixed_type_keys`` are
mirrored in ``tests/test_torch_checkpoint.py``.
"""

import dataclasses
import json
import logging
import time
import warnings

import pytest

import daft_tpu
import daft_tpu_torch
from daft_tpu.subscribers import events as jax_events
from daft_tpu_torch.subscribers import events
from daft_tpu_torch.subscribers.events import QueryEnd, Subscriber

pytestmark = pytest.mark.filterwarnings("ignore:Specifying null_placement:FutureWarning")


@pytest.fixture(autouse=True)
def _cpu():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        with daft_tpu_torch.execution_config_ctx(device="cpu"):
            yield


def make_df(data):
    return daft_tpu_torch.from_pydict(data)


class _Collect(Subscriber):
    def __init__(self):
        self.events = []

    def on_event(self, e):
        self.events.append(e)


def _attached(sub):
    """Attach ``sub`` to the context for a block (a generator-based guard)."""
    ctx = daft_tpu_torch.get_context()

    class _Guard:
        def __enter__(self):
            ctx.attach_subscriber(sub)
            return sub

        def __exit__(self, *exc):
            ctx.detach_subscriber(sub)

    return _Guard()


def test_query_events():
    sub = _Collect()
    with _attached(sub):
        make_df({"a": [1, 2]}).collect()
    kinds = [type(e).__name__ for e in sub.events]
    assert "QueryStart" in kinds and "QueryEnd" in kinds
    end = [e for e in sub.events if isinstance(e, QueryEnd)][0]
    assert end.error is None and end.duration_s >= 0


def test_event_log_jsonl(tmp_path):
    from daft_tpu_torch.subscribers.event_log import EventLogSubscriber

    path = str(tmp_path / "events.jsonl")
    sub = EventLogSubscriber(path)
    try:
        with _attached(sub):
            make_df({"a": [1]}).collect()
    finally:
        sub.close()
    lines = [json.loads(line) for line in open(path)]
    assert any(line["event"] == "QueryStart" for line in lines)
    assert any(line["event"] == "QueryEnd" for line in lines)


def test_otel_style_tracing_in_memory():
    """Engine events become OTel-shaped spans captured by an in-memory
    exporter (reference: tests/observability/test_opentelemetry.py)."""
    from daft_tpu_torch.tracing import InMemorySpanExporter, TracingSubscriber

    exporter = InMemorySpanExporter()
    sub = TracingSubscriber(exporter)
    with _attached(sub):
        df = make_df({"x": list(range(100)), "g": [i % 3 for i in range(100)]})
        df.groupby("g").agg(daft_tpu_torch.col("x").sum().alias("s")).collect()
    spans = exporter.get_finished_spans()
    names = {s.name for s in spans}
    assert "daft.query" in names
    query_span = next(s for s in spans if s.name == "daft.query")
    assert query_span.status == "OK" and query_span.end_ns > query_span.start_ns
    op_spans = [s for s in spans if s.name.startswith("daft.operator.")]
    assert op_spans, names
    assert all(s.trace_id == query_span.trace_id for s in op_spans)
    snap = sub.meter.snapshot()
    assert snap["counters"]["daft.queries.ended"] >= 1
    assert snap["counters"]["daft.rows.processed"] >= 100
    otlp = query_span.to_otlp()
    assert otlp["traceId"] == query_span.trace_id and otlp["status"]["code"] == 1
    assert sub.meter.to_otlp()["resourceMetrics"]


def test_otlp_file_exporter(tmp_path):
    from daft_tpu_torch.tracing import OTLPJsonFileExporter, TracingSubscriber

    path = str(tmp_path / "traces.jsonl")
    sub = TracingSubscriber(OTLPJsonFileExporter(path))
    with _attached(sub):
        make_df({"x": [1, 2, 3]}).where(daft_tpu_torch.col("x") > 1).collect()
    lines = [line for line in open(path).read().splitlines() if line]
    assert lines
    payload = json.loads(lines[-1])
    spans = payload["resourceSpans"][0]["scopeSpans"][0]["spans"]
    assert all("traceId" in s and "startTimeUnixNano" in s for s in spans)


def test_env_gated_tracing(tmp_path, monkeypatch):
    import daft_tpu_torch.tracing as tracing_mod

    path = str(tmp_path / "auto.jsonl")
    monkeypatch.setenv("DAFT_DEV_ENABLE_TRACING", "1")
    monkeypatch.setenv("DAFT_TRACE_FILE", path)
    monkeypatch.setattr(tracing_mod, "_auto_subscriber", None)
    ctx = daft_tpu_torch.get_context()
    before = list(ctx.subscribers())
    try:
        make_df({"x": [1]}).collect()
        assert tracing_mod._auto_subscriber is not None
        make_df({"x": [2]}).collect()
        assert path and open(path).read().strip()
    finally:
        for s in ctx.subscribers():
            if s not in before:
                ctx.detach_subscriber(s)
        monkeypatch.setattr(tracing_mod, "_auto_subscriber", None)


def test_cli_version(capsys):
    from daft_tpu_torch.__main__ import main

    assert main(["version"]) == 0
    out = capsys.readouterr().out.strip()
    assert out == daft_tpu_torch.__version__


def test_cli_sql_runs_on_the_cpu_with_tables(tmp_path, capsys):
    """``python -m daft_tpu_torch sql`` over a parquet table, ``--device
    cpu``: the JAX CLI's preview text of the same query."""
    from daft_tpu.__main__ import main as jax_main
    from daft_tpu_torch.__main__ import main

    d = str(tmp_path / "t")
    daft_tpu_torch.from_pydict({"k": [1, 2, 3], "v": [0.5, 1.5, 2.5]}).write_parquet(d)
    q = "SELECT SUM(v) AS s, COUNT(*) AS n FROM t WHERE k > 1"
    assert main(["sql", q, "--table", f"t={d}", "--device", "cpu"]) == 0
    port = capsys.readouterr().out
    assert jax_main(["sql", q, "--table", f"t={d}"]) == 0
    assert port == capsys.readouterr().out
    assert "4" in port


def test_cli_dashboard_raises_naming_its_item():
    from daft_tpu_torch.__main__ import main
    from daft_tpu_torch.errors import DaftNotImplementedError

    with pytest.raises(DaftNotImplementedError, match=r"A\.8\.6"):
        main(["dashboard"])


# ------------------------------------------------------------------ #
# Beyond the JAX file                                                  #
# ------------------------------------------------------------------ #
def _event_classes(mod):
    return {name: obj for name, obj in vars(mod).items()
            if isinstance(obj, type) and issubclass(obj, mod.Event) and obj is not mod.Event}


def test_event_dataclasses_are_the_jax_packages():
    ours, theirs = _event_classes(events), _event_classes(jax_events)
    assert set(ours) == set(theirs)
    for name, cls in theirs.items():
        fields = [(f.name, f.default if f.default is not dataclasses.MISSING else None)
                  for f in dataclasses.fields(cls)]
        assert [(f.name, f.default if f.default is not dataclasses.MISSING else None)
                for f in dataclasses.fields(ours[name])] == fields, name


def test_raising_subscriber_drops_only_its_own_event(caplog):
    class Broken(Subscriber):
        def on_event(self, e):
            raise RuntimeError("boom")

    good = _Collect()
    with _attached(Broken()), _attached(good):
        with caplog.at_level(logging.WARNING, logger="daft_tpu_torch.context"):
            out = make_df({"a": [1, 2, 3]}).to_pydict()
    assert out == {"a": [1, 2, 3]}
    assert {"QueryStart", "QueryEnd"} <= {type(e).__name__ for e in good.events}
    assert any("Broken" in r.getMessage() for r in caplog.records)


def test_event_log_ring_and_rotation(tmp_path):
    from daft_tpu_torch.subscribers.event_log import EventLogSubscriber

    path = tmp_path / "ring.jsonl"
    sub = EventLogSubscriber(str(path), max_events=3, max_bytes=4096)
    try:
        for i in range(200):
            sub.on_event(QueryEnd(query_id=f"q{i}", duration_s=0.0))
        # The ring keeps at least 16 events, newest first.
        assert [e["query_id"] for e in sub.recent()] == [f"q{i}" for i in range(199, 183, -1)]
        assert [e["query_id"] for e in sub.recent(2)] == ["q199", "q198"]
    finally:
        sub.close()
    assert (tmp_path / "ring.jsonl.1").exists()
    # The file rotated at 4096 bytes (the sink's least cap) to <path>.1.
    assert path.stat().st_size <= 4096
    assert json.loads((tmp_path / "ring.jsonl.1").read_text().splitlines()[0])["event"] \
        == "QueryEnd"


def test_circuit_transitions_notify_events():
    from daft_tpu_torch.io.circuit import CircuitBreaker
    from daft_tpu_torch.subscribers.events import CircuitClosed, CircuitOpened

    sub = _Collect()
    with _attached(sub):
        b = CircuitBreaker("https://events.test", failure_threshold=2,
                           open_base_s=0.01, open_cap_s=0.01, half_open_probes=1)
        b.record_failure()
        b.record_failure()  # opens for at most 10 ms
        time.sleep(0.02)
        b.allow()           # the probe, half-open
        b.record_success()  # closes
    opened = [e for e in sub.events if isinstance(e, CircuitOpened)]
    closed = [e for e in sub.events if isinstance(e, CircuitClosed)]
    assert len(opened) == 1 and opened[0].endpoint == "https://events.test"
    assert opened[0].failures == 2
    assert len(closed) == 1 and closed[0].endpoint == "https://events.test"


def test_corrupt_spill_file_notifies_corruption_detected(tmp_path):
    from daft_tpu_torch.errors import DaftCorruptionError
    from daft_tpu_torch.integrity import hash_file, verify_file
    from daft_tpu_torch.metrics import get_registry
    from daft_tpu_torch.subscribers.events import CorruptionDetected

    f = tmp_path / "run.arrow"
    f.write_bytes(b"x" * 1000)
    digest = hash_file(str(f))
    s0 = get_registry().snapshot()
    verify_file(str(f), digest, "spill")
    f.write_bytes(b"y" * 1000)
    sub = _Collect()
    with _attached(sub), pytest.raises(DaftCorruptionError):
        verify_file(str(f), digest, "spill")
    hit = [e for e in sub.events if isinstance(e, CorruptionDetected)]
    assert len(hit) == 1 and hit[0].artifact == "spill" and hit[0].action == "quarantined"
    s1 = get_registry().snapshot()
    for name in ("daft_integrity_verified_total", "daft_integrity_failed_total",
                 "daft_integrity_quarantined_total"):
        assert s1.value(name, artifact="spill") - s0.value(name, artifact="spill") == 1, name


def test_operator_stats_events_equal_the_jax_packages():
    """At query end the RuntimeStats flush one OperatorStats per operator:
    the same operators with the same rows as the JAX package's."""
    def run(pkg, ev):
        got = []

        class Sub(ev.Subscriber):
            def on_event(self, e):
                if isinstance(e, ev.OperatorStats):
                    got.append((e.operator, e.rows_in, e.rows_out))

        ctx = pkg.get_context()
        sub = Sub()
        ctx.attach_subscriber(sub)
        try:
            df = pkg.from_pydict({"x": list(range(300)), "g": [i % 7 for i in range(300)]})
            df.where(pkg.col("x") > 5).groupby("g").agg(pkg.col("x").sum().alias("s")).collect()
        finally:
            ctx.detach_subscriber(sub)
        return sorted(got)

    with daft_tpu.execution_config_ctx(result_cache_enabled=False):
        theirs = run(daft_tpu, jax_events)
    assert run(daft_tpu_torch, events) == theirs
