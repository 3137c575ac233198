"""EXPLAIN ANALYZE, ``DataFrame.metrics()``, the profiler's operator table and
the metrics registry's deltas through both packages, on the CPU, on seeded
inputs: a filter into a grouped aggregation, a hash join, a sort, a window, a
parquet scan (the IO counters) and a grouped aggregation under a memory limit
(spill and permit waits).

For each query, run once in each package (the port with ``device="cpu"``):

* ``metrics()`` has the same operators with the same ``rows_in`` /
  ``rows_out``;
* ``query_profile.operator_table(by="plan_node")`` has the same plan-node
  labels with the same ``rows``, ``morsels``, ``device_rows``,
  ``fallback_rows`` and ``spill_bytes``;
* ``explain(analyze=True)`` prints the JAX package's lines less ``planner``
  (ROADMAP A.8.6), in the same order, the ``plan cache`` and ``flight
  record`` lines included, with equal counts on the ``device eval``,
  ``spill``, ``io`` and ``memory permits`` lines, the same tenant, outcome,
  shed level and plan fingerprint on the ``flight record`` line, and the same
  operators and rows in its table;
* the registry's counters move alike: the same series with the same deltas,
  the admission and query-log counters included;
* collecting with ``profile=True`` gives the same Arrow table as without, at
  ``num_compute_threads`` 1 and at the default.

The comparisons run at ``num_compute_threads=1``: at more threads a hash
join's probe-side prefetch races the build side for the first pull, and plan
nodes are numbered in first-pull order, in both packages alike.
"""

import contextlib
import io
import threading
import time
import warnings

import numpy as np
import pyarrow.parquet as papq
import pytest

import daft_tpu
import daft_tpu_torch
from daft_tpu import metrics as jax_metrics
from daft_tpu.execution.resource_manager import memory_limit as jax_limit
from daft_tpu_torch import metrics
from daft_tpu_torch.execution.resource_manager import memory_limit
from torch_isolation import admission_windows_reset  # noqa: F401

pytestmark = [pytest.mark.filterwarnings("ignore:Specifying null_placement:FutureWarning"),
              pytest.mark.usefixtures("admission_windows_reset")]

N = 20_000
#: A sink budget (a quarter of the limit) of 64 KiB against ~1 MB of state.
LIMIT = 256 * 1024
#: Lines of the JAX package's analyzed plan that read modules the port has
#: not yet (feedback, A.8.6).
A8_LINES = ("planner:",)
#: Counters whose deltas depend on the process's history, not on the query:
#: the chain programs' cache (each package's cache holds what earlier tests
#: built) and the seconds a stage's feeder was blocked.
HISTORY_COUNTERS = ("daft_compile_cache_hits_total", "daft_compile_cache_misses_total",
                    "daft_pipeline_stall_seconds_total")


@pytest.fixture(autouse=True)
def _configs():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        with daft_tpu.execution_config_ctx(result_cache_enabled=False, num_compute_threads=1,
                                           device_eval_min_rows=1), \
                daft_tpu_torch.execution_config_ctx(device="cpu", result_cache_enabled=False,
                                                    num_compute_threads=1,
                                                    device_eval_min_rows=1):
            yield


def data():
    rng = np.random.default_rng(11)
    return {"g": rng.integers(0, 40, N).astype(np.int64),
            "k": rng.integers(0, 500, N).astype(np.int64),
            "x": rng.random(N).astype(np.float32),
            "v": rng.standard_normal(N)}


def dim():
    return {"k": np.arange(500, dtype=np.int64), "w": np.arange(500) * 0.5}


def big():
    rng = np.random.default_rng(7)
    return {"k": rng.integers(0, 5_000, 50_000), "v": rng.standard_normal(50_000)}


def q_filter_groupby(p, tmp):
    c = p.col
    return (p.from_pydict(data()).where(c("x") > 0.25)
            .groupby("g").agg(c("v").sum().alias("s"), c("x").mean().alias("m")))


def q_hash_join(p, tmp):
    c = p.col
    return (p.from_pydict(data()).where(c("x") < 0.9)
            .join(p.from_pydict(dim()), on="k").select("g", "k", (c("v") * c("w")).alias("vw")))


def q_sort(p, tmp):
    return p.from_pydict(data()).sort(["g", "v"], desc=[False, True])


def q_window(p, tmp):
    from daft_tpu_torch.functions import rank as trank
    from daft_tpu.functions import rank as jrank

    rank = trank if p is daft_tpu_torch else jrank
    w = p.Window().partition_by("g").order_by("v")
    return p.from_pydict(data()).select("g", "v", rank().over(w).alias("r"))


def q_parquet_scan(p, tmp):
    c = p.col
    return (p.read_parquet(str(tmp / "*.parquet")).where(c("x") > 0.5)
            .select("g", (c("x") * 2.0).alias("x2")))


def q_spilling_groupby(p, tmp):
    c = p.col
    return p.from_pydict(big()).groupby("k").agg(c("v").sum().alias("s"))


CASES = {"filter_groupby": q_filter_groupby, "hash_join": q_hash_join, "sort": q_sort,
         "window": q_window, "parquet_scan": q_parquet_scan,
         "spilling_groupby": q_spilling_groupby}


@pytest.fixture
def files(tmp_path):
    d = data()
    for i in range(3):
        sl = slice(i * N // 3, (i + 1) * N // 3)
        papq.write_table(daft_tpu.from_pydict({k: v[sl] for k, v in d.items()}).to_arrow(),
                         str(tmp_path / f"part-{i}.parquet"))
    return tmp_path


@contextlib.contextmanager
def _limit(p, case):
    """The spilling case's memory limit, with every permit held by the test
    until the query's first acquire has waited 0.1 s (one permit wait, in
    both packages alike); a no-op for the other cases."""
    if case != "spilling_groupby":
        yield
        return
    with (memory_limit if p is daft_tpu_torch else jax_limit)(LIMIT) as mm:
        assert mm.acquire(LIMIT, timeout=1.0)
        asked = threading.Event()
        acquire = mm.acquire

        def first_asks(*args, **kwargs):
            asked.set()
            return acquire(*args, **kwargs)

        def release():
            asked.wait(timeout=30)
            time.sleep(0.1)
            mm.release(LIMIT)

        mm.acquire = first_asks
        releaser = threading.Thread(target=release)
        releaser.start()
        try:
            yield
        finally:
            asked.set()
            releaser.join(timeout=60)
            del mm.acquire
        assert not releaser.is_alive()


def _counter_deltas(reg, s0, s1):
    out = {}
    for name, inst in reg._instruments.items():
        if inst.kind != "counter" or name in HISTORY_COUNTERS:
            continue
        d = s1.counter_total(name) - s0.counter_total(name)
        if d:
            out[name] = d
    return out


def _run(p, case, tmp):
    """One profiled run and one EXPLAIN ANALYZE of ``case`` in package ``p``:
    (metrics(), the operator table, the analyzed text, the counter deltas)."""
    reg = (metrics if p is daft_tpu_torch else jax_metrics).get_registry()
    with _limit(p, case):
        s0 = reg.snapshot()
        q = CASES[case](p, tmp)
        q.collect(profile=True)
        s1 = reg.snapshot()
    ops = q.metrics()
    table = q.query_profile.operator_table(by="plan_node")
    buf = io.StringIO()
    with _limit(p, case), contextlib.redirect_stdout(buf):
        CASES[case](p, tmp).explain(analyze=True)
    return ops, table, buf.getvalue(), _counter_deltas(reg, s0, s1)


def _analyze_lines(text):
    body = text.split("== Analyze ==\n", 1)[1].splitlines()
    return [ln for ln in body if not ln.startswith(A8_LINES)]


def _record_facts(line):
    """The ``flight record`` line's fields less the admission wait."""
    return [p for p in line.split(":", 1)[1].split() if not p.startswith("admission_wait=")]


def _counts(line):
    """The integer counts of a summary line (``name=value`` pairs, seconds
    left out: they are wall times)."""
    out = {}
    for part in line.split(":", 1)[1].split(","):
        if "=" in part:
            k, v = part.strip().split("=", 1)
            if not k.endswith("_s") and v.isdigit():
                out[k] = int(v)
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_metrics_rows_equal_the_jax_packages(case, files):
    ours = _run(daft_tpu_torch, case, files)[0]
    theirs = _run(daft_tpu, case, files)[0]
    assert set(ours) == set(theirs)
    for op in theirs:
        assert (ours[op]["rows_in"], ours[op]["rows_out"]) == \
            (theirs[op]["rows_in"], theirs[op]["rows_out"]), op


@pytest.mark.parametrize("case", list(CASES))
def test_operator_table_equals_the_jax_packages(case, files):
    keys = ("rows", "morsels", "device_rows", "fallback_rows", "spill_bytes")

    def rows(table):
        return {r["plan_node"]: tuple(r[k] for k in keys) for r in table}

    ours = rows(_run(daft_tpu_torch, case, files)[1])
    theirs = rows(_run(daft_tpu, case, files)[1])
    assert ours == theirs
    if case == "spilling_groupby":
        assert sum(v[4] for v in ours.values()) > 0


@pytest.mark.parametrize("case", list(CASES))
def test_explain_analyze_lines_equal_the_jax_packages(case, files):
    ours = _analyze_lines(_run(daft_tpu_torch, case, files)[2])
    theirs = _analyze_lines(_run(daft_tpu, case, files)[2])

    def kinds(lines):
        head = lines[:lines.index("operators (by self time):")]
        return [ln.split(":", 1)[0] for ln in head]

    assert kinds(ours) == kinds(theirs)
    assert ours[0].split(",")[0] == theirs[0].split(",")[0]  # rows: N
    by_kind = {ln.split(":", 1)[0]: ln for ln in theirs}
    for ln in ours:
        kind = ln.split(":", 1)[0]
        if kind in ("device eval", "spill", "io", "integrity"):
            assert ln == by_kind[kind]  # counts only, fallback reasons included
        elif kind == "memory permits":
            assert _counts(ln) == _counts(by_kind[kind])  # waits; wait_s is a time
        elif kind == "flight record":
            # The admission wait is a time; the rest is the record's facts.
            assert _record_facts(ln) == _record_facts(by_kind[kind])
    # The operator table: the same operators with the same rows, and "-"
    # for the planner's estimates (ROADMAP A.8).
    table = ours[ours.index("operators (by self time):") + 2:]
    jtable = theirs[theirs.index("operators (by self time):") + 2:]
    assert sorted((r.split()[0], r.split()[1]) for r in table) == \
        sorted((r.split()[0], r.split()[1]) for r in jtable)
    assert all(r.split()[2] == "-" and r.split()[3] == "-" for r in table)
    if case == "spilling_groupby":
        assert "spill" in kinds(ours) and "memory permits" in kinds(ours)
    if case == "parquet_scan":
        assert "io" in kinds(ours)


@pytest.mark.parametrize("case", list(CASES))
def test_registry_deltas_equal_the_jax_packages(case, files):
    ours = _run(daft_tpu_torch, case, files)[3]
    theirs = _run(daft_tpu, case, files)[3]
    assert set(ours) == set(theirs)
    assert {"daft_queries_started_total", "daft_executor_morsels_total",
            "daft_executor_rows_total", "daft_admission_admitted_total",
            "daft_querylog_records_total"} <= set(ours)
    assert ours == theirs


@pytest.mark.parametrize("threads", [1, 0])
@pytest.mark.parametrize("case", list(CASES))
def test_profile_on_gives_the_same_bytes(case, threads, files):
    with daft_tpu_torch.execution_config_ctx(num_compute_threads=threads), \
            _limit(daft_tpu_torch, case):
        plain = CASES[case](daft_tpu_torch, files).to_arrow()
        q = CASES[case](daft_tpu_torch, files)
        q.collect(profile=True)
        assert q.query_profile is not None
        assert q.to_arrow().equals(plain)
