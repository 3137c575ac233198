"""Windows in the port (``daft_tpu_torch/execution/window_eval.py``, the
``Window`` node, ``Expression.over`` and windows in SQL) against the JAX
package, on the CPU.

Mirrors ``tests/test_window.py`` case for case through both packages
(``device="cpu"`` for the port): each case must give the JAX package's rows
and the values that the JAX test asserts. Then seeded tables (nulls, ties,
NaN, strings) go through every window function, frame and aggregate in both
packages: the rows and their order must be equal; ranks, counts, integer
sums, min, max and the navigation functions bit for bit, and so the float
sums and means over a ``rows_between`` frame; a whole-partition float sum,
mean or stddev within ``WHOLE_PARTITION_RTOL``, which is 0: the port sums each
partition in the order of Arrow's ``sum`` as the JAX package does (ROADMAP
C.41; it was 1e-12 while the port took one grouped sum). Then C.40: uint64
order keys on both sides of 2^63. Last, C.39 itself: the port's window
evaluation does linear work, by its pass counter and by its time at 10x the
rows.
"""

import time
import warnings

import numpy as np
import pyarrow as pa
import pytest

import daft_tpu
import daft_tpu_torch
from daft_tpu_torch.execution.window_eval import window_work

PKGS = (daft_tpu, daft_tpu_torch)
WHOLE_PARTITION_RTOL = 0.0


@pytest.fixture(autouse=True)
def _cpu():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        with daft_tpu.execution_config_ctx(result_cache_enabled=False), \
                daft_tpu_torch.execution_config_ctx(device="cpu", result_cache_enabled=False):
            yield


def _F(pkg):
    return __import__(f"{pkg.__name__}.functions", fromlist=["x"])


def _both(build) -> dict:
    """``build(pkg, F)``'s rows in the port, held equal to the JAX package's."""
    jax, port = (build(pkg, _F(pkg)) for pkg in PKGS)
    assert port == jax
    return port


def _df(p):
    return p.from_pydict({"g": ["a", "a", "a", "b", "b"], "v": [3, 1, 2, 10, 10]})


# -- tests/test_window.py, case for case --------------------------------------
def test_partition_agg():
    out = _both(lambda p, F: _df(p).select(
        "g", "v", p.col("v").sum().over(p.Window().partition_by("g")).alias("gs"))
        .sort(["g", "v"]).to_pydict())
    assert out["gs"] == [6, 6, 6, 20, 20]


def test_row_number():
    out = _both(lambda p, F: _df(p).select(
        "g", "v", F.row_number().over(p.Window().partition_by("g").order_by("v")).alias("rn"))
        .sort(["g", "v"]).to_pydict())
    assert out["rn"] == [1, 2, 3, 1, 2]


def test_rank_dense_rank():
    def run(p, F):
        w = p.Window().partition_by("g").order_by("v")
        return _df(p).select("g", "v", F.rank().over(w).alias("r"),
                             F.dense_rank().over(w).alias("dr")).sort(["g", "v"]).to_pydict()

    out = _both(run)
    assert out["r"] == [1, 2, 3, 1, 1] and out["dr"] == [1, 2, 3, 1, 1]


def test_mean_over():
    out = _both(lambda p, F: _df(p).select(
        "g", p.col("v").mean().over(p.Window().partition_by("g")).alias("m"))
        .sort("g").to_pydict())
    assert out["m"][0] == pytest.approx(2.0) and out["m"][3] == pytest.approx(10.0)


def test_rows_between_running_sum():
    def run(p, F):
        W = p.Window
        w = W().partition_by("g").order_by("v").rows_between(W.unbounded_preceding, W.current_row)
        return _df(p).select("g", "v", p.col("v").sum().over(w).alias("run")) \
            .sort(["g", "v"]).to_pydict()

    assert _both(run)["run"] == [1, 3, 6, 10, 20]


def test_rows_between_centered_and_trailing():
    def run(p, F):
        w = p.Window().partition_by("g").order_by("v").rows_between(-1, 1)
        w2 = p.Window().partition_by("g").order_by("v").rows_between(-1, 0)
        return (_df(p).select("g", "v", p.col("v").mean().over(w).alias("m"))
                .sort(["g", "v"]).to_pydict(),
                _df(p).select("g", "v", p.col("v").max().over(w2).alias("mx"))
                .sort(["g", "v"]).to_pydict())

    out, out2 = _both(run)
    assert out["m"] == [1.5, 2.0, 2.5, 10.0, 10.0] and out2["mx"] == [1, 2, 3, 10, 10]


def test_rows_between_count_with_nulls():
    def run(p, F):
        df = p.from_pydict({"g": ["a"] * 4, "t": [1, 2, 3, 4], "v": [1, None, 3, None]})
        W = p.Window
        w = W().partition_by("g").order_by("t").rows_between(W.unbounded_preceding, W.current_row)
        return df.select("t", p.col("v").count().over(w).alias("c")).sort("t").to_pydict()

    assert _both(run)["c"] == [1, 1, 2, 2]


# -- seeded tables through every function --------------------------------------
def _table(seed: int, n: int = 400) -> dict:
    rng = np.random.default_rng(seed)
    f = rng.standard_normal(n) * 100
    f[rng.integers(0, n, 5)] = np.nan
    return {
        "g": [None if i % 37 == 5 else int(x) for i, x in enumerate(rng.integers(0, 17, n))],
        "h": rng.choice(["p", "q", "r"], n).tolist(),
        "o": rng.integers(0, 25, n).tolist(),  # ties within a partition
        "o2": [None if i % 23 == 0 else float(x) for i, x in enumerate(rng.integers(0, 9, n))],
        "i": [None if i % 13 == 2 else int(x) for i, x in enumerate(rng.integers(-10**6, 10**6, n))],
        "f": [None if i % 11 == 7 else float(x) for i, x in enumerate(f)],
        "s": [None if i % 9 == 4 else str(x) for i, x in enumerate(rng.choice(
            ["ant", "bee", "cat", "dog", "ému", ""], n))],
    }


def _windows(p):
    W = p.Window
    base = W().partition_by("g").order_by("o")
    return {
        "none": W().partition_by("g"),
        "ordered": base,
        "desc": W().partition_by("g", "h").order_by("o", "o2", desc=[True, False]),
        "global": W().order_by("o2"),
        "int_nulls": W().partition_by("h").order_by("i"),
        "int_nulls_desc": W().partition_by("h").order_by("i", desc=True),
        "running": base.rows_between(W.unbounded_preceding, W.current_row),
        "trailing": base.rows_between(-3, 0),
        "centered": base.rows_between(-2, 5),
        "ahead": base.rows_between(1, 4),
        "rest": base.rows_between(0, W.unbounded_following),
        "whole": base.rows_between(W.unbounded_preceding, W.unbounded_following),
        "empty": base.rows_between(3, 1),
    }


RANKS = ["row_number", "rank", "dense_rank", "percent_rank"]
NAVS = [("lag", {}), ("lag", {"offset": 3, "default": 0}), ("lead", {}),
        ("lead", {"offset": 2}), ("first_value", None), ("last_value", None)]
FRAMES = ["running", "trailing", "centered", "ahead", "rest", "whole", "empty"]


def _exprs(p, F):
    col, ws, out = p.col, _windows(p), []
    for fn in RANKS:
        for w in ("ordered", "desc", "global", "none", "int_nulls", "int_nulls_desc"):
            out.append(getattr(F, fn)().over(ws[w]).alias(f"{fn}_{w}"))
    for i, (fn, kw) in enumerate(NAVS):
        for c in ("i", "f", "s"):
            e = getattr(col(c), fn)(**kw) if kw is not None else getattr(col(c), fn)()
            if fn == "lag" and kw and c == "s":
                e = col(c).lag(3, "zz")
            out.append(e.over(ws["desc"] if i % 2 else ws["ordered"]).alias(f"{fn}{i}_{c}"))
            out.append(e.over(ws["int_nulls_desc"] if i % 2 else ws["int_nulls"])
                       .alias(f"{fn}{i}_{c}_by_i"))
    for frame in FRAMES:
        for c, fns in (("i", ("sum", "mean", "count", "min", "max")),
                       ("f", ("sum", "mean", "count", "min", "max")),
                       ("s", ("count", "min", "max"))):
            for fn in fns:
                out.append(getattr(col(c), fn)().over(ws[frame]).alias(f"{fn}_{c}_{frame}"))
    for c, fns in (("i", ("sum", "mean", "count", "min", "max", "stddev")),
                   ("f", ("count", "min", "max")), ("s", ("count", "min", "max"))):
        for fn in fns:
            out.append(getattr(col(c), fn)().over(ws["none"]).alias(f"{fn}_{c}_whole_partition"))
    return out


@pytest.mark.parametrize("seed, packed", [(0, True), (1, True), (2, True), (3, False)])
def test_every_window_function_equals_the_jax_package(seed, packed, monkeypatch):
    """``packed=False`` takes the stable argsorts that stand in where the
    sort keys do not pack into one int64."""
    from daft_tpu_torch.execution import window_eval

    if not packed:
        monkeypatch.setattr(window_eval, "_PACK_BITS", 0)
    data = _table(seed)
    jax, port = (pkg.from_pydict(data).select("g", "o", *_exprs(pkg, _F(pkg))).to_pydict()
                 for pkg in PKGS)
    _assert_rows_equal(jax, port, {n for n in jax if n.endswith("whole_partition")})


def _assert_rows_equal(jax: dict, port: dict, whole_partition=()):
    """Equal rows in the same order: NaN equal to NaN, the columns in
    ``whole_partition`` within ``WHOLE_PARTITION_RTOL``, the rest exactly."""
    assert list(port) == list(jax)
    for name in jax:
        a, b = jax[name], port[name]
        tol = WHOLE_PARTITION_RTOL if name in whole_partition else 0.0
        assert len(a) == len(b), name
        for x, y in zip(a, b):
            if isinstance(x, float) and isinstance(y, float):
                assert (x != x and y != y) or x == y or abs(x - y) <= tol * abs(x), (name, x, y)
            else:
                assert x == y, (name, x, y)


def test_windows_equal_the_jax_package_through_a_filter_and_a_sort():
    """A window over a filtered input, under a sort and a projection that
    reads it (the plan shape of phase 16's queries)."""
    data = _table(5, 1000)

    def run(p, F):
        W = p.Window
        w = W().partition_by("g").order_by("o").rows_between(W.unbounded_preceding, W.current_row)
        return (p.from_pydict(data).where(p.col("o") > 3)
                .select("g", "o", "i", p.col("i").sum().over(w).alias("run"),
                        p.col("i").lag(1).over(W().partition_by("g").order_by("o")).alias("prev"),
                        F.rank().over(W().partition_by("h").order_by("f", desc=True)).alias("r"))
                .where(p.col("run").not_null()).sort(["g", "o", "i"]).to_pydict())

    assert _both(run)["run"]


SQL_WINDOWS = [
    "SELECT g, o, sum(i) OVER (PARTITION BY g ORDER BY o) AS s FROM t",
    "SELECT g, count(*) OVER (PARTITION BY g) AS n, avg(f) OVER (PARTITION BY g, h) AS m FROM t",
    "SELECT h, row_number() OVER (PARTITION BY h ORDER BY o DESC, i) AS rn FROM t",
    "SELECT g, rank() OVER (PARTITION BY g ORDER BY o) AS r, "
    "dense_rank() OVER (PARTITION BY g ORDER BY o) AS dr, "
    "percent_rank() OVER (PARTITION BY g ORDER BY o) AS pr FROM t",
    "SELECT i, lag(i, 2, 0) OVER (PARTITION BY g ORDER BY o) AS l2, "
    "lead(s) OVER (PARTITION BY g ORDER BY o) AS ls FROM t",
    "SELECT g, min(f) OVER (PARTITION BY g ORDER BY o ROWS BETWEEN 2 PRECEDING AND 1 FOLLOWING) "
    "AS mn, max(s) OVER (PARTITION BY g ORDER BY o ROWS BETWEEN CURRENT ROW AND UNBOUNDED "
    "FOLLOWING) AS mx FROM t",
    "SELECT first_value(s) OVER (PARTITION BY h ORDER BY o) AS fv, "
    "last_value(i) OVER (PARTITION BY h ORDER BY o) AS lv FROM t",
]


@pytest.mark.parametrize("query", SQL_WINDOWS)
def test_sql_windows_equal_the_jax_package(query):
    """Windows in SQL (``OVER``, the running frame an ordered aggregate gets
    by default, ``ROWS BETWEEN``) with the JAX package's rows and order."""
    data = _table(3, 300)
    jax, port = (p.sql(query, t=p.from_pydict(data)).to_pydict() for p in PKGS)
    _assert_rows_equal(jax, port, {"m"})  # avg over a whole partition


def test_range_between_raises_as_in_the_jax_package():
    msgs = []
    for p in PKGS:
        w = p.Window().partition_by("g").order_by("o").range_between(-1, 1)
        with pytest.raises(Exception) as e:
            p.from_pydict(_table(0, 20)).select(p.col("i").sum().over(w).alias("x")).to_pydict()
        msgs.append(str(e.value))
    assert "range" in msgs[1] and msgs[0] == msgs[1]


# -- C.40: uint64 order keys ----------------------------------------------------
def _c40(p, F):
    """ROADMAP C.40's input and its four expressions."""
    data = {"u": np.array([1, 2**64 - 1, 3], dtype=np.uint64), "k": [1, 1, 1], "x": [10, 20, 30]}
    W = p.Window
    w = W().partition_by("k").order_by("u")
    out = p.from_pydict(data).select(
        F.rank().over(w).alias("r"),
        p.col("x").sum().over(w.rows_between(W.unbounded_preceding, W.current_row)).alias("s"),
        p.col("x").lag(1).over(w).alias("l")).to_pydict()
    out["sql_desc"] = p.sql("SELECT rank() OVER (ORDER BY u DESC) AS r FROM t",
                            t=p.from_pydict(data)).to_pydict()["r"]
    return out


def test_uint64_order_keys_above_2_63_rank_as_in_the_jax_package():
    """ROADMAP C.40: a uint64 order key at or above 2^63 wrapped negative in
    the port's integer ranking; the JAX package sorts it with Arrow."""
    assert _both(_c40) == {"r": [1, 3, 2], "s": [10, 60, 40], "l": [None, 30, 10],
                           "sql_desc": [3, 1, 2]}


@pytest.mark.parametrize("seed", [0, 1])
def test_uint64_keys_on_both_sides_of_2_63_equal_the_jax_package(seed):
    """Seeded uint64 keys near 0 and near 2^64 (``near``: the offset
    ranking) and keys on both sides of 2^63 (``wide``: the argsort), with
    nulls and ties, through the ranks, ``lag`` and a running sum, ascending
    and descending, in both packages."""
    rng = np.random.default_rng(seed)
    n = 300
    # Near 0 and near 2^64: as int64 they would wrap to a span under 2^40.
    near = rng.integers(-50, 50, n).astype(np.int64).astype(np.uint64)
    wide = rng.choice(np.array([0, 7, 2**63 - 1, 2**63, 2**63 + 5, 2**64 - 1], dtype=np.uint64), n)
    data = {"g": rng.integers(0, 6, n).tolist(),
            "near": pa.array([None if i % 17 == 3 else int(v) for i, v in enumerate(near)],
                             pa.uint64()),
            "wide": pa.array([None if i % 19 == 4 else int(v) for i, v in enumerate(wide)],
                             pa.uint64()),
            "x": rng.integers(-1000, 1000, n).tolist()}

    def run(p, F):
        W = p.Window
        df = p.from_pydict(data)
        exprs = []
        for key in ("near", "wide"):
            for desc in (False, True):
                w = W().partition_by("g").order_by(key, desc=desc)
                tag = f"{key}_{'desc' if desc else 'asc'}"
                exprs += [F.rank().over(w).alias(f"rank_{tag}"),
                          F.dense_rank().over(w).alias(f"dense_{tag}"),
                          F.row_number().over(w).alias(f"rn_{tag}"),
                          p.col("x").lag(1).over(w).alias(f"lag_{tag}"),
                          p.col("x").sum().over(w.rows_between(
                              W.unbounded_preceding, W.current_row)).alias(f"run_{tag}")]
        return df.select("g", *exprs).to_pydict()

    _both(run)


# -- C.41: whole-partition float sums in Arrow's order ---------------------------
def _c41_table(seed: int) -> dict:
    """Partitions of 1-1000 rows interleaved in row order, values over nine
    decades with nulls, NaN and -0.0."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, 1001, 120)
    g = rng.permutation(np.repeat(np.arange(len(sizes)), sizes))
    n = len(g)
    f = rng.standard_normal(n) * 10.0 ** rng.integers(-4, 5, n)
    f[rng.random(n) < 0.002] = np.nan
    f[rng.random(n) < 0.01] = -0.0
    null = rng.random(n) < 0.15
    null[np.isin(g, np.arange(5))] = True  # a few partitions with no value
    return {"g": g.tolist(), "o": rng.integers(0, 50, n).tolist(),
            "f": [None if m else float(x) for m, x in zip(null, f)],
            "i": [None if m else int(x) for m, x in zip(null, rng.integers(-10**12, 10**12, n))]}


@pytest.mark.parametrize("seed", [0, 1])
def test_whole_partition_float_sums_are_bit_equal_to_the_jax_package(seed):
    """ROADMAP C.41: a whole-partition ``sum`` / ``mean`` over f64 and f32,
    and ``stddev`` over f64 and int64, held to 0 against the JAX package's
    Arrow kernels per partition, with and without an order key."""
    data = _c41_table(seed)

    def run(p, F):
        W = p.Window
        df = p.from_pydict(data).with_column("f32", p.col("f").cast(p.DataType.float32()))
        exprs = []
        for tag, w in (("plain", W().partition_by("g")),
                       ("ordered", W().partition_by("g").order_by("o"))):
            exprs += [p.col("f").sum().over(w).alias(f"sum_f_{tag}"),
                      p.col("f").mean().over(w).alias(f"mean_f_{tag}"),
                      p.col("f").stddev().over(w).alias(f"std_f_{tag}"),
                      p.col("f32").sum().over(w).alias(f"sum_f32_{tag}"),
                      p.col("f32").mean().over(w).alias(f"mean_f32_{tag}"),
                      p.col("i").stddev().over(w).alias(f"std_i_{tag}")]
        return df.select("g", *exprs).to_pydict()

    jax, port = (run(p, _F(p)) for p in PKGS)
    assert WHOLE_PARTITION_RTOL == 0.0
    _assert_rows_equal(jax, port, set(jax))
    assert {n: type(v[5]) for n, v in jax.items()} == {n: type(v[5]) for n, v in port.items()}


# -- C.39: linear work --------------------------------------------------------
def _c39_table(rows: int, seed: int = 11) -> dict:
    """About 4 rows a partition, as SF10's orders per customer run, so the
    partitions grow with the rows."""
    rng = np.random.default_rng(seed)
    return {"k": rng.integers(0, max(rows // 4, 1), rows).tolist(),
            "d": rng.integers(0, 2500, rows).tolist(),
            "x": rng.standard_normal(rows).tolist()}


def _c39_query(p, data):
    W = p.Window
    w = W().partition_by("k").order_by("d")
    return p.from_pydict(data).select(
        "k", "d",
        p.col("x").sum().over(w.rows_between(W.unbounded_preceding, W.current_row)).alias("run"),
        p.col("x").lag(1).over(w).alias("prev"),
        _F(p).rank().over(w).alias("r"),
        p.col("x").max().over(w.rows_between(-2, 0)).alias("mx"),
        p.col("x").count().over(W().partition_by("k")).alias("n"))


def _best_of(k, fn) -> float:
    best = float("inf")
    for _ in range(k):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def test_windows_evaluate_in_linear_work():
    """ROADMAP C.39. The JAX package takes ``np.nonzero(group_ids == g)`` per
    partition and walks the rows in Python: O(rows x partitions). At a size
    it can run, the port's rows equal its own (floats bit for bit: a frame's
    sums are per-segment prefix sums in the JAX package's order). Then the
    port's work: its whole-array passes (``window_work``) stay within 64
    passes a row at 2,000 and at 20,000 rows (with 4x as many partitions as
    before), and 10x the rows takes at most 30x the time (best of three
    each; a quadratic evaluation would take about 100x)."""
    small = _c39_table(2000)
    jax = _c39_query(daft_tpu, small).to_pydict()
    window_work.reset()
    port = _c39_query(daft_tpu_torch, small).to_pydict()
    assert port == jax
    per_row = {}
    per_row[2000] = window_work.rows / 2000
    big = _c39_table(20000)
    window_work.reset()
    _c39_query(daft_tpu_torch, big).to_pydict()
    per_row[20000] = window_work.rows / 20000
    assert all(0 < v <= 64 for v in per_row.values()), per_row
    assert abs(per_row[20000] - per_row[2000]) <= 4, per_row  # no term in the partitions

    from daft_tpu_torch.execution.window_eval import eval_windows
    from daft_tpu_torch.recordbatch import RecordBatch

    def timed(data):
        df = _c39_query(daft_tpu_torch, data)
        node = df._builder.plan.children()[0]
        rb = RecordBatch.from_pydict(data)
        return _best_of(3, lambda: eval_windows(rb, node.window_exprs, node.schema))

    t1, t10 = timed(_c39_table(20000)), timed(_c39_table(200000))
    assert t10 <= 30 * t1, (t1, t10)


# -- chip_smoke.py phase 16's queries (tools/windows.py) at a small scale --------
@pytest.fixture(scope="module")
def tables():
    from daft_tpu_torch.tools import tpch

    return tpch.tpch_tables(0.01, seed=0, sql=True)


def test_phase16_orders_windows_equal_their_reference(tables):
    from daft_tpu_torch.micropartition import MicroPartition
    from daft_tpu_torch.tools import windows as W

    since = int(np.percentile(tables["orders"]["o_orderdate"], 20))
    with daft_tpu_torch.execution_config_ctx(device_eval_min_rows=1):
        df = W.orders_windows(daft_tpu_torch, W.orders_frame(daft_tpu_torch, tables), since)
        table = MicroPartition.concat(list(df.iter_partitions())).to_arrow_table()
    assert W.orders_windows_compare(table, W.orders_windows_reference(tables, since), 1e-6) == []
    jdf = W.orders_windows(daft_tpu, W.orders_frame(daft_tpu, tables), since)
    assert jdf.to_pydict() == df.to_pydict()  # the JAX package's rows, bit for bit


@pytest.mark.parametrize("query", ["row_number", "explode", "ids", "pivot", "sets", "ratio"])
def test_phase16_lineitem_queries_equal_their_references(tables, query):
    from daft_tpu_torch.tools import tpch
    from daft_tpu_torch.tools import windows as W

    li = tables["lineitem"]
    lf = W.lineitem_frame(daft_tpu_torch, tables)
    if query == "row_number":
        got = W.lineitem_row_number(daft_tpu_torch, lf).to_pydict()["rn"]
        assert np.array_equal(got, W.row_number_reference(tables))
    elif query == "explode":
        out = W.exploded_lists(daft_tpu_torch, lf).to_pydict()
        assert np.array_equal(W.pairs(np.array(out["l_orderkey"]), np.array(out["l_partkey"])),
                              W.pairs(li["l_orderkey"], li["l_partkey"]))
    elif query == "ids":
        out = W.with_ids(daft_tpu_torch, lf).to_pydict()
        assert out["id"] == list(range(len(li["l_orderkey"])))
    elif query == "pivot":
        assert W.q01_pivot(daft_tpu_torch, lf).to_pydict() == W.q01_pivot_reference(tables)
    elif query == "sets":
        got = [np.sort(df.to_pydict()["l_suppkey"]) for df in W.suppkey_sets(daft_tpu_torch, lf)]
        want = W.suppkey_sets_reference(tables)
        assert all(np.array_equal(g, w) for g, w in zip(got, want)) and len(want[0])
    else:
        frames = tpch.sql_frames(daft_tpu_torch, {"lineitem": li})
        got = np.array(daft_tpu_torch.sql(W.RATIO_SQL, **frames).to_pydict()["ratio"])
        want = W.ratio_reference(tables)
        assert np.max(np.abs(got - want) / want) <= 1e-5
