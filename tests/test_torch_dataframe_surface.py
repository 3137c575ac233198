"""The DataFrame surface and the top-level API of the port against the JAX
package, on the CPU.

Mirrors ``tests/test_dataframe.py`` case for case: each case runs the same
data through both packages (``device="cpu"`` for the port) and must give the
JAX package's rows and the value that the JAX test asserts. The UDF and UDAF
cases run through the local engine: ``test_udaf_incremental_partials`` takes
its partials from small aggregation chunks, where the JAX test takes them
from its distributed runner. Left with the JAX package: ``test_shard`` and
the distributed half of the DDSketch case (A.8).

Then every method this slice adds, each through both packages on the same
seeded input: the constructors (``from_pylist``, ``from_arrow``,
``from_pandas``, ``range``), the introspection and the preview (``columns``,
``in``, ``df[...]``, ``explain``, ``repr``, ``_repr_html_``, ``show``), the
transformations and counts (``with_column_renamed``, ``describe``,
``summarize``, ``into_batches``, ``transform``,
``add_monotonically_increasing_id``, ``count_rows``, ``len``,
``num_partitions``, ``skip_existing``), the exporters (``iter_rows``,
``to_pylist``, ``to_arrow``, ``to_arrow_iter``, ``to_pandas``, the torch
datasets and loader, ``to_dask_dataframe`` / ``to_ray_dataset``), the
planning config and its setters, ``Expr.is_literal``, and the top level's
names. Where the port leaves a name out, it must raise naming its ROADMAP
item.
"""

import warnings

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest
import torch

import daft_tpu
import daft_tpu_torch
from daft_tpu_torch.errors import DaftNotImplementedError

PKGS = (daft_tpu, daft_tpu_torch)


@pytest.fixture(autouse=True)
def _cpu():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        with daft_tpu.execution_config_ctx(result_cache_enabled=False), \
                daft_tpu_torch.execution_config_ctx(device="cpu"):
            yield


def _both(build):
    """``build(pkg)`` in the port, held equal to the JAX package's."""
    jax, port = (build(pkg) for pkg in PKGS)
    assert port == jax
    return port


def _df(p):
    return p.from_pydict({"a": list(range(10)), "b": ["x", "y"] * 5,
                          "c": [float(i) for i in range(10)]})


def _seeded(seed: int = 0, n: int = 200) -> dict:
    rng = np.random.default_rng(seed)
    return {"i": [None if k % 13 == 2 else int(x) for k, x in enumerate(rng.integers(-99, 99, n))],
            "f": [None if k % 11 == 7 else float(x) for k, x in enumerate(rng.standard_normal(n))],
            "s": [None if k % 9 == 4 else str(x) for k, x in enumerate(
                rng.choice(["ant", "bee", "", "ümlaut"], n))],
            "b": rng.random(n).round().astype(bool).tolist()}


# -- tests/test_dataframe.py, case for case ------------------------------------
def test_select_where_sort():
    out = _both(lambda p: _df(p).where(p.col("a") > 3)
                .select("a", "b", (p.col("c") * 2).alias("c2")).sort("a", desc=True).to_pydict())
    assert out["a"] == [9, 8, 7, 6, 5, 4] and out["c2"][0] == 18.0


def test_with_column():
    assert _both(lambda p: _df(p).with_column("d", p.col("a") + 100).limit(2)
                 .to_pydict())["d"] == [100, 101]


def test_exclude_rename():
    out = _both(lambda p: (_df(p).exclude("b").column_names,
                           _df(p).with_column_renamed("a", "aa").column_names))
    assert out == (["a", "c"], ["aa", "b", "c"])


def test_groupby_agg():
    out = _both(lambda p: _df(p).groupby("b").agg(
        p.col("a").sum().alias("sa"), p.col("c").mean().alias("mc")).sort("b").to_pydict())
    assert out == {"b": ["x", "y"], "sa": [20, 25], "mc": [4.0, 5.0]}


def test_global_agg():
    out = _both(lambda p: _df(p).agg(p.col("a").sum().alias("s"), p.col("a").count().alias("n"),
                                     (p.col("a").mean() * 2).alias("m2")).to_pydict())
    assert out == {"s": [45], "n": [10], "m2": [9.0]}


def test_count_rows():
    out = _both(lambda p: (_df(p).count_rows(), _df(p).where(p.col("b") == "x").count_rows()))
    assert out == (10, 5)


def test_join():
    def run(p):
        out = _df(p).join(p.from_pydict({"b": ["x"], "v": [100]}), on="b")
        return out.count_rows(), out.column_names

    n, names = _both(run)
    assert n == 5 and "v" in names and names.count("b") == 1


def test_join_left():
    out = _both(lambda p: _df(p).join(p.from_pydict({"b": ["x"], "v": [100]}), on="b",
                                      how="left").sort("a").to_pydict())
    assert out["v"] == [100, None] * 5


def test_concat():
    assert _both(lambda p: _df(p).concat(_df(p)).count_rows()) == 20


def test_distinct():
    assert _both(lambda p: _df(p).select("b").distinct().count_rows()) == 2


def test_explode():
    out = _both(lambda p: p.from_pydict({"i": [1, 2], "l": [[1, 2], [3]]}).explode("l")
                .to_pydict())
    assert out == {"i": [1, 1, 2], "l": [1, 2, 3]}


def test_limit_offset():
    out = _both(lambda p: (_df(p).limit(3).to_pydict()["a"],
                           _df(p).limit(3, offset=2).to_pydict()["a"]))
    assert out == ([0, 1, 2], [2, 3, 4])


def test_sample():
    n_frac, n_size = _both(lambda p: (_df(p).sample(0.5, seed=1).count_rows(),
                                      _df(p).sample(size=3, seed=1).count_rows()))
    assert n_frac <= 10 and n_size == 3


def test_monotonic_id():
    assert _both(lambda p: _df(p).add_monotonically_increasing_id("rid")
                 .to_pydict())["rid"] == list(range(10))


def test_pivot():
    out = _both(lambda p: p.from_pydict({"g": ["a", "a", "b"], "k": ["x", "y", "x"],
                                         "v": [1, 2, 3]})
                .pivot("g", "k", "v", "sum", names=["x", "y"]).sort("g").to_pydict())
    assert out == {"g": ["a", "b"], "x": [1, 3], "y": [2, None]}


def test_unpivot():
    assert _both(lambda p: _df(p).unpivot(["b"], ["a", "c"]).count_rows()) == 20


def test_intersect_except():
    def run(p):
        d1, d2 = p.from_pydict({"a": [1, 2, 3]}), p.from_pydict({"a": [2, 3, 4]})
        return sorted(d1.intersect(d2).to_pydict()["a"]), d1.except_distinct(d2).to_pydict()["a"]

    assert _both(run) == ([2, 3], [1])


def test_iter_rows():
    assert _both(lambda p: list(_df(p).limit(2).iter_rows()))[0] == {"a": 0, "b": "x", "c": 0.0}


def test_to_pandas_arrow():
    frames = [(_df(p).to_pandas(), _df(p).to_arrow()) for p in PKGS]
    (jpdf, jat), (pdf, at) = frames
    assert len(pdf) == 10 and at.num_rows == 10
    pd.testing.assert_frame_equal(pdf, jpdf)
    assert at.equals(jat)


def test_repartition():
    assert _both(lambda p: _df(p).repartition(3, "b").count_rows()) == 10


def test_into_partitions():
    assert _both(lambda p: _df(p).into_partitions(4).count_rows()) == 10


def test_udf_rowwise():
    def run(p):
        @p.udf.func(return_dtype=p.DataType.int64())
        def add_one(x):
            return x + 1

        return _df(p).select(add_one(p.col("a")).alias("a1")).limit(3).to_pydict()

    assert _both(run)["a1"] == [1, 2, 3]


def test_udf_batch():
    def run(p):
        @p.udf.func.batch(return_dtype=p.DataType.float64())
        def double(s):
            return s.to_numpy() * 2.0

        return _df(p).select(double(p.col("c")).alias("c2")).limit(2).to_pydict()

    assert _both(run)["c2"] == [0.0, 2.0]


def test_stateful_cls_udf():
    def run(p):
        @p.udf.cls(max_concurrency=2)
        class Scaler:
            def __init__(self, k):
                self.k = k

            @p.udf.method(return_dtype=p.DataType.int64())
            def scale(self, x):
                return x * self.k

        return _df(p).select(Scaler(3).scale(p.col("a")).alias("s")).limit(3).to_pydict()

    assert _both(run)["s"] == [0, 3, 6]


def test_limit_offset_composition():
    assert _both(lambda p: p.from_pydict({"a": list(range(20))}).limit(10).offset(5)
                 .to_pydict()["a"]) == [5, 6, 7, 8, 9]


def test_monotonic_id_not_renumbered_by_filter():
    assert _both(lambda p: p.from_pydict({"x": [1, 2, 3, 4]}).add_monotonically_increasing_id(
        "rid").where(p.col("x") > 2).to_pydict())["rid"] == [2, 3]


def test_join_asof():
    def run(p):
        trades = p.from_pydict({"t": [3, 7, 12, 20], "sym": ["A", "A", "B", "B"],
                                "px": [1.0, 2.0, 3.0, 4.0]})
        quotes = p.from_pydict({"t": [1, 5, 10, 15], "sym": ["A", "A", "B", "B"],
                                "bid": [0.9, 1.9, 2.9, 3.9]})
        return (trades.join_asof(quotes, on="t", by="sym").sort("t").to_pydict()["bid"],
                trades.join_asof(quotes, on="t", by="sym", direction="forward").sort("t")
                .to_pydict()["bid"],
                trades.join_asof(quotes, on="t").sort("t").to_pydict()["bid"])

    assert _both(run) == ([0.9, 1.9, 2.9, 3.9], [1.9, None, 3.9, None], [0.9, 1.9, 2.9, 3.9])


def test_join_outer_right_merged_key_coalesced():
    def run(p):
        left = p.from_pydict({"id": [1, 2], "l": ["a", "b"]})
        right = p.from_pydict({"id": [2, 3], "r": ["B", "C"]})
        l2 = p.from_pydict({"k1": [1, 1], "k2": ["x", "y"], "l": [10, 11]})
        r2 = p.from_pydict({"k1": [1, 2], "k2": ["y", "z"], "r": [20, 21]})
        return (left.join(right, on="id", how="outer").sort("id").to_pydict(),
                left.join(right, on="id", how="right").sort("id").to_pydict(),
                l2.join(r2, on=["k1", "k2"], how="outer").sort(["k1", "k2"]).to_pydict())

    out, rout, o2 = _both(run)
    assert out == {"id": [1, 2, 3], "l": ["a", "b", None], "r": [None, "B", "C"]}
    assert rout == {"id": [2, 3], "l": ["b", None], "r": ["B", "C"]}
    assert o2 == {"k1": [1, 1, 2], "k2": ["x", "y", "z"], "l": [10, 11, None],
                  "r": [None, 20, 21]}


def test_join_asof_null_keys_never_match():
    def run(p):
        left = p.from_pydict({"t": [None, 1.0, 5.0], "l": ["n", "a", "b"]})
        right = p.from_pydict({"t": [None, 2.0], "r": ["rn", "r2"]})
        return (left.join_asof(right, on="t", direction="forward").to_pydict()["r"],
                left.join_asof(right, on="t", direction="backward").to_pydict()["r"])

    assert _both(run) == ([None, "r2", None], [None, None, "r2"])


def test_udaf_function_and_class():
    def run(p):
        @p.udf.udaf(p.DataType.float64())
        def geo_mean(values):
            import math

            return math.exp(sum(math.log(v) for v in values) / len(values)) if values else None

        @p.udf.udaf(p.DataType.int64())
        class RangeWidth:
            def __init__(self):
                self.vals = []

            def accumulate(self, values):
                self.vals.extend(values)

            def finalize(self):
                return int(max(self.vals) - min(self.vals)) if self.vals else None

        df = p.from_pydict({"g": ["a", "a", "b"], "x": [1.0, 4.0, 9.0]})
        return (df.agg(geo_mean(p.col("x")).alias("gm")).to_pydict()["gm"][0],
                df.groupby("g").agg(geo_mean(p.col("x")).alias("gm")).sort("g").to_pydict(),
                p.from_pydict({"x": [3, 9, 1]}).agg(RangeWidth(p.col("x")).alias("w"))
                .to_pydict()["w"])

    gm, grouped, width = _both(run)
    assert gm == pytest.approx((1.0 * 4.0 * 9.0) ** (1 / 3))
    assert grouped["gm"] == [pytest.approx(2.0), pytest.approx(9.0)] and width == [8]


def test_udaf_incremental_partials(monkeypatch):
    """Class UDAFs with merge() run incrementally through the two-phase
    planner: accumulate per chunk, merge states, finalize once, counted by
    merges (>= 1: no collect-all). The JAX test's distributed runner is A.8:
    here aggregation chunks of 500 rows in both packages give the partials,
    at one worker and at four."""
    from daft_tpu.execution.executor import Executor as JExecutor
    from daft_tpu_torch.execution.executor import Executor as PExecutor

    for executor in (JExecutor, PExecutor):
        monkeypatch.setattr(executor, "AGG_CHUNK_ROWS", 500)

    def run(p, threads):
        @p.udf.udaf(p.DataType.struct({"mean": p.DataType.float64(),
                                       "merges": p.DataType.int64()}))
        class RunningMean:
            def __init__(self):
                self.n = 0
                self.total = 0.0
                self.merges = 0

            def accumulate(self, values):
                self.n += len(values)
                self.total += sum(values)

            def merge(self, other):
                self.n += other.n
                self.total += other.total
                self.merges += other.merges + 1

            def finalize(self):
                return {"mean": self.total / self.n if self.n else None,
                        "merges": self.merges}

        df = p.from_pydict({"g": [i % 3 for i in range(3000)],
                            "v": [float(i) for i in range(3000)]})
        with p.execution_config_ctx(num_compute_threads=threads, default_morsel_size=250):
            return (df.into_partitions(6).groupby("g").agg(RunningMean(p.col("v")).alias("r"))
                    .sort("g").to_pydict(),
                    df.agg(RunningMean(p.col("v")).alias("r")).to_pydict())

    for threads in (1, 4):
        out, whole = _both(lambda p: run(p, threads))
        for g, r in zip(out["g"], out["r"]):
            np.testing.assert_allclose(r["mean"], np.mean([float(i) for i in range(3000)
                                                           if i % 3 == g]))
            assert r["merges"] >= 1, "partial path not taken"
        assert whole["r"][0]["mean"] == 1499.5 and whole["r"][0]["merges"] >= 1


def test_approx_percentile_ddsketch_error_bound():
    """The DDSketch answers within 1.5 % of the true quantiles, over one
    partition and over five (the JAX test's distributed runner is A.8)."""
    data = np.random.default_rng(1).lognormal(0.0, 2.0, 100_000)
    qs = [0.1, 0.5, 0.99]

    def run(p):
        df = p.from_pydict({"v": data})
        agg = p.col("v").approx_percentiles(qs).alias("p")
        return (df.agg(agg).to_pydict()["p"][0],
                df.into_partitions(5).agg(agg).to_pydict()["p"][0])

    whole, parts = _both(run)
    for q, nv, dv in zip(qs, whole, parts):
        true = np.quantile(data, q)
        assert abs(nv - true) / true <= 0.015 and abs(dv - true) / true <= 0.015


# -- the constructors -----------------------------------------------------------
def test_from_pylist_takes_the_first_rows_keys():
    rows = [{"a": 1, "b": "x"}, {"b": "y", "a": 2}, {"a": 3}]
    out = _both(lambda p: (p.from_pylist(rows).to_pydict(), repr(p.from_pylist(rows).schema)))
    assert out[0] == {"a": [1, 2, 3], "b": ["x", "y", None]}


def test_from_pylist_of_no_rows_raises_as_in_the_jax_package():
    errors = []
    for p in PKGS:
        with pytest.raises(Exception) as e:
            p.from_pylist([])
        errors.append((type(e.value).__name__, str(e.value)))
    assert errors[1] == errors[0] == ("DaftValueError", "from_pylist requires at least one row")


def test_from_arrow_tables_batches_and_lists():
    table = pa.table({"x": pa.array([1, None, 3], pa.int32()), "s": ["a", "b", None],
                      "l": pa.array([[1.5], [], None], pa.list_(pa.float64()))})
    inputs = [table, table.to_batches()[0], [table, table.slice(1)]]

    def run(p):
        return [(p.from_arrow(t).to_pydict(), repr(p.from_arrow(t).schema),
                 p.from_arrow(t).num_partitions()) for t in inputs]

    out = _both(run)
    assert out[2][2] == 2 and out[0][0]["x"] == [1, None, 3]
    for t in inputs:
        # The engine's Arrow types are its own (large strings and lists), as
        # the JAX package's; a table it gave round-trips unchanged.
        back, jax_back = (p.from_arrow(t).to_arrow() for p in (daft_tpu_torch, daft_tpu))
        assert back.equals(jax_back)
        assert daft_tpu_torch.from_arrow(back).to_arrow().equals(back)


def test_from_pandas_one_and_many():
    pdf = pd.DataFrame({"x": [1.0, np.nan, 3.0], "s": ["a", None, "c"], "i": [1, 2, 3]},
                       index=[7, 8, 9])
    out = _both(lambda p: [(p.from_pandas(d).to_pydict(), repr(p.from_pandas(d).schema),
                            p.from_pandas(d).num_partitions()) for d in (pdf, [pdf, pdf])])
    assert out[1][2] == 2 and out[0][0]["i"] == [1, 2, 3]


@pytest.mark.parametrize("args, kwargs", [((10,), {}), ((2, 20, 3), {}), ((5,), {"partitions": 3}),
                                          ((0,), {}), ((10, 0, -2), {"partitions": 2})])
def test_range(args, kwargs):
    out = _both(lambda p: (p.range(*args, **kwargs).to_pydict(),
                           p.range(*args, **kwargs).num_partitions(),
                           repr(p.range(*args, **kwargs).schema)))
    start, end, step = (0, args[0], 1) if len(args) == 1 else args
    assert out[0]["id"] == list(range(start, end, step))
    assert out[1] == kwargs.get("partitions", 1)


# -- introspection and the preview ---------------------------------------------
def test_columns_contains_and_getitem():
    def run(p):
        df = _df(p)
        errors = []
        for key in ("zz", 1.5):
            with pytest.raises(Exception) as e:
                df[key]
            errors.append((type(e.value).__name__, str(e.value)))
        return ([repr(c) for c in df.columns], "a" in df, "zz" in df, repr(df["b"]),
                repr(df[2]), df.select(df["a"] + df[2]).to_pydict(), errors)

    out = _both(run)
    assert out[1:3] == (True, False) and out[4] == "col(c)"


@pytest.mark.parametrize("show_all", [False, True])
def test_explain_prints_the_jax_packages_plan(capsys, show_all):
    def run(p):
        _df(p).where(p.col("a") > 2).groupby("b").agg(p.col("c").sum()).explain(show_all)
        return capsys.readouterr().out

    text = _both(run)
    assert "Aggregate" in text or "Agg" in text


def test_explain_analyze_and_collect_profile_raise_naming_their_item(tmp_path):
    df = _df(daft_tpu_torch)
    with pytest.raises(DaftNotImplementedError, match=r"A\.9\.5"):
        df.explain(analyze=True)
    with pytest.raises(DaftNotImplementedError, match=r"A\.9\.5"):
        df.collect(profile=str(tmp_path / "trace.json"))
    assert df.collect(timeout=30.0).to_pydict() == _df(daft_tpu).to_pydict()


def test_repr_before_and_after_collect():
    out = _both(lambda p: (repr(_df(p)), repr(_df(p).collect())))
    assert "unmaterialized" in out[0] and "Int64" in out[1]


def test_preview_rows_follow_the_config():
    def run(p):
        df = p.from_pydict(_seeded(3, 30)).collect()
        with p.execution_config_ctx(num_preview_rows=3):
            short = repr(df)
        return short, repr(df)

    short, default = _both(run)
    assert len(short.splitlines()) < len(default.splitlines())


@pytest.mark.parametrize("rows", [0, 5, 8, 9, 40])
def test_repr_html_equals_the_jax_packages(rows):
    data = {"n": list(range(rows)), "long": ["<" + "w" * 100 + ">"] * rows,
            "s": [None if k % 3 else "a&b" for k in range(rows)]}
    html = _both(lambda p: p.from_pydict(data)._repr_html_())
    assert html.startswith("<h3>DataFrame</h3>") and ("more rows" in html) == (rows > 8)


@pytest.mark.parametrize("n", [3, 8, 50])
def test_show_prints_the_jax_packages_table(capsys, n):
    def run(p):
        p.from_pydict(_seeded(1, 20)).show(n)
        return capsys.readouterr().out

    assert _both(run)


# -- transformations and counts -------------------------------------------------
def test_describe_and_summarize():
    data = _seeded(2)
    out = _both(lambda p: (p.from_pydict(data).describe().to_pydict(),
                           p.from_pydict(data).summarize().to_pydict()))
    assert out[0]["column"] == ["i", "f", "s", "b"] and out[1]["count_nulls"][0] == 16


def test_summarize_on_the_device_route_equals_the_host_route():
    """The port's ``summarize`` through the device layer's route (on the
    CPU device here) and with it off: the same rows."""
    data = _seeded(4, 3000)
    with daft_tpu_torch.execution_config_ctx(device_eval_min_rows=1):
        card = daft_tpu_torch.from_pydict(data).summarize().to_pydict()
    with daft_tpu_torch.execution_config_ctx(device_eval=False, compiled_eval_enabled=False):
        host = daft_tpu_torch.from_pydict(data).summarize().to_pydict()
    assert card == host == daft_tpu.from_pydict(data).summarize().to_pydict()


@pytest.mark.parametrize("kind", ["int", "str", "bool", "date", "float", "float_finite"])
def test_distinct_counts_of_lists_equal_the_jax_package(kind):
    """``summarize``'s distinct counts go through ``list_count_distinct``
    (the global and grouped ``count_distinct`` / ``approx_count_distinct``
    finalizer): the port counts an integer, string, bool, date or float
    list's values by their dictionary codes, and a float list holding NaN
    or -0.0 by the JAX package's set per row (NaN and -0.0 as a set holds
    them); both give the JAX package's counts, nulls and empty lists
    included."""
    import datetime

    rng = np.random.default_rng(11)
    pool = {"int": [int(x) for x in rng.integers(-5, 5, 8)], "str": ["a", "b", "", "ümlaut"],
            "bool": [True, False], "date": [datetime.date(2020, 1, d) for d in (1, 2, 3)],
            "float": [0.0, -0.0, float("nan"), 1.5, float("nan")],
            "float_finite": [0.0, 1.5, -2.25, 1e300, float("inf")]}[kind]
    lists = [None if k % 7 == 3 else [None if rng.random() < 0.1 else pool[j] for j in
                                      rng.integers(0, len(pool), rng.integers(0, 9))]
             for k in range(60)]
    firsts = [row[0] if row else None for row in lists]
    out = _both(lambda p: (
        p.from_pydict({"l": lists}).select(p.col("l").list.count_distinct().alias("n")).to_pydict(),
        p.from_pydict({"g": [k % 4 for k in range(60)], "v": firsts})
        .groupby("g").agg(p.col("v").count_distinct().alias("d")).sort("g").to_pydict()))
    assert len(out[0]["n"]) == 60


@pytest.mark.parametrize("batch_size", [1, 7, 64, 1000])
def test_into_batches(batch_size):
    out = _both(lambda p: (lambda b: (b.num_partitions(), b.to_pydict()))(
        p.from_pydict(_seeded(5, 100)).into_batches(batch_size)))
    assert out[0] == max(1, -(-100 // batch_size))


def test_into_batches_rejects_a_non_positive_size():
    errors = []
    for p in PKGS:
        with pytest.raises(Exception) as e:
            _df(p).into_batches(0)
        errors.append((type(e.value).__name__, str(e.value)))
    assert errors[1] == errors[0]


def test_transform():
    out = _both(lambda p: _df(p).transform(lambda d, k: d.where(p.col("a") >= k), 7).to_pydict())
    assert out["a"] == [7, 8, 9]
    errors = []
    for p in PKGS:
        with pytest.raises(Exception) as e:
            _df(p).transform(lambda d: 1)
        errors.append((type(e.value).__name__, str(e.value)))
    assert errors[1] == errors[0]


def test_len_count_and_num_partitions():
    out = _both(lambda p: (len(_df(p)), _df(p).count().to_pydict(), _df(p).count("b").to_pydict(),
                           _df(p).num_partitions(), _df(p).into_partitions(3).num_partitions(),
                           len(p.from_pydict({"a": []}))))
    assert out[0] == 10 and out[1] == {"count": [10]} and out[4] == 3 and out[5] == 0


def test_where_takes_a_sql_predicate():
    assert _both(lambda p: _df(p).where("a > 6 AND b = 'y'").to_pydict())["a"] == [7, 9]


def test_agg_takes_lists_of_expressions():
    out = _both(lambda p: _df(p).agg([p.col("a").sum(), p.col("c").max()]).to_pydict())
    assert out == {"a": [45], "c": [9.0]}


@pytest.mark.parametrize("fmt", ["parquet", "csv"])
def test_skip_existing(tmp_path, fmt):
    def run(p):
        root = tmp_path / p.__name__
        existing = p.from_pydict({"a": [1, 3, 5], "b": ["x", "y", "x"]})
        getattr(existing, f"write_{fmt}")(str(root))
        df = _df(p)
        return (df.skip_existing(str(root), on="a", file_format=fmt).sort("a").to_pydict(),
                df.skip_existing(str(root), on=["a", "b"], file_format=fmt).sort("a").to_pydict(),
                df.skip_existing(str(tmp_path / "missing"), on="a").count_rows())

    one, two, missing = _both(run)
    assert 1 not in one["a"] and 3 not in one["a"] and len(one["a"]) == 7
    assert two["a"] == [0, 1, 2, 4, 5, 6, 7, 8, 9] and missing == 10  # (3, "y") exists


# -- the exporters ---------------------------------------------------------------
def test_iter_rows_to_pylist_over_partitions():
    data = _seeded(6, 90)
    out = _both(lambda p: (list(p.from_pydict(data).into_partitions(4).iter_rows()),
                           p.from_pydict(data).to_pylist()))
    assert out[0][5] == {k: v[5] for k, v in data.items()} and len(out[1]) == 90


def test_to_arrow_and_to_arrow_iter():
    data = _seeded(7, 120)
    tables = [(p.from_pydict(data).to_arrow(),
               list(p.from_pydict(data).into_partitions(3).to_arrow_iter())) for p in PKGS]
    (jt, jb), (t, b) = tables
    assert t.equals(jt) and len(b) == len(jb) == 3
    assert all(x.equals(y) for x, y in zip(b, jb))
    empty = [p.from_pydict(data).where(p.col("i") > 10**6).to_arrow() for p in PKGS]
    assert empty[1].equals(empty[0]) and empty[1].num_rows == 0


def test_to_pandas():
    data = _seeded(8, 120)
    frames = [p.from_pydict(data).to_pandas() for p in PKGS]
    pd.testing.assert_frame_equal(frames[1], frames[0])
    empty = [p.from_pydict(data).where(p.col("i") > 10**6).to_pandas() for p in PKGS]
    pd.testing.assert_frame_equal(empty[1], empty[0])


def _batches_equal(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_batches_equal(a[k], b[k]) for k in a)
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    return a == b


def test_torch_datasets_yield_the_jax_packages_rows():
    data = {k: v for k, v in _seeded(9, 50).items() if k != "s"}
    data["s"] = [str(x) for x in range(50)]
    out = [(list(p.from_pydict(data).to_torch_iter_dataset()),
            (lambda ds: (len(ds), [ds[i] for i in range(len(ds))]))(
                p.from_pydict(data).to_torch_map_dataset())) for p in PKGS]
    assert out[1] == out[0]
    assert out[1][0] == out[1][1][1] and out[1][1][0] == 50


@pytest.mark.parametrize("kwargs", [{"batch_size": 4}, {"batch_size": 16, "drop_last": True},
                                    {"batch_size": 8, "shuffle": False, "num_workers": 0}])
def test_torch_dataloader_gives_the_jax_packages_batches(kwargs):
    rng = np.random.default_rng(10)
    data = {"x": rng.standard_normal(70).astype(np.float32), "k": rng.integers(0, 9, 70),
            "s": [f"r{i}" for i in range(70)]}
    loaders = [p.from_pydict(data).to_torch_dataloader(**kwargs) for p in PKGS]
    assert loaders[1].batch_size == kwargs["batch_size"]
    assert loaders[1].drop_last == kwargs.get("drop_last", False)
    jax, port = (list(loader) for loader in loaders)
    assert len(port) == len(jax) and all(_batches_equal(a, b) for a, b in zip(jax, port))
    first = port[0]
    assert first["x"].dtype == torch.float64 and torch.equal(
        first["x"], torch.tensor(data["x"][:kwargs["batch_size"]].astype(np.float64)))


def test_torch_dataloader_passes_pin_memory_through():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # no accelerator to pin for here
        loader = daft_tpu_torch.range(10).to_torch_dataloader(batch_size=5, pin_memory=True)
        assert loader.pin_memory is True
        assert [b["id"].tolist() for b in loader] == [[0, 1, 2, 3, 4], [5, 6, 7, 8, 9]]


def test_dask_and_ray_exporters_raise_as_in_the_jax_package():
    for method in ("to_dask_dataframe", "to_ray_dataset"):
        errors = []
        for p in PKGS:
            with pytest.raises(Exception) as e:
                getattr(_df(p), method)()
            errors.append((type(e.value).__name__, str(e.value)))
        assert errors[1] == errors[0] and errors[1][0] == "DaftIOError"


@pytest.mark.parametrize("method, item", [("shard", "A.8"), ("with_checkpoint", "A.2"),
                                          ("metrics", "A.9.5"), ("write_iceberg", "A.8"),
                                          ("write_deltalake", "A.8"), ("write_sql", "A.8")])
def test_left_out_methods_raise_naming_their_item(method, item):
    with pytest.raises(DaftNotImplementedError, match=item.replace(".", r"\.")):
        getattr(_df(daft_tpu_torch), method)("x")


# -- config, expressions and the top level --------------------------------------
def test_set_and_scoped_configs_as_in_the_jax_package():
    def run(p):
        ctx = p.get_context()
        seen = []
        with p.execution_config_ctx(), p.planning_config_ctx():
            p.set_execution_config(num_preview_rows=5, default_morsel_size=1024)
            p.set_planning_config(default_io_config="cfg")
            seen.append((ctx.execution_config.num_preview_rows,
                         ctx.execution_config.default_morsel_size,
                         ctx.planning_config.default_io_config))
            with p.planning_config_ctx(default_io_config=None):
                seen.append(ctx.planning_config.default_io_config)
            seen.append(ctx.planning_config.default_io_config)
            p.set_execution_config(ctx.execution_config.with_changes(num_preview_rows=2))
            seen.append(ctx.execution_config.num_preview_rows)
        seen.append((ctx.execution_config.num_preview_rows, ctx.planning_config.default_io_config))
        return seen

    assert _both(run) == [(5, 1024, "cfg"), None, "cfg", 2, (8, None)]


def test_expr_is_literal():
    out = _both(lambda p: [e._expr.is_literal() for e in (p.lit(3), p.col("a"), p.lit(1) + 2)]
                + [e.is_literal() for e in (p.lit(3), p.col("a"))])
    assert out == [True, False, False, True, False]


LAZY_NAMES = ["File", "functions", "udf", "cancel_query", "from_pylist", "from_arrow",
              "from_pandas", "range", "set_execution_config", "set_planning_config",
              "planning_config_ctx", "Window", "DataSource", "DataSink", "IOConfig",
              "S3Config", "read_parquet", "DaftCancelledError", "DaftTimeoutError", "sql",
              "func", "cls", "method", "read_mcap", "read_video_frames", "from_files",
              "read_kafka", "read_paimon"]


@pytest.mark.parametrize("name", LAZY_NAMES)
def test_top_level_names_resolve(name):
    assert hasattr(daft_tpu_torch, name) and hasattr(daft_tpu, name)
    obj = getattr(daft_tpu_torch, name)
    assert getattr(obj, "__module__", getattr(obj, "__name__", "")).startswith("daft_tpu_torch")


def test_every_top_level_name_of_the_jax_package_resolves_or_names_its_item():
    """Each name in the JAX package's ``__all__`` and its lazy table either
    resolves in the port, or raises ``AttributeError`` naming its ROADMAP
    item (so ``hasattr`` is False); every name in the port's ``__all__``
    resolves."""
    import re

    src = open(daft_tpu.__file__).read()
    lazy = set(re.findall(r'"([A-Za-z_]\w*)"', src[src.index("def __getattr__"):]))
    names = (set(daft_tpu.__all__) | lazy) - {"daft_tpu"}
    missing = {}
    for name in sorted(names):
        try:
            getattr(daft_tpu_torch, name)
        except AttributeError as e:
            assert re.search(r"ROADMAP A\.\d", str(e)), (name, str(e))
            assert not hasattr(daft_tpu_torch, name)
            missing[name] = str(e)
    assert {"Session", "Catalog", "read_iceberg", "recent_queries", "set_tenant",
            "register_view"} <= set(missing)
    assert not {"File", "functions", "udf", "from_pylist", "range", "Window", "read_mcap",
                "func"} & set(missing)
    for name in daft_tpu_torch.__all__:
        assert getattr(daft_tpu_torch, name) is not None, name
    with pytest.raises(AttributeError, match="no attribute 'not_a_name'$"):
        daft_tpu_torch.not_a_name
