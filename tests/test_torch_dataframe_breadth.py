"""The DataFrame's long tail in the port (``union_all`` and the ``*_by_name``
unions, ``intersect_all`` / ``except_all``, the aggregation shorthands,
``map_groups``, ``drop_nan`` / ``drop_null``, ``pipe``, ``shuffle``, the flat
list aliases) against the JAX package, on the CPU.

Mirrors ``tests/test_dataframe_breadth.py`` case for case where the port has
the surface: each case runs the same data through both packages
(``device="cpu"`` for the port) and must give the JAX package's rows and the
value that the JAX test asserts; floats of the variance, product and skew
bit for bit. A UDF is the port's ``Udf`` where the JAX test uses
``func.batch`` (the decorators are ROADMAP A.2). Left with the JAX package:
the exporters (``to_arrow_iter``, ``to_torch_*``), the SQL, Iceberg and
``skip_existing`` writers and readers, ``metrics`` and
``set_storage_option`` (A.8).
"""

import math
import warnings

import numpy as np
import pytest

import daft_tpu
import daft_tpu_torch
from daft_tpu.udf import func
from daft_tpu_torch.udf import Udf

PKGS = (daft_tpu, daft_tpu_torch)


@pytest.fixture(autouse=True)
def _cpu():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        with daft_tpu.execution_config_ctx(result_cache_enabled=False), \
                daft_tpu_torch.execution_config_ctx(device="cpu"):
            yield


def _both(build) -> dict:
    """``build(pkg)``'s rows in the port, held equal to the JAX package's."""
    jax, port = (build(pkg) for pkg in PKGS)
    assert port == jax
    return port


def test_union_all_and_by_name():
    def frames(p):
        return (p.from_pydict({"x": [1, 2], "y": ["a", "b"]}),
                p.from_pydict({"y": ["b", "c"], "x": [2, 3]}))

    assert _both(lambda p: frames(p)[0].union_all(frames(p)[0]).to_pydict())["x"] == [1, 2, 1, 2]
    assert _both(lambda p: frames(p)[0].union_all_by_name(frames(p)[1]).sort("x").to_pydict()) \
        == {"x": [1, 2, 2, 3], "y": ["a", "b", "b", "c"]}
    assert _both(lambda p: frames(p)[0].union_by_name(frames(p)[1]).sort("x").to_pydict()) \
        == {"x": [1, 2, 3], "y": ["a", "b", "c"]}


def test_union_by_name_missing_columns_null():
    out = _both(lambda p: p.from_pydict({"x": [1]}).union_all_by_name(
        p.from_pydict({"x": [2], "z": [9]})).sort("x").to_pydict())
    assert out == {"x": [1, 2], "z": [None, 9]}


def test_except_all_multiset():
    out = _both(lambda p: sorted(p.from_pydict({"x": [1, 1, 2, 3]}).except_all(
        p.from_pydict({"x": [1, 3]})).to_pydict()["x"]))
    assert out == [1, 2]


def test_agg_wrappers():
    def run(p):
        df = p.from_pydict({"x": [1.0, 2.0, 3.0, 2.0]})
        return {"var": df.var("x").to_pydict()["x"][0],
                "product": df.product("x").to_pydict()["x"][0],
                "count_distinct": df.count_distinct("x").to_pydict()["x"][0],
                "skew": df.skew("x").to_pydict()["x"][0],
                "string_agg": p.from_pydict({"t": ["b", "a"]}).string_agg(
                    "t", sep="|").to_pydict()["t"][0],
                "agg_set": sorted(df.agg_set("x").to_pydict()["x"][0]),
                "list_agg": df.list_agg("x").to_pydict()["x"][0]}

    out = _both(run)
    assert out["var"] == pytest.approx(0.5) and out["product"] == pytest.approx(12.0)
    assert out["count_distinct"] == 3 and math.isfinite(out["skew"])
    assert out["string_agg"] == "b|a"
    assert out["agg_set"] == [1.0, 2.0, 3.0] and out["list_agg"] == [1.0, 2.0, 3.0, 2.0]


def test_drop_nan_and_null():
    def run(p):
        df = p.from_pydict({"x": [1.0, float("nan"), None, 4.0], "y": [1, 2, 3, None]})
        return (df.drop_nan("x").to_pydict()["y"], df.drop_null("y").select("y").to_pydict()["y"],
                df.drop_null().select("y").to_pydict()["y"])

    out = _both(run)
    assert out == ([1, 3, None], [1, 2, 3], [1, 2])  # NaN is not null


def test_pipe_and_shuffle():
    def run(p):
        df = p.from_pydict({"x": list(range(20))})
        return (df.pipe(lambda d, k: d.limit(k), 3).to_pydict()["x"],
                sorted(df.shuffle(seed=7).to_pydict()["x"]),
                df.shuffle(seed=7).column_names)

    limited, shuffled, names = _both(run)
    assert len(limited) == 3 and shuffled == list(range(20)) and names == ["x"]
    df = daft_tpu_torch.from_pydict({"x": list(range(20))})
    assert df.shuffle(seed=7).to_pydict() == df.shuffle(seed=7).to_pydict()  # seeded


def _udf(pkg, fn, dtype):
    """``fn`` as a batch UDF of ``pkg`` returning ``dtype``."""
    if pkg is daft_tpu:
        return func.batch(return_dtype=dtype(daft_tpu.DataType))(fn)
    return Udf(fn, dtype(daft_tpu_torch.DataType), batch=True)


def _demeaned(v):
    arr = v.to_numpy().astype(float)
    return arr - arr.mean()


def test_map_groups_grouped():
    def run(p):
        df = p.from_pydict({"g": ["a", "a", "b"], "v": [1, 2, 10]})
        demeaned = _udf(p, _demeaned, lambda D: D.float64())
        out = (df.groupby("g").map_groups(demeaned(p.col("v")).alias("demeaned"))
               .sort(["g", "demeaned"]).to_pydict())
        return out, df.groupby("g").map_groups(demeaned(p.col("v"))).column_names

    out, names = _both(run)
    assert out == {"g": ["a", "a", "b"], "demeaned": [-0.5, 0.5, 0.0]}
    assert names == ["g", "v"]  # unaliased: named after its first argument


def test_map_groups_global():
    def run(p):
        top2 = _udf(p, lambda v: sorted(v.to_pylist(), reverse=True)[:2], lambda D: D.int64())
        return p.from_pydict({"v": [5, 1, 9, 3]}).map_groups(
            top2(p.col("v")).alias("top2")).to_pydict()

    assert _both(run) == {"top2": [9, 5]}


def test_intersect_all_multiset():
    def run(p):
        a, b = p.from_pydict({"x": [1, 1, 1, 2]}), p.from_pydict({"x": [1, 1, 3]})
        return sorted(a.intersect_all(b).to_pydict()["x"]), sorted(a.intersect(b).to_pydict()["x"])

    assert _both(run) == ([1, 1], [1])


def test_drop_nan_noargs():
    assert _both(lambda p: p.from_pydict({"x": [1.0, float("nan")], "s": ["a", "b"]})
                 .drop_nan().to_pydict()["s"]) == ["a"]


def test_map_groups_empty_group_dropped():
    def run(p):
        over9 = _udf(p, lambda v: [x for x in v.to_pylist() if x > 9], lambda D: D.int64())
        df = p.from_pydict({"g": ["a", "a", "b"], "v": [1, 2, 10]})
        return df.groupby("g").map_groups(over9(p.col("v"))).to_pydict()

    assert _both(run) == {"g": ["b"], "v": [10]}


def test_flat_delegates_evaluate():
    import datetime

    def run(p):
        df = p.from_pydict({
            "s": ["Hello World", "tpu"],
            "d": [datetime.date(2024, 3, 1), datetime.date(2023, 12, 31)],
            "l": [[1, 2, 3], [4, 5]],
        })
        return df.select(
            p.col("s").upper().alias("u"), p.col("s").contains("World").alias("c"),
            p.col("d").year().alias("y"), p.col("d").day_of_week().alias("dw"),
            p.col("l").list_sum().alias("ls"), p.col("l").get(0).alias("g0"),
        ).to_pydict()

    out = _both(run)
    assert out["u"] == ["HELLO WORLD", "TPU"] and out["c"] == [True, False]
    assert out["y"] == [2024, 2023] and out["ls"] == [6, 9] and out["g0"] == [1, 4]
    c = daft_tpu_torch.col("x")
    assert c.column_name == "x" and c.is_column() and not c.is_literal()


@pytest.mark.parametrize("seed", [0, 1])
def test_sample_explode_unpivot_pivot(seed):
    """The operators of ROADMAP A.3.5 over seeded data: ``sample`` by
    fraction and by size (seeded), ``explode``, ``unpivot`` / ``melt`` and
    ``pivot``, each with the JAX package's rows in its order."""
    rng = np.random.default_rng(seed)
    n = 200
    data = {"k": rng.integers(0, 7, n).tolist(), "v": rng.standard_normal(n).tolist(),
            "w": rng.integers(-50, 50, n).tolist(),
            "l": [None if i % 11 == 0 else rng.integers(0, 9, i % 4).tolist() for i in range(n)],
            "p": rng.choice(["x", "y", "z"], n).tolist()}

    def run(p):
        df = p.from_pydict(data)
        return {"frac": df.sample(0.3, seed=seed).to_pydict(),
                "size": df.sample(size=17, seed=seed).to_pydict(),
                "explode": df.select("k", "l").explode("l").to_pydict(),
                "unpivot": df.select("k", "v", "w").unpivot(["k"], ["v", "w"]).to_pydict(),
                "melt": df.select("k", "w").melt("k").to_pydict(),
                "pivot": df.pivot("k", "p", "v", "sum").sort("k").to_pydict()}

    out = _both(run)
    assert len(out["size"]["k"]) == 17 and 0 < len(out["frac"]["k"]) < n
    assert len(out["explode"]["k"]) >= sum(len(x) for x in data["l"] if x)
    assert sorted(out["pivot"]) == ["k", "x", "y", "z"]


def test_repartition_and_monotonic_id():
    """``repartition`` by hash, at random and ``into_partitions`` keep every
    row; a hash partition holds each key whole; the ids of
    ``monotonically_increasing_id`` count the rows in order."""
    data = {"k": [i % 13 for i in range(300)], "v": list(range(300))}

    def run(p):
        F = __import__(f"{p.__name__}.functions", fromlist=["x"])
        df = p.from_pydict(data)
        parts = [mp.to_pydict() for mp in df.repartition(4, "k").iter_partitions()]
        return {"hash": parts,
                "random": sorted(df.repartition(3).to_pydict()["v"]),
                "into": [len(mp) for mp in df.into_partitions(7).iter_partitions()],
                "ids": df.select(F.monotonically_increasing_id().alias("id"), "v").to_pydict()}

    out = _both(run)
    assert len(out["hash"]) == 4 and sum(len(p["v"]) for p in out["hash"]) == 300
    assert all(not set(a["k"]) & set(b["k"]) for i, a in enumerate(out["hash"])
               for b in out["hash"][i + 1:])
    assert out["random"] == list(range(300)) and out["into"] == [43] * 6 + [42]
    assert out["ids"]["id"] == list(range(300))
