"""The port's joins and set operations (daft_tpu_torch: execution/join_index.py,
logical Join / AsofJoin / Concat / Intersect / Except, the executor's
HashJoin / CrossJoin / AsofJoin / Concat, tools/tpch.py) against the JAX
package's, on the CPU.

The same numpy-seeded sides go through ``daft_tpu`` and through
``daft_tpu_torch`` with ``device="cpu"``. The join index's route is
probe-major and stable, so its outputs are compared row for row; Acero's
threaded join emits rows in no fixed order, so its outputs (string and float
keys, right and outer joins) are compared as multisets. Values are compared
exactly (NaN equal to NaN): both packages join on the host with the same
numpy and Arrow calls. q03's revenue is held bit for bit against the JAX
package (the same sides, the index route) and within 1e-6 relative of the
f64 reference (f32 products summed in f64, rounded to f32).
"""

import contextlib
import math
import warnings

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pytest

import daft_tpu
import daft_tpu_torch
from daft_tpu.execution.join_index import JoinIndex as JJoinIndex
from daft_tpu.recordbatch import RecordBatch as JRecordBatch
from daft_tpu_torch.execution.join_index import JoinIndex as TJoinIndex
from daft_tpu_torch.execution.join_index import join_counters
from daft_tpu_torch.recordbatch import RecordBatch as TRecordBatch
from daft_tpu_torch.tools import tpch

pytestmark = pytest.mark.filterwarnings("ignore:Specifying null_placement:FutureWarning")

HOWS = ("inner", "left", "right", "outer", "semi", "anti")
KINDS = ("int_dense", "int_sorted", "two_keys", "int32_int64", "string", "float")
#: The probe route each key kind takes for inner / left / semi / anti.
INDEX_ROUTE = {"int_dense": "dense", "int_sorted": "sorted", "two_keys": "dense",
               "int32_int64": "dense", "string": "acero", "float": "acero"}
REVENUE_RTOL = 1e-6


@contextlib.contextmanager
def _configs(**both):
    with daft_tpu.execution_config_ctx(result_cache_enabled=False, **both), \
            daft_tpu_torch.execution_config_ctx(device="cpu", result_cache_enabled=False, **both):
        yield


def _keys(rng, kind: str, n: int, null_p: float, right: bool) -> dict:
    mask = rng.random(n) < null_p
    if kind == "two_keys":
        return {"k": pa.array(rng.integers(0, 5, n).astype(np.int32), mask=mask),
                "k2": pa.array(rng.integers(0, 6, n), pa.int64())}
    base = rng.integers(0, 30, n)
    if kind == "int_dense":
        return {"k": pa.array(base, pa.int64(), mask=mask)}
    if kind == "int_sorted":
        return {"k": pa.array(base * 10**12 - 7, pa.int64(), mask=mask)}
    if kind == "int32_int64":
        return {"k": pa.array(base, pa.int64() if right else pa.int32(), mask=mask)}
    if kind == "string":
        return {"k": pa.array([f"key{v}" for v in base], pa.large_string(), mask=mask)}
    return {"k": pa.array(base * 0.25 - 1.0, pa.float64(), mask=mask)}


def _sides(kind: str, n_left: int = 120, n_right: int = 40, seed: int = 0):
    """Left (the probe) and right (the build) with null keys on both sides,
    duplicate build keys, and payload columns whose names clash (``v``)."""
    rng = np.random.default_rng(seed)
    left = {**_keys(rng, kind, n_left, 0.1, False),
            "v": rng.standard_normal(n_left).astype(np.float32),
            "row": np.arange(n_left, dtype=np.int64)}
    right = {**_keys(rng, kind, n_right, 0.1, True),
             "v": pa.array([f"r{i}" for i in range(n_right)], pa.large_string()),
             "rrow": np.arange(n_right, dtype=np.int64)}
    return left, right


def _on(kind: str) -> list:
    return ["k", "k2"] if kind == "two_keys" else ["k"]


def _norm(v):
    if isinstance(v, float) and math.isnan(v):
        return ("nan",)
    return (0, "") if v is None else (1, repr(v))


def _rows(out: dict) -> list:
    return list(zip(*out.values()))


def _same(a: dict, b: dict, ordered: bool) -> None:
    assert list(a) == list(b)
    ra = [tuple(_norm(v) for v in r) for r in _rows(a)]
    rb = [tuple(_norm(v) for v in r) for r in _rows(b)]
    if not ordered:
        ra, rb = sorted(ra), sorted(rb)
    assert ra == rb


def _run_both(query, ordered: bool):
    """The port's output and its join records, after holding its schema
    and rows against the JAX package's."""
    outs = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        for pkg in (daft_tpu, daft_tpu_torch):
            join_counters.reset()
            df = query(pkg)
            outs.append((df.to_pydict(), [(f.name, repr(f.dtype)) for f in df.schema]))
    (jout, jschema), (tout, tschema) = outs
    assert jschema == tschema
    _same(jout, tout, ordered)
    return tout, join_counters.snapshot()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("how", HOWS)
def test_hash_join_matches_the_jax_package(how, kind):
    left, right = _sides(kind)
    route = INDEX_ROUTE[kind] if how not in ("right", "outer") else "acero"

    def query(pkg):
        return pkg.from_pydict(left).join(pkg.from_pydict(right), on=_on(kind), how=how)

    with _configs():
        out, joins = _run_both(query, ordered=route != "acero")
    assert [list(j["routes"]) for j in joins] == [[route]]
    # FilterNullJoinKey drops the build side's null-keyed rows ahead of the
    # join wherever they can never survive it (as the JAX optimizer does).
    keyed = pa.table(right).drop_null() if how in ("inner", "left", "semi", "anti") \
        else pa.table(right)
    assert joins[0]["build_rows"] == keyed.num_rows
    assert joins[0]["routes"][route]["rows_out"] == len(out["row"])
    if how == "anti":  # null probe keys never match, so an anti join keeps them
        assert any(v is None for v in out["k"])
    if how in ("inner", "semi"):
        assert all(v is not None for v in out["k"])


@pytest.mark.parametrize("how", HOWS)
@pytest.mark.parametrize("empty", ["left", "right", "both"])
def test_join_with_an_empty_side(how, empty):
    left, right = _sides("int_dense")

    def query(pkg):
        lf, rf = pkg.from_pydict(left), pkg.from_pydict(right)
        if empty in ("left", "both"):
            lf = lf.where(pkg.col("row") < 0)
        if empty in ("right", "both"):
            rf = rf.where(pkg.col("rrow") < 0)
        return lf.join(rf, on="k", how=how)

    with _configs():
        _run_both(query, ordered=how not in ("right", "outer"))


@pytest.mark.parametrize("kind", ["int_dense", "string"])
@pytest.mark.parametrize("how", HOWS)
def test_name_clashes_take_prefix_and_suffix(how, kind):
    """Distinct key names (no merge): the right side's clashing ``k`` and
    ``v`` become ``p_`` + ``_r`` + name; on the index route they are
    renamed on the build side before the probe."""
    left, right = _sides(kind)
    right["k_right"] = right["k"]

    def query(pkg):
        return pkg.from_pydict(left).join(pkg.from_pydict(right), left_on="k",
                                          right_on="k_right", how=how, suffix="_r", prefix="p_")

    with _configs():
        out, _ = _run_both(query, ordered=kind != "string" and how not in ("right", "outer"))
    if how not in ("semi", "anti"):
        assert {"p__rk", "p__rv", "k_right"} <= set(out)


@pytest.mark.parametrize("how", ["right", "outer"])
def test_right_outer_coalesce_the_merged_key(how):
    """A right-only row takes its key from the right side (the ``__rk_``
    copy), not null."""
    left, right = _sides("int32_int64")
    right["k"] = pc.add(right["k"], 15)  # keys 15..44 against 0..29

    def query(pkg):
        return pkg.from_pydict(left).join(pkg.from_pydict(right), on="k", how=how)

    with _configs():
        out, _ = _run_both(query, ordered=False)
    left_keys = {k for k in left["k"].to_pylist() if k is not None}
    want = [k for k in right["k"].to_pylist() if k is None or k not in left_keys]
    got = [k for k, r in zip(out["k"], out["row"]) if r is None]
    assert any(k is not None for k in want)
    assert sorted(got, key=_norm) == sorted(want, key=_norm)


def test_aggregate_over_a_join_is_bit_equal():
    """Sums over an index-route join's rows, in the same order in both
    packages, give the same bits."""
    left, right = _sides("int_dense", n_left=3000, n_right=200)

    def query(pkg):
        j = pkg.from_pydict(left).join(pkg.from_pydict(right), on="k")
        return j.groupby("k").agg(pkg.col("v").sum().alias("s"), pkg.col("v").mean().alias("m"),
                                  pkg.col("rrow").count().alias("n")).sort("k")

    with _configs():
        _run_both(query, ordered=True)


def _batches(kind: str, pkg_rb):
    """Probe and build batches; the build side's names take ``b_`` (the
    executor renames clashing names before it probes)."""
    left, right = _sides(kind)
    return pkg_rb.from_pydict(left), pkg_rb.from_pydict({f"b_{k}": v for k, v in right.items()})


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("how", ["inner", "left", "semi", "anti", "right"])
def test_join_index_matches_the_jax_package(how, kind):
    """``try_build`` decides alike and builds the same arrays; ``probe``
    gives the same rows in the same order."""
    built = []
    for rb_cls, idx_cls in ((JRecordBatch, JJoinIndex), (TRecordBatch, TJoinIndex)):
        probe_rb, build_rb = _batches(kind, rb_cls)
        on = _on(kind)
        bkeys = [build_rb.get_column(f"b_{n}") for n in on]
        if kind == "int32_int64":  # the executor casts both sides to the unified dtype first
            pkeys = [probe_rb.get_column("k").cast(bkeys[0].dtype)]
        else:
            pkeys = [probe_rb.get_column(n) for n in on]
        index = idx_cls.try_build(bkeys, how, build_rb)
        joined = None if index is None else index.probe(probe_rb, pkeys, build_rb, how)
        built.append((index, joined))
    (ji, jout), (ti, tout) = built
    assert (ji is None) == (ti is None)
    if ji is None:
        assert how == "right" or INDEX_ROUTE[kind] == "acero"
        return
    assert ("dense" if ti.offsets is not None else "sorted") == INDEX_ROUTE[kind]
    for name in ("offsets", "sorted_keys", "sorted_rows"):
        a, b = getattr(ji, name), getattr(ti, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(a, b)
    assert (ji.key_min, ji.key_max, ji.key_specs) == (ti.key_min, ti.key_max, ti.key_specs)
    _same(jout.to_pydict(), tout.to_pydict(), ordered=True)


@pytest.mark.parametrize("direction", ["backward", "forward"])
@pytest.mark.parametrize("by", [False, True])
def test_asof_join_matches_the_jax_package(direction, by):
    rng = np.random.default_rng(3)
    left = {"t": pa.array(rng.integers(0, 100, 60), pa.int64(), mask=rng.random(60) < 0.1),
            "g": rng.integers(0, 3, 60), "x": np.arange(60, dtype=np.int64)}
    right = {"t": np.sort(rng.integers(0, 100, 25)), "g": rng.integers(0, 3, 25),
             "y": rng.standard_normal(25)}

    def query(pkg):
        return pkg.from_pydict(left).join_asof(pkg.from_pydict(right), on="t",
                                               by="g" if by else None, direction=direction)

    with _configs():
        out, _ = _run_both(query, ordered=True)
    assert "right.t" in out and "right.g" in out


@pytest.mark.parametrize("suffix", ["right.", "_r"])
def test_cross_join_and_concat_match_the_jax_package(suffix):
    left = {"a": [1, 2, None], "s": ["x", None, "z"]}
    right = {"a": [10, 20], "b": [0.5, None]}

    def cross(pkg):
        return pkg.from_pydict(left).cross_join(pkg.from_pydict(right), suffix=suffix)

    def concat(pkg):
        df = pkg.from_pydict(left)
        return df.concat(df.where(pkg.col("a") > 1)).union(df)

    with _configs():
        out, _ = _run_both(cross, ordered=True)
        assert len(out["a"]) == 6 and f"{suffix}a" in out
        out, _ = _run_both(concat, ordered=True)
        assert len(out["a"]) == 7


@pytest.mark.parametrize("op", ["intersect", "except_distinct"])
@pytest.mark.parametrize("cols", [("k",), ("k", "s")])
def test_set_operations_match_the_jax_package(op, cols):
    rng = np.random.default_rng(5)

    def side(n):
        return {"k": pa.array(rng.integers(0, 8, n), pa.int64(), mask=rng.random(n) < 0.1),
                "s": rng.choice(np.array(["a", "b"]), n)}

    a, b = side(40), side(25)

    def query(pkg):
        left, right = pkg.from_pydict(a).select(*cols), pkg.from_pydict(b).select(*cols)
        return getattr(left, op)(right)

    with _configs():
        out, _ = _run_both(query, ordered=False)
    rows = _rows(out)
    assert len(set(rows)) == len(rows)


@pytest.mark.parametrize("op", ["intersect_all", "except_all"])
def test_set_operations_all_raise_in_the_port(op):
    """The ALL form tags rows through a row_number Window (ROADMAP A.3.5
    brought it; it raised naming A.3 before): the JAX package's multiset,
    through its plan, at 1 and 4 workers."""
    rng = np.random.default_rng(31 if op == "intersect_all" else 32)
    left = {"k": rng.integers(0, 6, 300).tolist(), "s": rng.choice(["a", "b"], 300).tolist()}
    right = {"k": rng.integers(0, 6, 200).tolist(), "s": rng.choice(["a", "b"], 200).tolist()}
    outs = []
    for threads in (1, 4):
        with _configs(), daft_tpu_torch.execution_config_ctx(num_compute_threads=threads):
            q = getattr(daft_tpu_torch.from_pydict(left), op)(daft_tpu_torch.from_pydict(right))
            outs.append(sorted(zip(*q.to_pydict().values())))
    with _configs():
        jq = getattr(daft_tpu.from_pydict(left), op)(daft_tpu.from_pydict(right))
        jax = sorted(zip(*jq.to_pydict().values()))
    assert outs[0] == outs[1] == jax and jax
    small = [sorted(getattr(pkg.from_pydict({"k": [1, 1, 2]}), op)(
        pkg.from_pydict({"k": [1]})).to_pydict()["k"]) for pkg in (daft_tpu, daft_tpu_torch)]
    assert small[0] == small[1] == ([1] if op == "intersect_all" else [1, 2])


@pytest.mark.parametrize("case", ["unknown column", "unequal keys", "unknown how", "no keys",
                                  "asof direction", "sort column", "concat schemas"])
def test_plan_errors_match_the_jax_package(case):
    def build(pkg):
        a = pkg.from_pydict({"k": [1, 2], "v": [1.0, 2.0]})
        b = pkg.from_pydict({"k": [1], "w": ["x"]})
        if case == "unknown column":
            return a.join(b, on="nope")
        if case == "unequal keys":
            return a.join(b, left_on=["k", "v"], right_on=["k"])
        if case == "unknown how":
            return a.join(b, on="k", how="sideways")
        if case == "no keys":
            return a.join(b)
        if case == "asof direction":
            return a.join_asof(b, on="k", direction="nearest")
        if case == "sort column":
            return a.sort("nope")
        return a.concat(b)

    errors = []
    for pkg in (daft_tpu, daft_tpu_torch):
        with pytest.raises(Exception) as e:
            build(pkg)
        errors.append(e.value)
    assert type(errors[0]).__name__ == type(errors[1]).__name__
    assert type(errors[1]).__module__ == "daft_tpu_torch.errors"


def _tables(scale: float = 0.004):
    return tpch.tpch_tables(scale, seed=1)


def _frames(pkg, tables, columns) -> dict:
    return {t: pkg.from_pydict({c: tables[t][c] for c in cs}) for t, cs in columns.items()}


def test_tpch_generator_follows_the_specification():
    t = tpch.tpch_tables(0.01, seed=0)
    c, o, li = t["customer"], t["orders"], t["lineitem"]
    assert len(c["c_custkey"]) == 1500 and len(o["o_orderkey"]) == 15000
    assert o["o_orderkey"][:9].tolist() == [1, 2, 3, 4, 5, 6, 7, 32, 33]
    assert o["o_orderkey"][-1] == 60_000  # SF10's 60,000,000 at a thousandth
    assert not (o["o_custkey"] % 3 == 0).any() and o["o_custkey"].max() <= 1500
    assert o["o_orderdate"].max() <= tpch.LAST_ORDER_DAY
    lines = np.unique(li["l_orderkey"], return_counts=True)[1]
    assert lines.min() == 1 and lines.max() == 7
    day = np.repeat(o["o_orderdate"], np.unique(li["l_orderkey"], return_counts=True)[1])
    assert ((li["l_shipdate"] - day >= 1) & (li["l_shipdate"] - day <= 121)).all()
    assert ((li["l_commitdate"] - day >= 30) & (li["l_commitdate"] - day <= 90)).all()
    gap = li["l_receiptdate"] - li["l_shipdate"]
    assert gap.min() >= 1 and gap.max() <= 30
    assert all(v.dtype == np.int32 for k, v in {**o, **li}.items()
               if k.endswith(("key", "date", "priority")) and isinstance(v, np.ndarray))
    assert set(c["c_mktsegment"].to_pylist()) == set(tpch.SEGMENTS)


def test_q03_matches_the_jax_package_and_the_reference():
    tables = _tables()
    ref = tpch.q03_reference(tables)
    outs = []
    with _configs(device_eval_min_rows=1):
        for pkg in (daft_tpu, daft_tpu_torch):
            f = _frames(pkg, tables, tpch.Q03_COLUMNS)
            join_counters.reset()
            outs.append(tpch.q03(pkg, f["customer"], f["orders"], f["lineitem"]).to_pydict())
    jax_out, out = outs
    assert out == jax_out  # the same sides and routes: the same bits
    problems, notes = tpch.q03_compare(out, ref, REVENUE_RTOL)
    assert not problems and not notes
    joins = join_counters.snapshot()
    assert [(j["on"], list(j["routes"])) for j in joins] == [(["o_custkey"], ["dense"]),
                                                             (["l_orderkey"], ["dense"])]


def test_q04_matches_the_jax_package_and_the_reference():
    tables = _tables()
    outs = []
    with _configs():
        for pkg in (daft_tpu, daft_tpu_torch):
            f = _frames(pkg, tables, tpch.Q04_COLUMNS)
            outs.append(tpch.q04(pkg, f["orders"], f["lineitem"]).to_pydict())
    assert outs[0] == outs[1] == tpch.q04_reference(tables)
    assert outs[1]["o_orderpriority"] == list(tpch.PRIORITIES)


def test_q03_compare_accepts_near_ties_only():
    """Adjacent revenues within the tolerance may come in either order;
    anything else is a problem."""
    ref = {"l_orderkey": np.arange(1, 13), "revenue": np.array(
        [100.0, 90.0, 90.00001, 80.0, 70, 60, 50, 40, 30, 20, 10, 5])[
            [0, 2, 1, 3, 4, 5, 6, 7, 8, 9, 10, 11]],
        "o_orderdate": np.zeros(12, np.int32), "o_shippriority": np.zeros(12, np.int32)}
    ref["l_orderkey"] = ref["l_orderkey"][[0, 2, 1, 3, 4, 5, 6, 7, 8, 9, 10, 11]]

    def out(keys):
        i = [list(ref["l_orderkey"]).index(k) for k in keys]
        return {"l_orderkey": keys, "revenue": [float(ref["revenue"][j]) for j in i],
                "o_orderdate": [0] * len(keys), "o_shippriority": [0] * len(keys)}

    exact = [int(k) for k in ref["l_orderkey"][:10]]
    assert tpch.q03_compare(out(exact), ref, 1e-6) == ([], [])
    swapped = [exact[0], exact[2], exact[1]] + exact[3:]
    problems, notes = tpch.q03_compare(out(swapped), ref, 1e-6)
    assert not problems and len(notes) == 1
    problems, _ = tpch.q03_compare(out([exact[1], exact[0]] + exact[2:]), ref, 1e-6)
    assert problems
    problems, _ = tpch.q03_compare(out(exact[:9] + [12]), ref, 1e-6)
    assert problems
