"""The port's compiled relational chains (daft_tpu_torch/ops/compiled_eval.py)
and its Filter/Project/Aggregate operators, against the JAX package's, on the
CPU.

Mirrors tests/test_compiled_eval.py: every test but the A/B-guard,
self-disable, EXPLAIN, dashboard and profiler ones (none is ported), the
thread-count test (the port's stages run on one thread) and the stage-fusion
switch's (the port has no such switch: a chain is always one stage). Each runs the JAX
package and the port (``device="cpu"``) on the same numpy-seeded inputs.
Elementwise outputs and null masks must be equal; f32 sums hold at rtol 1e-5
(the JAX tests' tolerance: another accumulation order); min, max and count
are exact.
"""

import numpy as np
import pytest

import daft_tpu
import daft_tpu_torch
from daft_tpu_torch.ops import device_eval as tde
from daft_tpu_torch.tools import lineitem

SUM_RTOL = 1e-5
F32_ULPS = 2.4e-7  # two f32 roundings, relative


@pytest.fixture(autouse=True)
def _configs():
    with daft_tpu.execution_config_ctx(result_cache_enabled=False), \
            daft_tpu_torch.execution_config_ctx(device="cpu"):
        tde.device_eval_counters.reset()
        yield


def _ctx(pkg, **kw):
    return pkg.execution_config_ctx(**kw)


def _snap():
    return tde.device_eval_counters.snapshot()


def _f32_table(pkg, n=20_000, with_nulls=False, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 100.0, n).astype(np.float32)
    y = rng.uniform(0.0, 1.0, n).astype(np.float32)
    data = {"x": x.tolist(), "y": y.tolist(), "tag": [f"t{i % 7}" for i in range(n)]}
    if with_nulls:
        data["x"] = [None if i % 11 == 0 else v for i, v in enumerate(data["x"])]
    f32 = pkg.DataType.float32()
    return pkg.from_pydict(data).with_columns({"x": pkg.col("x").cast(f32),
                                               "y": pkg.col("y").cast(f32)})


def _chain_query(pkg, df):
    """Filter -> project (arith + string passthrough + literal) -> filter."""
    c = pkg.col
    return (df.where(c("y") < 0.9)
            .select(c("x"), c("y"), c("tag"), (c("x") * 2 + c("y")).alias("v"),
                    pkg.lit(7).alias("k"))
            .where(c("v") > 20.0))


def _q06_query(pkg, df):
    c = pkg.col
    return (df.where((c("y") < 0.8) & (c("x") > 5.0))
            .agg((c("x") * c("y")).sum().alias("rev"), c("x").count().alias("n"),
                 c("x").min().alias("lo"), c("x").max().alias("hi")))


def _host(pkg=daft_tpu_torch):
    return _ctx(pkg, compiled_eval_enabled=False, device_eval=False)


def _assert_agg_equal(got, want):
    assert got.keys() == want.keys()
    for k in got:
        if got[k] == [None] or want[k] == [None] or isinstance(got[k][0], int):
            assert got[k] == want[k], k
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=SUM_RTOL, err_msg=k)


# -- mirrors of tests/test_compiled_eval.py -----------------------------------
def test_chain_parity_vs_interpreted():
    with _ctx(daft_tpu_torch, device_eval_min_rows=1):
        fused = _chain_query(daft_tpu_torch, _f32_table(daft_tpu_torch)).to_pydict()
    assert _snap()["chain_morsels"].get("filter_project", 0) >= 1, \
        "chain did not take the compiled path"
    with _host():
        host = _chain_query(daft_tpu_torch, _f32_table(daft_tpu_torch)).to_pydict()
    with _ctx(daft_tpu, compiled_eval_enabled=True, device_eval_min_rows=1):
        jax = _chain_query(daft_tpu, _f32_table(daft_tpu)).to_pydict()
    for other in (host, jax):
        assert fused["tag"] == other["tag"] and fused["k"] == other["k"]
        # x * 2 + y: x * 2 is exact, so one f32 rounding on every path.
        np.testing.assert_array_equal(np.asarray(fused["v"]), np.asarray(other["v"]))
        np.testing.assert_array_equal(np.asarray(fused["x"]), np.asarray(other["x"]))


def test_chain_parity_with_nulls():
    with _ctx(daft_tpu_torch, device_eval_min_rows=1):
        fused = _chain_query(daft_tpu_torch, _f32_table(daft_tpu_torch, with_nulls=True)).to_pydict()
    with _host():
        host = _chain_query(daft_tpu_torch, _f32_table(daft_tpu_torch, with_nulls=True)).to_pydict()
    with _ctx(daft_tpu, device_eval_min_rows=1):
        jax = _chain_query(daft_tpu, _f32_table(daft_tpu, with_nulls=True)).to_pydict()
    # Null x rows: v is null -> pred null -> row dropped. Same row set and
    # same null layout on every path.
    for other in (host, jax):
        assert fused["tag"] == other["tag"]
        assert [v is None for v in fused["v"]] == [v is None for v in other["v"]]
        np.testing.assert_array_equal(np.asarray([v for v in fused["v"] if v is not None]),
                                      np.asarray([v for v in other["v"] if v is not None]))


def test_agg_chain_compiles_and_matches():
    fused = _q06_query(daft_tpu_torch, _f32_table(daft_tpu_torch, n=50_000)).to_pydict()
    assert _snap()["chain_morsels"].get("filter_project_agg", 0) >= 1, _snap()
    with _host():
        host = _q06_query(daft_tpu_torch, _f32_table(daft_tpu_torch, n=50_000)).to_pydict()
    jax = _q06_query(daft_tpu, _f32_table(daft_tpu, n=50_000)).to_pydict()
    for other in (host, jax):
        _assert_agg_equal(fused, other)


def test_agg_chain_empty_filter_result_is_null_sum():
    def q(pkg):
        c = pkg.col
        return (_f32_table(pkg, n=8_192).where(c("x") > 1e9)
                .agg((c("x") * c("y")).sum().alias("s"), c("x").count().alias("n")))

    fused = q(daft_tpu_torch).to_pydict()
    # PushDownFilter moves the filter below the table's cast projection, as
    # in the JAX package: it runs interpreted on the f64 input and empties
    # the chunk, whose partial then takes the host route.
    snap = _snap()
    assert snap["chain_morsels"] == {}
    assert snap["host_exprs"] == {"agg_below_min_rows": 1}
    assert fused == {"s": [None], "n": [0]} == q(daft_tpu).to_pydict()


def test_agg_chain_empty_filter_result_is_null_sum_on_f32_columns():
    """The filter over columns that are f32 at the source: the whole chain
    and the partial run as one program, and the empty result is a null sum."""
    rng = np.random.default_rng(3)
    data = {"x": rng.uniform(0.0, 100.0, 8_192).astype(np.float32),
            "y": rng.uniform(0.0, 1.0, 8_192).astype(np.float32)}

    def q(pkg):
        c = pkg.col
        return (pkg.from_pydict(data).where(c("x") > 1e9)
                .agg((c("x") * c("y")).sum().alias("s"), c("x").count().alias("n")))

    fused = q(daft_tpu_torch).to_pydict()
    assert _snap()["chain_morsels"] == {"filter_project_agg": 1}
    assert fused == {"s": [None], "n": [0]} == q(daft_tpu).to_pydict()


def test_compile_cache_hit_rate_on_repeated_shapes():
    """The same query shape submitted many times hits the plan-fingerprint
    program cache >= 90%."""
    with _ctx(daft_tpu_torch, device_eval_min_rows=1):
        for _ in range(10):
            _chain_query(daft_tpu_torch, _f32_table(daft_tpu_torch, n=30_000)).to_pydict()
            _q06_query(daft_tpu_torch, _f32_table(daft_tpu_torch, n=30_000)).to_pydict()
    snap = _snap()
    hits, misses = snap["program_hits"], snap["program_misses"]
    assert hits + misses > 0, "no compiled-chain traffic at all"
    assert hits / (hits + misses) >= 0.90, snap


def test_int32_sum_falls_back_dtype_driven():
    """i32 sums promote to i64 on the host — past the device's 32-bit cap,
    so the agg chain refuses (counted), not mis-sums."""
    n = 8_192

    def q(pkg):
        df = pkg.from_pydict({"i": np.arange(n, dtype=np.int32)})
        return df.with_column("i", pkg.col("i").cast(pkg.DataType.int32())).agg(
            pkg.col("i").sum().alias("s"))

    out = q(daft_tpu_torch).to_pydict()
    snap = _snap()
    assert "filter_project_agg" not in snap["chain_morsels"]
    assert snap["host_rows"]["agg_int_sum_promotes"] == n
    assert out == {"s": [int(np.arange(n, dtype=np.int64).sum())]} == q(daft_tpu).to_pydict()


def test_env_knob_disables_chain_path():
    with _ctx(daft_tpu_torch, compiled_eval_enabled=False, device_eval_min_rows=1):
        out = _chain_query(daft_tpu_torch, _f32_table(daft_tpu_torch)).to_pydict()
    snap = _snap()
    assert snap["chain_morsels"] == {}
    assert snap["host_rows"]["chain_compiled_eval_disabled"] > 0
    # The projection's arithmetic still ran on the device (device_eval).
    assert snap["fused_exprs"] >= 1
    assert len(out["v"]) > 0


def test_stage_fusion_counts_and_parity():
    """Adjacent Project/Filter nodes run as one chain (counter moves), and the
    chain equals the host route and the JAX package, including for dtypes
    the device refuses (64-bit columns -> interpreted steps, counted)."""
    n = 50_000
    rng = np.random.default_rng(4)
    data = {"a": rng.integers(0, 1_000_000, n), "b": rng.random(n)}

    def q(pkg):
        c = pkg.col
        return (pkg.from_pydict(data).where(c("a") % 7 > 0)
                .with_column("c", c("b") * 2.0 + 1.0).where(c("c") > 1.1).select(c("a"), c("c")))

    fused = q(daft_tpu_torch).to_pydict()
    snap = _snap()
    # PushDownFilter merges the second filter, moved below the projection,
    # into the first, and column pruning narrows the select's input with a
    # Project of its own (as in the JAX package): four nodes, three fusions.
    assert snap["stage_fusions"] == 3
    assert snap["host_rows"]["chain_dtype_64bit"] == n
    with _host():
        host = q(daft_tpu_torch).to_pydict()
    assert fused == host == q(daft_tpu).to_pydict()


def test_filter_above_projection_drops_propagated_null_pred_rows():
    """A filter ABOVE a projection masks on the projected columns'
    PROPAGATED nulls (pred null -> row dropped), not the raw-input namespace:
    zero-filled null lanes would otherwise pass the predicate and survive."""
    from daft_tpu_torch.context import get_context
    from daft_tpu_torch.expressions.evaluator import resolve_schema
    from daft_tpu_torch.ops.compiled_eval import build_chain_spec

    n = 2048
    rng = np.random.default_rng(2)
    xs = [None if i % 11 == 0 else float(v) for i, v in enumerate(rng.uniform(1.0, 50.0, n))]
    df = daft_tpu_torch.from_pydict({"x": xs}).with_column(
        "x", daft_tpu_torch.col("x").cast(daft_tpu_torch.DataType.float32()))
    mp = df.collect()._result[0]
    rb = mp.combined()
    proj = (daft_tpu_torch.col("x") * 2).alias("v")._expr
    pred = (daft_tpu_torch.col("v") < 1e9)._expr  # true on every non-null lane
    steps = [("project", [proj]), ("filter", pred)]
    cfg = get_context().execution_config.with_changes(device_eval_min_rows=1)
    spec, reason = build_chain_spec(steps, rb.schema, resolve_schema([proj], rb.schema), cfg)
    assert spec is not None and reason is None, "project->filter chain must be compilable"
    out = spec.run_morsel(mp)
    assert out is not None, "compiled path must engage"
    got = out.combined().get_column("v").to_pylist()
    expected = [x * 2 for x in xs if x is not None]
    assert len(got) == len(expected)
    np.testing.assert_allclose(got, expected, rtol=1e-6)


def test_agg_chain_respects_min_rows_floor():
    """A tiny global agg takes the host (counted), like the elementwise path."""
    def q(pkg):
        df = pkg.from_pydict({"x": np.arange(50, dtype=np.float32)})
        return df.agg(pkg.col("x").sum().alias("s"))

    with _ctx(daft_tpu_torch, device_eval_min_rows=1024):
        out = q(daft_tpu_torch).to_pydict()
    assert out["s"] == [float(np.arange(50, dtype=np.float32).sum())] == q(daft_tpu).to_pydict()["s"]
    assert _snap()["chain_morsels"] == {}
    assert _snap()["host_rows"] == {"agg_below_min_rows": 50}


# -- the slice's queries against the JAX engine --------------------------------
def _lineitem(pkg, rows=10_000, seed=7):
    return pkg.from_pydict(lineitem.lineitem_columns(rows, seed))


def test_q06_matches_the_jax_engine():
    """TPC-H q06 (validation parameters) over 10K seeded lineitem rows with
    the TPC-H distributions: every row runs on the device in one program per
    chunk, and the revenue equals the JAX engine's and the f64 reference."""
    rows = 10_000
    got = lineitem.q06(daft_tpu_torch, _lineitem(daft_tpu_torch, rows)).to_pydict()
    snap = _snap()
    assert snap["chain_rows"] == {"filter_project_agg": rows} and snap["host_rows"] == {}, snap
    want = lineitem.q06(daft_tpu, _lineitem(daft_tpu, rows)).to_pydict()
    ref = lineitem.q06_reference(lineitem.lineitem_columns(rows, 7))
    np.testing.assert_allclose(got["revenue"], want["revenue"], rtol=SUM_RTOL)
    np.testing.assert_allclose(got["revenue"], [ref], rtol=SUM_RTOL)
    # The discount band's bounds occur in the data: 0.05 and 0.07 exactly.
    d = lineitem.lineitem_columns(rows, 7)["l_discount"]
    assert (d == np.float32(0.05)).any() and (d == np.float32(0.07)).any()


@pytest.mark.parametrize("literal", ["python", "float32"])
def test_filter_with_columns_matches_the_jax_engine(literal):
    """q01's projection under a filter (l_quantity < 48; disc_price, charge)
    over 10K rows: the device chain equals the JAX engine's bit for bit. With
    Python literals the host route computes f64 intermediates and rounds
    once, where the device rounds every op: two f32 roundings apart; with f32-typed literals it computes in f32 and equals the
    device bit for bit."""
    def q(pkg):
        c = pkg.col
        one = 1 if literal == "python" else pkg.lit(1.0, pkg.DataType.float32())
        price, disc = c("l_extendedprice"), c("l_discount")
        return (_lineitem(pkg).where(c("l_quantity") < 48)
                .with_columns({"disc_price": price * (one - disc),
                               "charge": price * (one - disc) * (one + c("l_tax"))}))

    got = q(daft_tpu_torch).to_pydict()
    assert _snap()["chain_rows"] == {"filter_project": 10_000}, _snap()
    jax = q(daft_tpu).to_pydict()
    with _host():
        host = q(daft_tpu_torch).to_pydict()
    assert got.keys() == jax.keys() == host.keys()
    for k in got:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(jax[k]), err_msg=k)
        if literal == "float32" or k not in ("disc_price", "charge"):
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(host[k]), err_msg=k)
        else:
            np.testing.assert_allclose(got[k], host[k], rtol=F32_ULPS, err_msg=k)


@pytest.mark.parametrize("dtype", ["int8", "int16", "int32", "uint8", "uint16", "uint32", "float32"])
def test_agg_chain_min_max_count_per_dtype(dtype):
    """min, max and count over every admitted numeric dtype run on the device
    and equal the JAX engine's exactly (f32 sums at rtol 1e-5)."""
    rng = np.random.default_rng(5)
    n = 6_000
    info = np.iinfo(dtype) if dtype != "float32" else None
    v = (rng.integers(info.min, int(info.max) + 1, n, dtype=np.int64).astype(dtype)
         if info else rng.standard_normal(n).astype(np.float32))
    data = {"v": v, "w": rng.random(n).astype(np.float32)}

    def q(pkg):
        c = pkg.col
        aggs = [c("v").min().alias("lo"), c("v").max().alias("hi"), c("v").count().alias("n")]
        if dtype == "float32":
            aggs.append(c("v").sum().alias("s"))
        return pkg.from_pydict(data).where(c("w") < 0.5).agg(*aggs)

    got = q(daft_tpu_torch).to_pydict()
    assert _snap()["chain_rows"] == {"filter_project_agg": n}, _snap()
    _assert_agg_equal(got, q(daft_tpu).to_pydict())


def test_mean_takes_the_host_partials_like_the_jax_package():
    """mean decomposes into an f64 sum and a count: the f64 partial keeps the
    aggregation on the host (counted), the filter chain under it still runs
    on the device, and the answer equals the JAX engine's."""
    def q(pkg):
        c = pkg.col
        return _f32_table(pkg).where(c("y") < 0.5).agg(c("x").mean().alias("m"))

    got = q(daft_tpu_torch).to_pydict()
    snap = _snap()
    # PushDownFilter moves the filter below the table's cast projection (as
    # in the JAX package), onto the f64 input: the chain runs interpreted.
    assert snap["chain_morsels"] == {} and "chain_dtype_64bit" in snap["host_rows"]
    assert "agg_dtype_64bit" in snap["host_rows"]
    np.testing.assert_allclose(got["m"], q(daft_tpu).to_pydict()["m"], rtol=1e-12)


def test_mean_takes_the_host_partials_like_the_jax_package_on_f32_columns():
    """The same query over columns that are f32 at the source: the filter
    chain runs on the device as one program, the f64 partial on the host."""
    rng = np.random.default_rng(3)
    data = {"x": rng.uniform(0.0, 100.0, 20_000).astype(np.float32),
            "y": rng.uniform(0.0, 1.0, 20_000).astype(np.float32)}

    def q(pkg):
        c = pkg.col
        return pkg.from_pydict(data).where(c("y") < 0.5).agg(c("x").mean().alias("m"))

    got = q(daft_tpu_torch).to_pydict()
    snap = _snap()
    assert snap["chain_morsels"] == {"filter_project": 1} and "agg_dtype_64bit" in snap["host_rows"]
    np.testing.assert_allclose(got["m"], q(daft_tpu).to_pydict()["m"], rtol=1e-12)


@pytest.mark.parametrize("route", ["below_min_rows", "not_fusable", "nullable_unsafe",
                                   "dtype_64bit", "compiled_eval_disabled"])
def test_each_host_route_is_counted(route):
    """Every host route is decided by plan, dtype or data as in the JAX
    package, counted, and gives the JAX engine's answer."""
    rng = np.random.default_rng(9)
    n = 4_096
    x = rng.standard_normal(n).astype(np.float32)
    data = {"x": [None if i % 5 == 0 else float(v) for i, v in enumerate(x)]} \
        if route == "nullable_unsafe" else {"x": x}
    if route == "dtype_64bit":
        data = {"x": x.astype(np.float64)}
    cfg = {"compiled_eval_enabled": False} if route == "compiled_eval_disabled" else {}
    if route == "below_min_rows":
        cfg["device_eval_min_rows"] = n + 1

    def q(pkg):
        c = pkg.col
        df = pkg.from_pydict(data)
        if route == "nullable_unsafe":
            df = df.with_column("x", c("x").cast(pkg.DataType.float32()))
            # A Kleene or that SimplifyExpressions cannot fold away.
            return df.select(((c("x") > 0) | (c("x") <= 0)).alias("r"))
        if route == "not_fusable":
            return df.select(c("x").float.fill_nan(0.0).alias("r"))
        return df.select((c("x") * 2).alias("r"))

    with _ctx(daft_tpu_torch, **cfg):
        got = q(daft_tpu_torch).to_pydict()
    key = f"chain_{route}"
    assert _snap()["host_rows"].get(key, 0) == n, _snap()
    assert got == q(daft_tpu).to_pydict()


def test_global_agg_over_no_rows_and_composite_exprs():
    """A global aggregation over an empty input still yields one row, and an
    expression over aggregations is evaluated over their results."""
    def q(pkg, rows):
        c = pkg.col
        df = pkg.from_pydict({"x": np.arange(rows, dtype=np.float32)})
        return df.where(c("x") >= 0).agg(c("x").sum().alias("s"), c("x").count().alias("n"),
                                          (c("x").max() - c("x").min()).alias("span"))

    for rows in (0, 3_000):
        assert q(daft_tpu_torch, rows).to_pydict() == q(daft_tpu, rows).to_pydict()


def test_grouped_aggregation_is_not_ported():
    """The slice that named this test had every group-by raise. Grouped
    aggregation is ported now: ``aggregate`` resolves the key fields, then the
    aggregation fields, as the JAX package does, the user-defined ones (which
    ROADMAP A.2 brought last) included, with their partial states' types."""
    from daft_tpu_torch.expressions.expr import AggOp
    from daft_tpu_torch.logical.builder import LogicalPlanBuilder

    df = daft_tpu_torch.from_pydict({"x": [1.0], "k": [1]})
    plan = LogicalPlanBuilder(df._builder.plan).aggregate(
        [daft_tpu_torch.col("x").sum()._expr], [daft_tpu_torch.col("k")._expr])
    jdf = daft_tpu.from_pydict({"x": [1.0], "k": [1]})
    jplan = jdf._builder.aggregate([daft_tpu.col("x").sum()._expr], [daft_tpu.col("k")._expr])
    assert [(f.name, repr(f.dtype)) for f in plan.schema] == \
        [(f.name, repr(f.dtype)) for f in jplan.schema] == [("k", "Int64"), ("x", "Float64")]
    from daft_tpu.expressions.expr import AggOp as JAggOp

    assert AggOp.OPS == JAggOp.OPS
    schemas = []
    for pkg, df, agg_op, plans in ((daft_tpu_torch, df, AggOp, LogicalPlanBuilder(
            df._builder.plan)), (daft_tpu, jdf, JAggOp, jdf._builder)):
        udaf = pkg.udf.udaf(pkg.DataType.int64())(len)
        aggs = [agg_op(op, pkg.col("x")._expr, {"udaf": udaf})
                for op in ("udaf", "udaf_partial", "udaf_merge")]
        schemas.append([(f.name, repr(f.dtype)) for f in plans.aggregate(
            [pkg.Expression(a).alias(a.op)._expr for a in aggs], [pkg.col("k")._expr]).schema])
    assert schemas[0] == schemas[1] == [("k", "Int64"), ("udaf", "Int64"),
                                        ("udaf_partial", "Binary"), ("udaf_merge", "Binary")]
