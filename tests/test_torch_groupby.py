"""The port's grouped aggregation (daft_tpu_torch: expressions/agg_eval.py,
execution/aggregation.py, the executor's cardinality switch, GroupedDataFrame)
against the JAX package's, on the CPU.

The same numpy-seeded columns go through ``daft_tpu`` and through
``daft_tpu_torch`` with ``device="cpu"``; rows are compared sorted by key.
The port's host route (``device_eval=False, compiled_eval_enabled=False``)
must equal the JAX package bit for bit. On the device_eval route the
aggregations' numeric children run as torch programs; it is held at rtol
1e-6, and where a test asserts it bit-equal, at 0.
"""

import contextlib

import numpy as np
import pyarrow as pa
import pytest

import daft_tpu
import daft_tpu_torch
from daft_tpu.execution import aggregation as jagg
from daft_tpu.execution.executor import Executor as JExecutor
from daft_tpu_torch.execution import aggregation as tagg
from daft_tpu_torch.execution.executor import Executor as TExecutor
from daft_tpu_torch.ops import device_eval as tde
from daft_tpu_torch.tools import lineitem

PKGS = (daft_tpu, daft_tpu_torch)
DEVICE_RTOL = 1e-6
N = 2000

HOST = {"device": "cpu", "device_eval": False, "compiled_eval_enabled": False}
DEVICE = {"device": "cpu", "device_eval": True, "device_eval_min_rows": 1}


def _masked(values, valid, dtype):
    return pa.array(values, dtype, mask=~valid)


def _data(n: int = N, seed: int = 0) -> dict:
    """Keys of every kind with nulls (ki, kf, ks, kb), f32 / int32 / bool
    values with nulls, and ``v`` all null in the group ki == 5."""
    rng = np.random.default_rng(seed)
    valid = lambda p: rng.random(n) >= p  # noqa: E731
    ki = rng.integers(0, 6, n).astype(np.int32)
    ki_valid = valid(0.05)
    v_valid = valid(0.1) & ~(ki_valid & (ki == 5))
    return {
        "ki": _masked(ki, ki_valid, pa.int32()),
        "kf": _masked(np.array([-1.5, 0.0, 2.25, 7.0], np.float32)[rng.integers(0, 4, n)],
                      valid(0.05), pa.float32()),
        "ks": _masked(np.array(["a", "bb", "ccc", ""])[rng.integers(0, 4, n)], valid(0.05),
                      pa.large_string()),
        "kb": _masked(rng.random(n) < 0.5, valid(0.05), pa.bool_()),
        "v": _masked(rng.standard_normal(n).astype(np.float32), v_valid, pa.float32()),
        "w": _masked(rng.integers(-1000, 1000, n).astype(np.int32), valid(0.1), pa.int32()),
        "p": _masked(np.where(rng.random(n) < 0.98, rng.choice([-1, 1], n), 2).astype(np.int32),
                     valid(0.1), pa.int32()),
        "b": _masked(rng.random(n) < 0.7, valid(0.1), pa.bool_()),
    }


def _aggs(pkg):
    c = pkg.col
    return [c("v").sum().alias("v_sum"), c("w").sum().alias("w_sum"),
            c("v").mean().alias("v_mean"), c("w").mean().alias("w_mean"),
            c("v").min().alias("v_min"), c("w").max().alias("w_max"),
            c("v").count().alias("v_n"), c("v").count("all").alias("v_all"),
            c("v").count("null").alias("v_nulls"), c("p").product().alias("p_prod"),
            c("v").any_value().alias("v_any"),
            c("v").any_value(ignore_nulls=True).alias("v_any_valid"),
            c("b").bool_and().alias("b_and"), c("b").bool_or().alias("b_or"),
            c("v").stddev().alias("v_std"), c("w").variance().alias("w_var"),
            ((c("v") * 2).sum() + 1).alias("composite"),
            (c("w").max() - c("w").min()).alias("w_span")]


@contextlib.contextmanager
def _configs(port_cfg, **both):
    with daft_tpu.execution_config_ctx(result_cache_enabled=False, **both), \
            daft_tpu_torch.execution_config_ctx(result_cache_enabled=False, **port_cfg, **both):
        yield


def _sort_key(row):
    return tuple((v is None, v if v is not None else 0) for v in row)


def _rows(out: dict, keys):
    """Columns → rows sorted by the key columns (nulls last)."""
    names = list(out)
    rows = list(zip(*[out[k] for k in names]))
    idx = [names.index(k) for k in keys]
    rows.sort(key=lambda r: _sort_key([r[i] for i in idx]))
    return names, rows


def _assert_rows(jax_out, port_out, keys, rtol=0.0):
    jn, jr = _rows(jax_out, keys)
    pn, pr = _rows(port_out, keys)
    assert jn == pn and len(jr) == len(pr)
    for a, b in zip(jr, pr):
        for name, x, y in zip(jn, a, b):
            if rtol and isinstance(x, float) and isinstance(y, float):
                np.testing.assert_allclose(y, x, rtol=rtol, err_msg=name)
            else:
                assert (x == y) or (x != x and y != y), (name, x, y)


def _grouped(pkg, data, keys, aggs=_aggs):
    return pkg.from_pydict(data).groupby(*keys).agg(*aggs(pkg))


def _schema(df):
    return [(f.name, repr(f.dtype)) for f in df.schema]


# -- every ported op over every key kind ---------------------------------------
@pytest.mark.parametrize("route", ["host", "device_eval"])
@pytest.mark.parametrize("keys", [("ki",), ("kf",), ("ks",), ("kb",), ("ki", "ks"),
                                  ("ks", "kb")])
def test_grouped_ops_equal_the_jax_package(keys, route):
    """Every ported op, composites included, per group of int, float, string
    and bool keys, one and two of them; null keys form their own group and
    the group ki == 5 has only null ``v``. Both routes evaluate the
    aggregations' children on the host, as the JAX package does, so with
    device_eval on no child row reaches the device."""
    data = _data()
    with _configs(HOST if route == "host" else DEVICE):
        tde.device_eval_counters.reset()
        port = _grouped(daft_tpu_torch, data, keys)
        got = port.to_pydict()
        snap = tde.device_eval_counters.snapshot()
        want = _grouped(daft_tpu, data, keys).to_pydict()
    assert _schema(port) == _schema(_grouped(daft_tpu, data, keys))
    _assert_rows(want, got, keys)
    # The grouped partials on the host, counted once per pass: the
    # first-morsel probe and the chunk. On the host route, the Project that
    # column pruning puts over the source (to the columns the aggregation
    # reads) runs interpreted, as its own stage.
    host_rows = {"agg_grouped": 2 * N}
    if route == "host":
        host_rows["chain_compiled_eval_disabled"] = N
    assert snap["fused_rows"] == 0 and snap["host_rows"] == host_rows
    if keys == ("ki",):
        v_sum = dict(zip(got["ki"], got["v_sum"]))
        v_n = dict(zip(got["ki"], got["v_n"]))
        assert v_sum[5] is None and v_n[5] == 0 and None in v_sum


def test_python_object_keys_take_the_code_path():
    """Python-object keys cannot go to Acero directly: the code path groups
    them through ``_group_codes`` and realigns Acero's output by argsort."""
    rng = np.random.default_rng(3)
    keys = [("x", i % 3) if i % 7 else None for i in range(300)]
    vals = rng.standard_normal(300).astype(np.float32)
    outs = []
    for pkg in PKGS:
        df = pkg.from_pydict({"k": pkg.Series.from_pylist(keys, "k", pkg.DataType.python()),
                              "v": vals})
        with _configs(HOST):
            outs.append(df.groupby("k").agg(pkg.col("v").sum().alias("s"),
                                            pkg.col("v").count().alias("n")).to_pydict())
    assert outs[0] == outs[1]
    assert len(outs[1]["k"]) == 4


@pytest.mark.parametrize("keys", [("ki",), ("ks", "kb")])
def test_grouped_empty_input(keys):
    """No input rows: no output rows, the resolved schema all the same."""
    data = {k: v.slice(0, 0) for k, v in _data().items()}
    with _configs(HOST):
        port = _grouped(daft_tpu_torch, data, keys)
        jax = _grouped(daft_tpu, data, keys)
        assert port.to_pydict() == jax.to_pydict()
    assert _schema(port) == _schema(jax)
    assert all(v == [] for v in port.to_pydict().values())


def test_grouped_dataframe_shorthands():
    """sum / mean / min / max / count / stddev / any_value over the non-key
    columns; agg_list, agg_concat and map_groups (which ROADMAP A.3.5
    brought; they raised naming A.3 before) as in the JAX package."""
    data = {k: v for k, v in _data().items() if k in ("ki", "v", "w")}
    with _configs(HOST):
        for op in ("sum", "mean", "min", "max", "count", "stddev", "any_value"):
            got, want = [getattr(pkg.from_pydict(data).groupby("ki"), op)().to_pydict()
                         for pkg in (daft_tpu_torch, daft_tpu)]
            _assert_rows(want, got, ("ki",))
        got, want = [pkg.from_pydict(data).groupby(pkg.col("ki")).sum("v").to_pydict()
                     for pkg in (daft_tpu_torch, daft_tpu)]
        _assert_rows(want, got, ("ki",))
        got, want = [pkg.from_pydict(data).groupby("ki").agg_list().sort("ki").to_pydict()
                     for pkg in (daft_tpu_torch, daft_tpu)]
        assert got == want
        lists = {"ki": data["ki"],
                 "l": [[x] if x is not None else None for x in data["w"].to_pylist()]}
        got, want = [pkg.from_pydict(lists).groupby("ki").agg_concat("l").sort("ki").to_pydict()
                     for pkg in (daft_tpu_torch, daft_tpu)]
        assert got == want
    from daft_tpu.udf import func
    from daft_tpu_torch.udf import Udf

    def centered(v):
        arr = v.to_numpy().astype(float)
        return arr - arr.mean()

    jdf = daft_tpu.from_pydict({"ki": [1, 1, 2], "v": [1.0, 3.0, 5.0]})
    jout = jdf.groupby("ki").map_groups(func.batch(
        return_dtype=daft_tpu.DataType.float64())(centered)(daft_tpu.col("v"))).sort("ki")
    pdf = daft_tpu_torch.from_pydict({"ki": [1, 1, 2], "v": [1.0, 3.0, 5.0]})
    with _configs(HOST):
        udf = Udf(centered, daft_tpu_torch.DataType.float64(), batch=True)
        pout = pdf.groupby("ki").map_groups(udf(daft_tpu_torch.col("v"))).sort("ki").to_pydict()
    assert pout == jout.to_pydict() == {"ki": [1, 1, 2], "v": [-1.0, 1.0, 0.0]}


# -- the cardinality switch -------------------------------------------------------
@contextlib.contextmanager
def _small_chunks(monkeypatch):
    """Morsels of 4096 rows and chunks of 8192+: several chunks on small data,
    in both packages alike."""
    for cls in (JExecutor, TExecutor):
        monkeypatch.setattr(cls, "AGG_CHUNK_ROWS", 8192)
    with daft_tpu.execution_config_ctx(default_morsel_size=4096, min_morsel_size=4096), \
            daft_tpu_torch.execution_config_ctx(default_morsel_size=4096):
        yield


def _spy(monkeypatch):
    calls = []
    real = TExecutor._partitioned_agg

    def spy(self, *args, **kwargs):
        calls.append(self.compute_threads)
        return real(self, *args, **kwargs)

    monkeypatch.setattr(TExecutor, "_partitioned_agg", spy)
    return calls


def _high_card(n=40_000, seed=1):
    rng = np.random.default_rng(seed)
    k = rng.integers(0, n // 2, n)
    return {"k": _masked(k.astype(np.int32), rng.random(n) >= 0.01, pa.int32()),
            "s": pa.array([f"g{x}" for x in k], pa.large_string()),
            "v": (rng.standard_normal(n) * 1000).astype(np.float32),
            "w": rng.integers(0, 100, n).astype(np.int32)}


def _card_aggs(pkg):
    c = pkg.col
    return [c("v").sum().alias("v_sum"), c("v").mean().alias("v_mean"),
            c("w").sum().alias("w_sum"), c("v").count().alias("n"),
            c("v").stddev().alias("v_std")]


@pytest.mark.parametrize("key", ["k", "s"])
@pytest.mark.parametrize("buckets", [1, 3, 8])
def test_partitioned_route_is_bucket_count_invariant(monkeypatch, buckets, key):
    """Half as many keys as rows: the first-morsel probe keeps > 30% of its
    rows, so the aggregation hash-partitions (the int key through the cheap
    multiply-shift bucketing, the string key through ``partition_by_hash``).
    At 1, 3 and 8 buckets every group's float sums are the same bits, and
    equal the JAX package's at the same bucket count."""
    data = _high_card()
    calls = _spy(monkeypatch)
    with _small_chunks(monkeypatch), _configs(HOST, num_compute_threads=buckets):
        got = _grouped(daft_tpu_torch, data, (key,), _card_aggs).to_pydict()
        want = _grouped(daft_tpu, data, (key,), _card_aggs).to_pydict()
    assert calls == [buckets]
    _assert_rows(want, got, (key,))
    with _small_chunks(monkeypatch), _configs(HOST, num_compute_threads=2):
        one_other = _grouped(daft_tpu_torch, data, (key,), _card_aggs).to_pydict()
    _assert_rows(one_other, got, (key,))
    assert len(got[key]) == len({x for x in (data[key].to_pylist())})


def test_merge_route_below_the_threshold(monkeypatch):
    """Few keys: the probe stays under the threshold and the chunks' partials
    merge in chunk order; several chunks, equal to the JAX package's bits on
    the host route and within rtol 1e-6 on the device_eval route."""
    data = _data(n=30_000, seed=2)
    calls = _spy(monkeypatch)
    for cfg, rtol in ((HOST, 0.0), (DEVICE, DEVICE_RTOL)):
        with _small_chunks(monkeypatch), _configs(cfg):
            got = _grouped(daft_tpu_torch, data, ("ki", "kb")).to_pydict()
            want = _grouped(daft_tpu, data, ("ki", "kb")).to_pydict()
        _assert_rows(want, got, ("ki", "kb"), rtol=rtol)
    assert calls == []


@pytest.mark.parametrize("threshold", [0.0, 1.0])
def test_threshold_picks_the_route(monkeypatch, threshold):
    """high_cardinality_aggregation_threshold decides: 0 partitions any
    grouped aggregation, 1 never; the answers agree."""
    data = _data()
    calls = _spy(monkeypatch)
    with _configs(HOST, high_cardinality_aggregation_threshold=threshold,
                  num_compute_threads=3):
        got = _grouped(daft_tpu_torch, data, ("ks",)).to_pydict()
        want = _grouped(daft_tpu, data, ("ks",)).to_pydict()
    _assert_rows(want, got, ("ks",))
    assert calls == ([3] if threshold == 0.0 else [])


def test_hash_partitioning_equals_the_jax_package():
    """Series.hash and partition_by_hash give the JAX package's buckets on
    every key kind (its native hash is the numpy path's bits)."""
    data = _data()
    for name in ("ki", "kf", "ks", "kb", "v", "w"):
        hashes = [pkg.Series.from_arrow(data[name], name).hash().to_numpy() for pkg in PKGS]
        np.testing.assert_array_equal(*hashes)
    parts = [pkg.RecordBatch.from_pydict(data).partition_by_hash(
        [pkg.Series.from_arrow(data["ks"], "ks"), pkg.Series.from_arrow(data["ki"], "ki")], 5)
        for pkg in PKGS]
    assert [p.to_pydict() for p in parts[0]] == [p.to_pydict() for p in parts[1]]


# -- AggState ---------------------------------------------------------------------
def _state(mod, pkg, data, group_by=("k",)):
    c = pkg.col
    df = pkg.from_pydict(data)
    aggs = [c("v").sum().alias("s"), c("v").mean().alias("m"), c("v").count().alias("n")]
    node = (df.groupby(*group_by).agg(*aggs) if group_by else df.agg(*aggs))._builder.plan
    return mod.AggState(node.agg_exprs, node.group_by, node.schema,
                        input_schema=df._builder.schema)


def _batch(pkg, data):
    return pkg.RecordBatch.from_arrow_table(pa.table(data))


def _feed(data):
    rng = np.random.default_rng(4)
    return [{"k": rng.integers(0, 5, 40).astype(np.int64),
             "v": rng.standard_normal(40)} for _ in range(6)]


def test_aggstate_merges_past_the_threshold(monkeypatch):
    """Raw morsels buffer until MERGE_THRESHOLD_ROWS, then flush to a partial;
    partials merge once they pass it. The port flushes and merges where the
    JAX package does, and finalizes to the same bits."""
    batches = _feed(None)
    states = []
    for mod, pkg in ((jagg, daft_tpu), (tagg, daft_tpu_torch)):
        monkeypatch.setattr(mod.AggState, "MERGE_THRESHOLD_ROWS", 60)
        st = _state(mod, pkg, batches[0])
        trace = []
        for b in batches:
            st.accumulate(pkg.MicroPartition.from_pydict(b))
            trace.append((st._raw_rows, len(st._buffers), st._buffer_rows))
        states.append((trace, st.finalize().to_pydict()))
    assert states[0] == states[1]
    assert any(t[1] == 1 and t[0] == 0 for t in states[1][0])  # a flush happened


def test_aggstate_fork_and_unmerged_partials():
    """fork() leaves the original untouched; a partial batch with repeated
    keys forces a merge pass even when it is the only buffer; the partial
    schema holds the key fields first."""
    outs = []
    for mod, pkg in ((jagg, daft_tpu), (tagg, daft_tpu_torch)):
        data = {"k": [0, 1, 0, 2], "v": [1.0, 2.0, 3.0, 4.0]}
        st = _state(mod, pkg, data)
        partial = _batch(pkg, data).agg(st.plan.partial_exprs, st.plan.group_by)
        dup = pkg.RecordBatch.concat([partial, partial])
        st.accumulate_unmerged_partial(dup)
        fork = st.fork()
        fork.accumulate_partial(partial)
        schema = st.partial_schema(pkg.from_pydict(data)._builder.schema)
        outs.append((_rows(st.finalize().to_pydict(), ("k",)),
                     _rows(fork.finalize().to_pydict(), ("k",)),
                     [(f.name, repr(f.dtype)) for f in schema]))
    assert outs[0] == outs[1]
    (_, base), (_, forked), fields = outs[1]
    assert base == [(0, 8.0, 2.0, 4), (1, 4.0, 2.0, 2), (2, 8.0, 4.0, 2)]
    assert forked == [(0, 12.0, 2.0, 6), (1, 6.0, 2.0, 3), (2, 12.0, 4.0, 3)]
    assert fields[0] == ("k", "Int64") and all(n.startswith("__p") for n, _ in fields[1:])


def test_aggstate_empty_partials_and_global_empty():
    """Empty batches through every ingest door change nothing: a never-fed
    grouped state finalizes to zero rows of its schema; a global one to its
    identity row."""
    st = _state(tagg, daft_tpu_torch, {"k": [1], "v": [1.0]})
    empty = _batch(daft_tpu_torch, {"k": pa.array([], pa.int64()), "v": pa.array([], pa.float64())})
    st.add_partial(empty)
    st.accumulate_partial(empty)
    st.accumulate_unmerged_partial(empty)
    assert st._buffers == [] and st._buffer_rows == 0 and not st._needs_merge
    out = st.finalize()
    assert len(out) == 0 and [f.name for f in out.schema] == ["k", "s", "m", "n"]
    glob = _state(tagg, daft_tpu_torch, {"k": [1], "v": [1.0]}, group_by=())
    assert glob.finalize().to_pydict() == {"s": [None], "m": [None], "n": [0]}


# -- q01 --------------------------------------------------------------------------
def test_q01_on_50000_rows():
    """TPC-H q01 (tools/lineitem.py) on 50,000 seeded rows: four groups; the
    host route and the device_eval route equal the JAX package bit for bit
    (the f32 ``1 -`` / ``1 +`` literals round alike on both paths), and
    every value is within 1e-5 of the f64 reference, the integer ones exact.
    The filter runs in the device chain, the aggregations and their children
    (disc_price, charge, the means' f64 casts) on the host."""
    cols = lineitem.lineitem_columns(50_000, seed=0)
    ref = lineitem.q01_reference(cols)
    with daft_tpu.execution_config_ctx(result_cache_enabled=False):
        want = lineitem.sorted_groups(lineitem.q01(daft_tpu, daft_tpu.from_pydict(cols)).to_pydict())
    kept = int((cols["l_shipdate"] <= lineitem.Q01_SHIPDATE_MAX).sum())
    for cfg in (HOST, DEVICE):
        tde.device_eval_counters.reset()
        with daft_tpu_torch.execution_config_ctx(**cfg):
            got = lineitem.sorted_groups(
                lineitem.q01(daft_tpu_torch, daft_tpu_torch.from_pydict(cols)).to_pydict())
        snap = tde.device_eval_counters.snapshot()
        assert got == want
        if cfg is DEVICE:
            # One morsel, one chunk: the probe and the chunk each aggregate
            # the kept rows on the host.
            assert snap["chain_rows"] == {"filter_project": 50_000}
            assert snap["fused_rows"] == 50_000
            assert snap["host_rows"] == {"agg_grouped": 2 * kept}
    assert (got["l_returnflag"], got["l_linestatus"]) == (["A", "N", "N", "R"],
                                                          ["F", "F", "O", "F"])
    for k, v in ref.items():
        if isinstance(v[0], float):
            np.testing.assert_allclose(got[k], v, rtol=1e-5, err_msg=k)
        else:
            assert got[k] == v, k


def test_lineitem_q06_columns_stay_byte_identical():
    """q01's columns come from a generator of their own, after q06's draws:
    q06's five columns are those of a draw without them."""
    cols = lineitem.lineitem_columns(1000, seed=0)
    rng = np.random.default_rng(0)
    quantity = rng.integers(1, 51, 1000, dtype=np.int32)
    partkey = rng.integers(1, 2_000_001, 1000, dtype=np.int64)
    np.testing.assert_array_equal(cols["l_quantity"], quantity)
    np.testing.assert_array_equal(cols["l_partkey"], partkey.astype(np.int32))
    assert set(cols["l_returnflag"].to_pylist()) <= {"A", "N", "R"}
    late = cols["l_receiptdate"] > lineitem.CURRENT_DAY
    flags = np.asarray(cols["l_returnflag"].to_pylist())
    assert (flags[late] == "N").all() and (flags[~late] != "N").all()
    status = np.asarray(cols["l_linestatus"].to_pylist())
    assert ((status == "O") == (cols["l_shipdate"] > lineitem.CURRENT_DAY)).all()
    gap = cols["l_receiptdate"] - cols["l_shipdate"]
    assert gap.min() >= 1 and gap.max() <= 30
