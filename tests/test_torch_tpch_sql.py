"""TPC-H q01-q22 in SQL (``daft_tpu_torch/tools/tpch_sql.py``) through
``daft_tpu_torch.sql`` and ``daft_tpu.sql``, on the CPU.

The JAX package's own TPC-H tables (``tests/benchmarks/tpch_dbgen.py`` at SF
0.005, seeded) are turned into Arrow on the test side and loaded into both
packages. For every query the port's optimized plan must equal the JAX
package's (node types, join types and keys, the build side of every join,
pushed-down filters and columns, shared subtrees), and its rows must equal
the JAX package's at 1 and at 4 compute workers: keys, strings and counts
exactly, floats bit for bit (both packages run these f64 columns on the host
with the same Arrow calls); q16's ``count(DISTINCT ...)`` included (ROADMAP
A.3.5 brought its list partials). A shared subtree runs once, by the executor's counters, for
q15, q17 and q02. On the port's own seeded tables (``tools/tpch.py``, f32
prices, ``date32`` dates), each query equals its numpy reference within
``RTOL`` (1e-6), the SQL form equals the DataFrame form where both exist,
and the date filters take the JAX package's routes.
"""

import datetime
import warnings

import numpy as np
import pyarrow as pa
import pytest

import daft_tpu
import daft_tpu_torch
from daft_tpu.logical.optimizer import Optimizer as JOptimizer
from daft_tpu_torch.execution.executor import Executor
from daft_tpu_torch.logical.optimizer import Optimizer as TOptimizer
from daft_tpu_torch.ops import device_eval as tde
from daft_tpu_torch.physical.plan import shared_subtree_ids
from daft_tpu_torch.physical.translate import translate
from daft_tpu_torch.tools import tpch, tpch_sql

from benchmarks.tpch_dbgen import generate_tpch_dbgen

pytestmark = pytest.mark.filterwarnings("ignore:Specifying null_placement:FutureWarning")

DBGEN_SF = 0.005
SF = 0.01
RTOL = 1e-6
RUNNABLE = list(tpch_sql.RUNNABLE)


@pytest.fixture(scope="module")
def dbgen():
    """The dbgen tables as Arrow, then as each package's DataFrames."""
    arrow = {k: v.to_arrow() for k, v in generate_tpch_dbgen(DBGEN_SF).items()}
    return arrow


def _frames(pkg, arrow):
    return {k: pkg.from_pydict({c: t.column(c).combine_chunks() for c in t.column_names})
            for k, t in arrow.items()}


@pytest.fixture(scope="module")
def tables():
    return tpch.tpch_tables(SF, seed=0, sql=True)


@pytest.fixture(autouse=True)
def _configs():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        with daft_tpu.execution_config_ctx(result_cache_enabled=False), \
                daft_tpu_torch.execution_config_ctx(device="cpu", result_cache_enabled=False):
            yield


def plan_signature(plan) -> tuple:
    """A plan as nested tuples: each node's type and what the rules set on
    it; a node reached again (a shared subtree) as its first visit's index."""
    seen = {}

    def rec(n):
        if id(n) in seen:
            return ("shared", seen[id(n)])
        seen[id(n)] = len(seen)
        kind = type(n).__name__
        d = [kind]
        if kind == "Join":
            d += [n.how, [repr(e) for e in n.left_on], [repr(e) for e in n.right_on]]
        elif kind == "Filter":
            d.append(repr(n.predicate))
        elif kind == "Project":
            d.append([repr(e) for e in n.exprs])
        elif kind == "Aggregate":
            d += [[repr(e) for e in n.agg_exprs], [repr(e) for e in n.group_by]]
        elif kind == "ScanSource":
            p = n.pushdowns
            d += [p.columns, repr(p.filters), p.limit]
        elif kind == "InMemorySource":
            d.append(n.schema.column_names())
        elif kind in ("Sort", "TopN"):
            d += [[repr(e) for e in n.sort_by], list(n.descending)]
        elif kind == "Limit":
            d += [n.limit, n.offset]
        return (tuple(map(str, d)), tuple(rec(c) for c in n.children()))

    return rec(plan)


def _joins(sig, out=None):
    out = [] if out is None else out
    if sig[0][0] == "Join":
        out.append(sig[0][1:])
    for c in sig[1] if sig[0] != "shared" else ():
        _joins(c, out)
    return out


@pytest.mark.parametrize("name", RUNNABLE)
def test_plan_matches_the_jax_package(name, dbgen):
    text = tpch_sql.sql_text(name, DBGEN_SF)
    jplan = JOptimizer().optimize(daft_tpu.sql(text, **_frames(daft_tpu, dbgen))._builder.plan)
    tplan = TOptimizer().optimize(
        daft_tpu_torch.sql(text, **_frames(daft_tpu_torch, dbgen))._builder.plan)
    jsig, tsig = plan_signature(jplan), plan_signature(tplan)
    assert _joins(tsig) == _joins(jsig)  # join order, types, keys and build sides
    assert tsig == jsig


def _rows_equal(a: dict, b: dict):
    assert list(a) == list(b)
    for k in a:
        assert len(a[k]) == len(b[k]), k
        for x, y in zip(a[k], b[k]):
            assert x == y or (x != x and y != y), (k, x, y)


@pytest.mark.parametrize("name", RUNNABLE)
def test_query_equals_the_jax_package_at_1_and_4_workers(name, dbgen):
    text = tpch_sql.sql_text(name, DBGEN_SF)
    outs = {}
    for threads in (1, 4):
        with daft_tpu_torch.execution_config_ctx(num_compute_threads=threads):
            outs[threads] = daft_tpu_torch.sql(text, **_frames(daft_tpu_torch, dbgen)).to_pydict()
    jax = daft_tpu.sql(text, **_frames(daft_tpu, dbgen)).to_pydict()
    _rows_equal(outs[1], outs[4])
    _rows_equal(outs[4], jax)


def test_q16_raises_naming_its_item(dbgen):
    """q16 runs (it raised naming A.3.5 until the list partials came): every
    query of q01-q22 is runnable, and q16's supplier counts over the JAX
    package's tables are that package's, group for group."""
    assert tpch_sql.RUNNABLE == tuple(tpch_sql.QUERIES) and len(RUNNABLE) == 22
    text = tpch_sql.sql_text("q16", DBGEN_SF)
    port = daft_tpu_torch.sql(text, **_frames(daft_tpu_torch, dbgen)).to_pydict()
    jax = daft_tpu.sql(text, **_frames(daft_tpu, dbgen)).to_pydict()
    assert port["supplier_cnt"] and port == jax


@pytest.mark.parametrize("name", ["q15", "q17", "q02"])
def test_a_shared_subtree_runs_once(name, dbgen):
    """The decorrelated plan reads one source from two parents (q17's
    lineitem, q02's partsupp / supplier / nation / region, q15's lineitem
    under the CTE's two uses): one physical node, filled once by the
    executor, whose other parents take the cached morsels."""
    df = daft_tpu_torch.sql(tpch_sql.sql_text(name, DBGEN_SF), **_frames(daft_tpu_torch, dbgen))
    plan = translate(TOptimizer().optimize(df._builder.plan))
    shared = shared_subtree_ids(plan)
    assert shared
    for threads in (1, 4):
        cfg = daft_tpu_torch.get_context().execution_config
        ex = Executor(cfg.with_changes(num_compute_threads=threads))
        out = list(ex.run(plan))
        assert set(ex.shared_fills) == shared
        assert all(n == 1 for n in ex.shared_fills.values()), ex.shared_fills
        assert sum(ex.shared_hits.values()) >= len(shared)
        assert sum(len(mp) for mp in out) == len(df.to_pydict()[df.column_names[0]])


def test_optimizer_memo_keeps_a_shared_subtree_shared():
    """A rewrite must not split a subtree two parents share: after every
    rule, q17's plan still reaches its lineitem source from both parents."""
    from daft_tpu_torch.logical import plan as lp

    li = daft_tpu_torch.from_pydict({"l_partkey": [1, 1, 2], "l_quantity": [1.0, 19.0, 4.0],
                                     "l_extendedprice": [10.0, 20.0, 30.0]})
    part = daft_tpu_torch.from_pydict({"p_partkey": [1, 2], "p_brand": ["Brand#23", "x"],
                                       "p_container": ["MED BOX", "y"]})
    df = daft_tpu_torch.sql(tpch_sql.QUERIES["q17"], lineitem=li, part=part)
    plan = TOptimizer().optimize(df._builder.plan)
    sources = {}
    for n in plan.walk():
        if isinstance(n, lp.InMemorySource) and "l_partkey" in n.schema.column_names():
            sources[id(n)] = sources.get(id(n), 0) + 1
    assert list(sources.values()) == [2]
    assert df.to_pydict() == {"avg_yearly": [10.0 / 7.0]}


def test_q06_date_routes_equal_the_jax_package(tables):
    """The SQL form compares ``date32`` columns with DATE literals: both
    packages refuse ``date32`` on the device, so the filter runs on the host
    in both and no filter chain runs on the device; only the final sum's
    partial is counted, at the same rows."""
    from daft_tpu import metrics

    def jax_kinds():
        snap = metrics.get_registry().snapshot()
        return {k: int(v) for k, v in snap.label_totals("daft_compiled_chain_rows_total",
                                                        "kind").items() if v}

    text = tpch_sql.sql_text("q06", SF)
    with daft_tpu.execution_config_ctx(device_eval_min_rows=1), \
            daft_tpu_torch.execution_config_ctx(device_eval_min_rows=1):
        before = jax_kinds()
        jax = daft_tpu.sql(text, **tpch.sql_frames(daft_tpu, tables)).to_pydict()
        after = jax_kinds()
        tde.device_eval_counters.reset()
        port = daft_tpu_torch.sql(text, **tpch.sql_frames(daft_tpu_torch, tables)).to_pydict()
        snap = tde.device_eval_counters.snapshot()
    jax_chains = {k: after.get(k, 0) - before.get(k, 0) for k in after}
    assert snap["chain_rows"] == {k: v for k, v in jax_chains.items() if v}
    assert tpch.filter_on_host(snap["chain_rows"], len(tables["lineitem"]["l_orderkey"]))
    assert port == jax
    assert not daft_tpu_torch.DataType.date().is_device_representable()


@pytest.mark.parametrize("name", RUNNABLE)
def test_query_equals_its_reference(name, tables):
    tde.device_eval_counters.reset()
    out = daft_tpu_torch.sql(tpch_sql.sql_text(name, SF),
                             **tpch.sql_frames(daft_tpu_torch, tables)).to_pydict()
    host = tpch.filter_on_host(tde.device_eval_counters.snapshot()["chain_rows"],
                               len(tables["lineitem"]["l_orderkey"]))
    ref = tpch.SQL_REFERENCES[name](tables, SF, host)
    assert tpch.sql_compare(name, out, ref, RTOL) == []


FRAME_FORMS = ["q03", "q04"] + list(tpch.EXPR_QUERIES)


@pytest.mark.parametrize("name", FRAME_FORMS)
def test_sql_form_equals_the_dataframe_form(name, tables):
    out = daft_tpu_torch.sql(tpch_sql.sql_text(name, SF),
                             **tpch.sql_frames(daft_tpu_torch, tables)).to_pydict()
    frame = tpch.frame_query(daft_tpu_torch, tables, name).to_pydict()
    assert tpch.frame_compare(name, out, frame, RTOL) == []
    assert all(len(v) for v in frame.values()), "an empty result tests nothing"


def test_sql_columns_leave_the_earlier_columns_byte_identical():
    plain = tpch.tpch_tables(SF, seed=3, expressions=True)
    full = tpch.tpch_tables(SF, seed=3, sql=True)
    for table, cols in plain.items():
        for col, values in cols.items():
            other = full[table][col]
            if isinstance(values, np.ndarray):
                assert values.dtype == other.dtype and np.array_equal(values, other), col
            else:
                assert values.equals(other), col


def test_sql_columns_follow_the_spec(tables):
    li, o, cu = tables["lineitem"], tables["orders"], tables["customer"]
    p, su, ps = tables["part"], tables["supplier"], tables["partsupp"]
    status = np.array(li["l_linestatus"].to_pylist())
    assert ((status == "O") == (li["l_shipdate"] > tpch.CURRENT_DAY)).all()
    assert set(np.round(li["l_tax"] * 100).astype(int).tolist()) <= set(range(9))
    # An order is F / O when all its lines are, else P.
    per_order = {}
    for k, s in zip(li["l_orderkey"].tolist(), status.tolist()):
        per_order.setdefault(k, set()).add(s)
    want = ["F" if v == {"F"} else "O" if v == {"O"} else "P"
            for v in (per_order[k] for k in o["o_orderkey"].tolist())]
    assert o["o_orderstatus"].to_pylist() == want
    charge = li["l_extendedprice"].astype(np.float64) * (1 + li["l_tax"].astype(np.float64)) \
        * (1 - li["l_discount"].astype(np.float64))
    totals = np.bincount(np.searchsorted(o["o_orderkey"], li["l_orderkey"]), weights=charge)
    np.testing.assert_allclose(o["o_totalprice"], totals, rtol=1e-6)
    phones = cu["c_phone"].to_pylist()
    assert [int(x[:2]) for x in phones] == (cu["c_nationkey"] + 10).tolist()
    assert all(len(x) == 15 and x.count("-") == 3 for x in phones)
    assert cu["c_name"][0].as_py() == "Customer#000000001"
    assert all(10 <= len(a) <= 40 for a in cu["c_address"].to_pylist())
    assert -999.99 <= float(cu["c_acctbal"].min()) and float(cu["c_acctbal"].max()) <= 9999.99
    assert [m[-1] for m in p["p_mfgr"].to_pylist()] == [b[6] for b in p["p_brand"].to_pylist()]
    comments = su["s_comment"].to_pylist()
    complaints = [c for c in comments if "Customer" in c and "Complaints" in c.split("Customer")[1]]
    assert len(complaints) == max(1, round(SF * 5))
    assert 1 <= int(ps["ps_availqty"].min()) and int(ps["ps_availqty"].max()) <= 9999


def test_date32_view_is_the_day_plus_its_epoch_offset(tables):
    days = tables["orders"]["o_orderdate"]
    view = tpch.date32(days)
    assert view.type == pa.date32()
    assert view.to_pylist()[:3] == [tpch.EPOCH + datetime.timedelta(int(d)) for d in days[:3]]
