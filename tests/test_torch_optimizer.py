"""The port's optimizer (``daft_tpu_torch/logical/optimizer.py``) against the
JAX package's, on the CPU.

Mirrors ``tests/test_optimizer.py`` case for case through
``daft_tpu_torch`` with ``device="cpu"``, ``DetectMonotonicId``,
``DropRepartition`` and the row-id path of ``UnnestSubqueries`` included
(ROADMAP A.3.5; C.36 closed). For every rule, the same seeded plan goes through both packages'
``Optimizer``: the optimized plans must have the same tree of node types,
join types, join keys and build sides, and the same pushed-down filters and
columns (``plan_signature``), and the rows must be the JAX package's.
"""

import logging
import warnings

import numpy as np
import pytest

import daft_tpu
import daft_tpu_torch
from daft_tpu.logical.optimizer import Optimizer as JOptimizer
from daft_tpu_torch import col, lit
from daft_tpu_torch.logical import optimizer as topt
from daft_tpu_torch.logical import plan as lp
from daft_tpu_torch.logical.optimizer import Optimizer, simplify_expr

pytestmark = pytest.mark.filterwarnings("ignore:Specifying null_placement:FutureWarning")


@pytest.fixture(autouse=True)
def _cpu():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        with daft_tpu.execution_config_ctx(result_cache_enabled=False), \
                daft_tpu_torch.execution_config_ctx(device="cpu"):
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
        elif kind == "MonotonicallyIncreasingId":
            d.append(n.column_name)
        elif kind == "Repartition":
            d.append(repr(n.scheme))
        return (tuple(map(str, d)), tuple(rec(c) for c in n.children()))

    return rec(plan)


def _optimized(df):
    return Optimizer().optimize(df._builder.plan)


def _nodes(plan):
    out, seen = [], set()

    def walk(n):
        if id(n) in seen:
            return
        seen.add(id(n))
        out.append(n)
        for c in n.children():
            walk(c)

    walk(plan)
    return out


# -- the engine ----------------------------------------------------------------
def test_batches_are_the_jax_packages_less_the_left_out_rules():
    left_out = {"PushDownShard"}
    want = [[r.name for r in b if r.name not in left_out] for b in JOptimizer().batches]
    want = [b for b in want if b]
    assert [[r.name for r in b] for b in Optimizer().batches] == want
    assert "PushDownShard" in topt.__doc__ and "A.8" in topt.__doc__
    assert not hasattr(topt, "PushDownShard")
    assert hasattr(topt, "DetectMonotonicId") and hasattr(topt, "DropRepartition")
    assert Optimizer().cfg is daft_tpu_torch.get_context().execution_config


def test_crashing_rule_is_logged_and_skipped(caplog):
    class Boom(topt.Rule):
        name = "Boom"

        def rewrite(self, node):
            raise RuntimeError("boom")

    df = daft_tpu_torch.from_pydict({"a": [1, 2, 3]}).where(col("a") > 1)
    opt = Optimizer()
    opt.batches = [[Boom()]] + opt.batches
    with caplog.at_level(logging.WARNING, logger="daft_tpu_torch.optimizer"):
        plan = opt.optimize(df._builder.plan)
    assert any("Boom" in r.getMessage() for r in caplog.records)
    assert plan_signature(plan) == plan_signature(_optimized(df))


def test_rewriters_keep_a_shared_subtree_shared():
    src = daft_tpu_torch.from_pydict({"k": [1, 2], "v": [3.0, 4.0]})._builder.plan
    f = lp.Filter(src, (col("v") > 0)._expr)
    dag = lp.Join(f, f, [col("k")._expr], [col("k")._expr], "semi")

    class Rebuild(topt.Rule):
        def rewrite(self, node):
            return lp.Filter(node.children()[0], node.predicate) \
                if isinstance(node, lp.Filter) else None

    for rewriter in (topt._rewrite_bottom_up, topt._rewrite_top_down):
        out = rewriter(dag, Rebuild())
        a, b = out.children()
        assert a is b and a is not f


def test_a_missing_node_raises_naming_its_item():
    """C.36 closed: the row-id path of ``UnnestSubqueries`` (a non-equi
    correlation beyond one ``<>``) tags the outer rows with
    ``MonotonicallyIncreasingId``, plans node for node as the JAX package's
    and returns its rows; no rule raises ``DaftNotImplementedError`` any
    more, so every exception a rule raises is logged and skipped."""
    data = {"ok": [1, 1, 2, 2, 3], "sk": [10, 20, 30, 40, 50], "q": [1, 2, 3, 1, 5]}
    query = """SELECT sk FROM li l1 WHERE EXISTS (
            SELECT 1 FROM li l2 WHERE l2.ok = l1.ok AND l2.sk <> l1.sk AND l2.q > l1.q)"""
    jdf = daft_tpu.sql(query, li=daft_tpu.from_pydict(data))
    pdf = daft_tpu_torch.sql(query, li=daft_tpu_torch.from_pydict(data))
    plan = _optimized(pdf)
    assert plan_signature(plan) == plan_signature(JOptimizer().optimize(jdf._builder.plan))
    assert any(isinstance(n, lp.MonotonicallyIncreasingId) for n in _nodes(plan))
    assert sorted(pdf.to_pydict()["sk"]) == sorted(jdf.to_pydict()["sk"]) == [10, 40]
    import inspect

    assert "DaftNotImplementedError" not in inspect.getsource(Optimizer.optimize)


# -- tests/test_optimizer.py, case for case ---------------------------------------
def test_filter_pushdown_into_scan(tmp_path):
    df = daft_tpu_torch.from_pydict({"a": [1, 2, 3], "b": ["x", "y", "z"]})
    df.write_parquet(str(tmp_path))
    scan_df = daft_tpu_torch.read_parquet(str(tmp_path))
    plan = _optimized(scan_df.select("a", "b").where(col("a") > 1))
    scans = [n for n in plan.walk() if isinstance(n, lp.ScanSource)]
    assert scans and scans[0].pushdowns.filters is not None


def test_projection_pushdown_into_scan(tmp_path):
    df = daft_tpu_torch.from_pydict({"a": [1], "b": ["x"], "c": [1.0]})
    df.write_parquet(str(tmp_path))
    plan = _optimized(daft_tpu_torch.read_parquet(str(tmp_path)).select("a"))
    scans = [n for n in plan.walk() if isinstance(n, lp.ScanSource)]
    assert scans[0].pushdowns.columns == ("a",)


def test_limit_pushdown(tmp_path):
    df = daft_tpu_torch.from_pydict({"a": list(range(100))})
    df.write_parquet(str(tmp_path))
    plan = _optimized(daft_tpu_torch.read_parquet(str(tmp_path)).limit(5))
    scans = [n for n in plan.walk() if isinstance(n, lp.ScanSource)]
    assert scans[0].pushdowns.limit == 5


def test_sort_limit_fuses_topn():
    df = daft_tpu_torch.from_pydict({"a": [3, 1, 2]})
    plan = _optimized(df.sort("a").limit(2))
    assert any(isinstance(n, lp.TopN) for n in plan.walk())
    assert df.sort("a").limit(2).to_pydict()["a"] == [1, 2]


def test_filter_merge():
    df = daft_tpu_torch.from_pydict({"a": [1, 2, 3]})
    plan = _optimized(df.where(col("a") > 1).where(col("a") < 3))
    filters = [n for n in plan.walk() if isinstance(n, lp.Filter)]
    assert len(filters) == 1


def test_split_udfs():
    from daft_tpu_torch.udf import Udf

    f = Udf(lambda x: x, daft_tpu_torch.DataType.int64(), batch=True, name="f")
    df = daft_tpu_torch.from_pydict({"a": [1, 2]})
    plan = _optimized(df.select(f(col("a")).alias("fa"), col("a")))
    assert any(isinstance(n, lp.UDFProject) for n in plan.walk())
    out = df.select(f(col("a")).alias("fa"), col("a")).to_pydict()
    assert out == {"fa": [1, 2], "a": [1, 2]}


def test_constant_folding():
    from daft_tpu_torch.expressions.expr import Literal

    folded = simplify_expr((lit(2) + lit(3))._expr)
    assert isinstance(folded, Literal) and folded.value == 5


def test_filter_pushdown_through_join():
    left = daft_tpu_torch.from_pydict({"k": [1, 2], "a": [10, 20]})
    right = daft_tpu_torch.from_pydict({"k": [1, 2], "b": [100, 200]})
    joined = left.join(right, on="k").where(col("a") > 10)
    plan = _optimized(joined)
    join_nodes = [n for n in plan.walk() if isinstance(n, lp.Join)]
    assert join_nodes
    assert any(isinstance(n, lp.Filter) for n in join_nodes[0].children()[0].walk())
    assert joined.to_pydict()["a"] == [20]


def test_eliminate_cross_join():
    left = daft_tpu_torch.from_pydict({"k": [1, 2, 3], "a": [10, 20, 30]})
    right = daft_tpu_torch.from_pydict({"j": [2, 3, 4], "b": [200, 300, 400]})
    q = left.cross_join(right).where((col("k") == col("j")) & (col("b") > 200))
    joins = [n for n in _optimized(q).walk() if isinstance(n, lp.Join)]
    assert joins and joins[0].how == "inner"
    out = q.sort("k").to_pydict()
    assert out["k"] == [3] and out["b"] == [300]


def test_unnest_in_subquery_to_semi_join():
    left = daft_tpu_torch.from_pydict({"id": [1, 2, 3], "v": [10, 20, 30]})
    keys = daft_tpu_torch.from_pydict({"id": [2, 3]})
    q = left.where(col("id").is_in(keys.select("id")))
    joins = [n for n in _optimized(q).walk() if isinstance(n, lp.Join)]
    assert joins and joins[0].how == "semi"
    assert q.sort("id").to_pydict()["id"] == [2, 3]


def test_unnest_not_in_subquery_to_anti_join():
    left = daft_tpu_torch.from_pydict({"id": [1, 2, 3]})
    keys = daft_tpu_torch.from_pydict({"id": [2]})
    q = left.where(~col("id").is_in(keys))
    joins = [n for n in _optimized(q).walk() if isinstance(n, lp.Join)]
    assert joins and joins[0].how == "anti"
    assert q.sort("id").to_pydict()["id"] == [1, 3]


def test_unnest_scalar_subquery_cross_join():
    t = daft_tpu_torch.from_pydict({"x": [1.0, 5.0, 9.0]})
    out = daft_tpu_torch.sql("SELECT x FROM t WHERE x > (SELECT avg(x) FROM t)").to_pydict()
    assert out["x"] == [9.0]


def _star(pkg):
    rng = np.random.default_rng(0)
    n = 50_000
    fact = pkg.from_pydict({"f_ok": rng.integers(0, 5_000, n), "f_sk": rng.integers(0, 50, n),
                            "f_val": rng.random(n)})
    orders = pkg.from_pydict({"o_ok": list(range(5_000)), "o_ck": [i % 500 for i in range(5_000)]})
    cust = pkg.from_pydict({"c_ck": list(range(500))})
    supp = pkg.from_pydict({"s_sk": list(range(50))})
    return fact, orders, cust, supp


def _star_join(pkg):
    fact, orders, cust, supp = _star(pkg)
    return (fact.join(orders, left_on="f_ok", right_on="o_ok")
            .join(cust, left_on="o_ck", right_on="c_ck")
            .join(supp, left_on="f_sk", right_on="s_sk"))


def test_reorder_joins_keeps_fact_on_probe_side():
    df = _star_join(daft_tpu_torch)
    joins = [n for n in _optimized(df).walk() if isinstance(n, lp.Join)]
    assert len(joins) == 3
    for j in joins:
        assert j.children()[1].approx_stats().num_rows < 25_000, f"fact table on build side: {j}"
    got = df.agg(col("f_val").sum().alias("s")).to_pydict()["s"][0]
    fact, orders, cust, supp = (d.to_pydict() for d in _star(daft_tpu_torch))
    o_ck = dict(zip(orders["o_ok"], orders["o_ck"]))
    ref = sum(v for ok, sk, v in zip(fact["f_ok"], fact["f_sk"], fact["f_val"])
              if ok in o_ck and o_ck[ok] < 500 and sk < 50)
    assert abs(got - ref) < 1e-6


def test_reorder_joins_restores_output_schema():
    df = _star_join(daft_tpu_torch)
    assert [f.name for f in _optimized(df).schema] == df.column_names


def test_in_subquery_under_or():
    left = daft_tpu_torch.from_pydict({"id": [1, 2, 3, 4]})
    keys = daft_tpu_torch.from_pydict({"id": [3, 3, 4]})
    assert left.where(col("id").is_in(keys) | (col("id") == 1)).sort("id").to_pydict()["id"] \
        == [1, 3, 4]
    assert left.where(~col("id").is_in(keys) | (col("id") == 4)).sort("id").to_pydict()["id"] \
        == [1, 2, 4]


def test_sql_exists_under_or():
    cust = daft_tpu_torch.from_pydict({"c_id": [1, 2, 3]})
    orders = daft_tpu_torch.from_pydict({"c_id": [3]})
    out = daft_tpu_torch.sql("""
        SELECT c_id FROM cust WHERE c_id = 1 OR EXISTS (
            SELECT 1 FROM orders WHERE orders.c_id = cust.c_id)
        ORDER BY c_id""", cust=cust, orders=orders).to_pydict()
    assert out["c_id"] == [1, 3]


def test_correlated_complex_subquery_rejected():
    cust = daft_tpu_torch.from_pydict({"c_id": [1, 2], "total": [1.0, 1000.0]})
    orders = daft_tpu_torch.from_pydict({"c_id": [1, 3], "total": [5.0, 50.0]})
    with pytest.raises(Exception, match="correlated reference"):
        daft_tpu_torch.sql("""
            SELECT c_id FROM cust WHERE c_id IN (
                SELECT c_id FROM orders WHERE total > cust.total GROUP BY c_id)""",
                           cust=cust, orders=orders).collect()


def test_drop_repartition_and_filter_through_it():
    """DropRepartition drops a repartition under another, and a filter moves
    below a repartition, as in the JAX package: the same plan, the same rows."""
    outs, sigs = [], []
    for pkg in (daft_tpu, daft_tpu_torch):
        df = pkg.from_pydict({"k": [1, 2, 3, 4, 5], "v": [5.0, 4.0, 3.0, 2.0, 1.0]})
        q = df.repartition(3, "k").repartition(2).where(pkg.col("v") > 1.5)
        opt = JOptimizer() if pkg is daft_tpu else Optimizer()
        sigs.append(plan_signature(opt.optimize(q._builder.plan)))
        outs.append(sorted(q.to_pydict()["k"]))
    assert sigs[0] == sigs[1] and str(sigs[1]).count("'Repartition'") == 1
    assert outs[0] == outs[1] == [1, 2, 3, 4]


def test_detect_monotonic_id_expression():
    """DetectMonotonicId rewrites the projection into the
    MonotonicallyIncreasingId node, as the JAX package does: the same plan
    and the same ids."""
    outs, sigs = [], []
    for pkg in (daft_tpu, daft_tpu_torch):
        F = __import__(f"{pkg.__name__}.functions", fromlist=["x"])
        df = pkg.from_pydict({"a": [10, 20, 30]})
        q = df.select(pkg.col("a"), (F.monotonically_increasing_id() + 1).alias("rid"))
        opt = JOptimizer() if pkg is daft_tpu else Optimizer()
        sigs.append(plan_signature(opt.optimize(q._builder.plan)))
        outs.append(q.to_pydict())
    assert sigs[0] == sigs[1] and "MonotonicallyIncreasingId" in str(sigs[1])
    assert outs[0] == outs[1] == {"a": [10, 20, 30], "rid": [1, 2, 3]}


def test_enrich_with_stats_and_count_pushdown(tmp_path):
    df = daft_tpu_torch.from_pydict({"x": list(range(500)),
                                     "y": [None if i % 5 == 0 else i for i in range(500)]})
    df.write_parquet(str(tmp_path))
    scan = daft_tpu_torch.read_parquet(str(tmp_path))
    n_plan = _optimized(scan.agg(col("x").count().alias("n")))
    assert not any(isinstance(n, lp.ScanSource) for n in _nodes(n_plan))
    assert scan.agg(col("x").count().alias("n")).to_pydict() == {"n": [500]}
    assert scan.agg(col("y").count().alias("n")).to_pydict() == {"n": [400]}
    f_plan = _optimized(scan.where(col("x") > 10).agg(col("x").count().alias("n")))
    assert any(isinstance(n, lp.ScanSource) for n in _nodes(f_plan))
    assert scan.where(col("x") > 10).agg(col("x").count().alias("n")).to_pydict() == {"n": [489]}


def test_enrich_with_stats_row_counts(tmp_path):
    daft_tpu_torch.from_pydict({"a": list(range(123))}).write_parquet(str(tmp_path))
    scan = daft_tpu_torch.read_parquet(str(tmp_path))
    src = [n for n in _nodes(_optimized(scan.where(col("a") > 5)))
           if isinstance(n, lp.ScanSource)][0]
    assert all(f.num_rows is not None for f in src.scan_info.files())
    assert sum(f.num_rows for f in src.scan_info.files()) == 123
    assert "a" in src.scan_info._column_stats


def test_filter_null_join_key_with_evidence():
    left = daft_tpu_torch.from_pydict({"k": [1, None, 2, None, 3], "v": [1, 2, 3, 4, 5]})
    right = daft_tpu_torch.from_pydict({"k": [1, 2, 9], "w": [10.0, 20.0, 30.0]})
    j = left.join(right, on="k")
    filters = [n for n in _nodes(_optimized(j)) if isinstance(n, lp.Filter)
               and "not_null" in repr(n.predicate)]
    assert filters, "expected a not-null key filter on the nulled side"
    assert j.sort(["k"]).to_pydict()["k"] == [1, 2]
    clean = daft_tpu_torch.from_pydict({"k": [1, 2], "v": [1, 2]})
    assert not any(isinstance(n, lp.Filter) and "not_null" in repr(n.predicate)
                   for n in _nodes(_optimized(clean.join(right, on="k"))))


def test_filter_null_join_key_anti_keeps_null_left_rows():
    left = daft_tpu_torch.from_pydict({"k": [1, None, 5]})
    right = daft_tpu_torch.from_pydict({"k": [1, None]})
    out = left.join(right, on="k", how="anti").to_pydict()
    assert sorted(v for v in out["k"] if v is not None) == [5]
    assert None in out["k"]


def test_count_pushdown_struct_column_bails_to_scan(tmp_path):
    df = daft_tpu_torch.from_pydict({"s": [{"a": 1, "b": None}, None, {"a": None, "b": 2}]})
    df.write_parquet(str(tmp_path))
    scan = daft_tpu_torch.read_parquet(str(tmp_path))
    assert any(isinstance(n, lp.ScanSource)
               for n in _nodes(_optimized(scan.agg(col("s").count().alias("n")))))
    assert scan.agg(col("s").count().alias("n")).to_pydict() == {"n": [2]}
    assert scan.agg(col("s").count(mode="all").alias("n")).to_pydict() == {"n": [3]}


def test_simplify_algebraic_identities():
    from daft_tpu_torch.datatype import DataType
    from daft_tpu_torch.expressions.expr import BinaryOp, ColumnRef, Literal, UnaryOp
    from daft_tpu_torch.schema import Field, Schema

    sch = Schema([Field("x", DataType.int64()), Field("f", DataType.float64()),
                  Field("b", DataType.bool())])
    x, f, b = ColumnRef("x"), ColumnRef("f"), ColumnRef("b")
    assert simplify_expr(BinaryOp("mul", x, Literal(1)), sch).key() == x.key()
    assert simplify_expr(BinaryOp("add", Literal(0), x), sch).key() == x.key()
    assert simplify_expr(BinaryOp("sub", x, Literal(0)), sch).key() == x.key()
    assert simplify_expr(BinaryOp("truediv", f, Literal(1)), sch).key() == f.key()
    assert isinstance(simplify_expr(BinaryOp("truediv", x, Literal(1)), sch), BinaryOp)
    assert simplify_expr(BinaryOp("eq", x, Literal(None)), sch).value is None
    assert simplify_expr(BinaryOp("add", Literal(None), x), sch).value is None
    assert isinstance(simplify_expr(BinaryOp("or", b, Literal(None)), sch), BinaryOp)
    assert simplify_expr(BinaryOp("and", b, Literal(False)), sch).value is False
    assert simplify_expr(BinaryOp("or", Literal(True), b), sch).value is True
    assert simplify_expr(BinaryOp("eq", b, Literal(True)), sch).key() == b.key()
    notb = simplify_expr(BinaryOp("eq", b, Literal(False)), sch)
    assert isinstance(notb, UnaryOp) and notb.op == "not"
    assert simplify_expr(BinaryOp("ne", Literal(False), b), sch).key() == b.key()
    assert isinstance(simplify_expr(BinaryOp("eq", x, Literal(True)), sch), BinaryOp)
    assert simplify_expr(UnaryOp("negate", UnaryOp("negate", x)), sch).key() == x.key()


def test_simplify_end_to_end_results_unchanged():
    df = daft_tpu_torch.from_pydict({"x": [1, 2, None], "b": [True, False, None]})
    out = df.select((col("x") * 1 + 0).alias("x2"), (col("b") == lit(True)).alias("bt"),
                    (col("x") + lit(None)).alias("xn")).to_pydict()
    assert out == {"x2": [1, 2, None], "bt": [True, False, None], "xn": [None, None, None]}


def test_simplify_null_propagation_keeps_dtype():
    out = daft_tpu_torch.from_pydict({"x": [1, 2]}).select((col("x") + lit(None)).alias("xn"))
    assert out.schema["xn"].dtype == daft_tpu_torch.DataType.int64()
    rb = list(out.collect().iter_partitions())[0].combined()
    assert rb.get_column("xn").dtype == daft_tpu_torch.DataType.int64()
    assert rb.get_column("xn").to_pylist() == [None, None]


def test_simplify_null_filtered_join():
    a = daft_tpu_torch.from_pydict({"k": [1, 2, 3], "x": [10, 20, 30]})
    b = daft_tpu_torch.from_pydict({"k": [1, 2], "y": [5, -5]})
    j = a.join(b, on="k", how="left").where(col("y") > 0)
    joins = [n for n in _nodes(_optimized(j)) if isinstance(n, lp.Join)]
    assert joins and all(n.how == "inner" for n in joins)
    assert j.sort(["k"]).to_pydict()["k"] == [1]
    j2 = a.join(b, on="k", how="outer").where((col("x") > 0) & (col("y") > -99))
    assert all(n.how == "inner" for n in _nodes(_optimized(j2)) if isinstance(n, lp.Join))
    j3 = a.join(b, on="k", how="left").where(col("y").is_null())
    assert any(n.how == "left" for n in _nodes(_optimized(j3)) if isinstance(n, lp.Join))
    assert j3.to_pydict()["k"] == [3]


def test_simplify_null_filtered_join_outer_single_side_and_merged_keys():
    a = daft_tpu_torch.from_pydict({"k": [1, 3]})
    b = daft_tpu_torch.from_pydict({"k": [1, 2], "y": [5, 6]})
    out = a.join(b, on="k", how="outer").where(col("y") > 0).sort(["k"]).to_pydict()
    assert out["k"] == [1, 2]
    out2 = a.join(b, on="k", how="right").where(col("k") > 0).sort(["k"]).to_pydict()
    assert out2["k"] == [1, 2]


def test_null_filtered_join_not_null_over_masking_kernel():
    a = daft_tpu_torch.from_pydict({"k": [1, 2, 3]})
    b = daft_tpu_torch.from_pydict({"k": [1, 2], "y": [5, 6]})
    out = (a.join(b, on="k", how="left").where(col("y").fill_null(0).not_null())
           .sort(["k"]).to_pydict())
    assert out["k"] == [1, 2, 3]
    plan = _optimized(a.join(b, on="k", how="left").where(col("y").not_null()))
    assert all(n.how == "inner" for n in _nodes(plan) if isinstance(n, lp.Join))


# -- every rule: the same seeded plan through both packages --------------------
def _seeded(pkg, n=2_000, seed=7):
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 50, n)
    return {
        "fact": pkg.from_pydict({"k": k, "j": rng.integers(0, 20, n), "v": rng.random(n),
                                 "s": [f"s{i % 13}" for i in range(n)]}),
        "dim": pkg.from_pydict({"dk": np.arange(50), "dv": rng.random(50),
                                "dn": [None if i % 7 == 0 else i for i in range(50)]}),
        "small": pkg.from_pydict({"sk": np.arange(20), "sw": rng.random(20)}),
        "nulls": pkg.from_pydict({"nk": [None if i % 3 == 0 else i % 50 for i in range(300)],
                                  "nv": np.arange(300)}),
    }


def _rule_cases():
    def star(pkg):
        t = _seeded(pkg)
        return (t["fact"].join(t["dim"], left_on="k", right_on="dk")
                .join(t["small"], left_on="j", right_on="sk")
                .where((pkg.col("dv") > 0.5) & (pkg.col("sw") < 0.9)))

    def cross(pkg):
        t = _seeded(pkg)
        return t["fact"].cross_join(t["small"]).where(
            (pkg.col("j") == pkg.col("sk")) & (pkg.col("v") > 0.2))

    def null_filtered(pkg):
        t = _seeded(pkg)
        return t["fact"].join(t["dim"], left_on="k", right_on="dk", how="left").where(
            pkg.col("dv") > 0.1)

    def semi_pushdown(pkg):
        t = _seeded(pkg)
        keys = t["small"].where(pkg.col("sw") > 0.5).select(pkg.col("sk"))
        return (t["fact"].join(t["dim"], left_on="k", right_on="dk")
                .where(pkg.col("j").is_in(keys)).select("k", "j", "v", "dv"))

    def null_keys(pkg):
        t = _seeded(pkg)
        return t["nulls"].join(t["dim"], left_on="nk", right_on="dk")

    def simplify(pkg):
        t = _seeded(pkg)
        c = pkg.col
        return t["fact"].where(((c("v") * 1 + 0) > 0.3) & pkg.lit(True)).select(
            c("k"), (c("v") - 0).alias("v"))

    def scalar_subquery(pkg):
        t = _seeded(pkg)
        return pkg.sql("SELECT k, v FROM fact WHERE v > (SELECT avg(v) FROM fact) "
                       "AND EXISTS (SELECT 1 FROM dim WHERE dim.dk = fact.k AND dv > 0.5)",
                       fact=t["fact"], dim=t["dim"])

    def correlated(pkg):
        t = _seeded(pkg)
        return pkg.sql("SELECT k, v FROM fact f1 WHERE v < (SELECT 0.5 * avg(v) FROM fact f2 "
                       "WHERE f2.k = f1.k) AND NOT EXISTS (SELECT 1 FROM fact f3 "
                       "WHERE f3.j = f1.j AND f3.k <> f1.k)", fact=t["fact"])

    def limit_topn(pkg):
        t = _seeded(pkg)
        return t["fact"].select("k", "v").sort("v", desc=True).limit(7)

    def prune(pkg):
        t = _seeded(pkg)
        return (t["fact"].join(t["dim"], left_on="k", right_on="dk")
                .groupby("s").agg(pkg.col("dv").sum()))

    return {"star_reorder": star, "eliminate_cross_join": cross,
            "simplify_null_filtered_join": null_filtered, "push_down_semi_anti": semi_pushdown,
            "filter_null_join_key": null_keys, "simplify_expressions": simplify,
            "unnest_scalar_and_exists": scalar_subquery, "unnest_correlated": correlated,
            "push_down_limit": limit_topn, "prune_columns": prune}


RULE_CASES = _rule_cases()


@pytest.mark.parametrize("case", list(RULE_CASES))
def test_rule_plan_matches_the_jax_package(case):
    build = RULE_CASES[case]
    jdf, tdf = build(daft_tpu), build(daft_tpu_torch)
    jplan = JOptimizer().optimize(jdf._builder.plan)
    tplan = Optimizer().optimize(tdf._builder.plan)
    assert plan_signature(tplan) == plan_signature(jplan)
    jout, tout = jdf.to_pydict(), tdf.to_pydict()
    assert list(jout) == list(tout)
    order = sorted(range(len(next(iter(tout.values())))),
                   key=lambda i: tuple(repr(v[i]) for v in tout.values()))
    jorder = sorted(range(len(next(iter(jout.values())))),
                    key=lambda i: tuple(repr(v[i]) for v in jout.values()))
    for name in tout:
        assert [tout[name][i] for i in order] == [jout[name][i] for i in jorder], name


def test_parquet_rules_match_the_jax_package(tmp_path):
    """EnrichWithStats, PushDownAggregation and the scan pushdowns over the
    same files in both packages."""
    rng = np.random.default_rng(3)
    data = {"a": np.arange(400), "b": rng.random(400),
            "c": [None if i % 9 == 0 else i for i in range(400)]}
    daft_tpu_torch.from_pydict(data).write_parquet(str(tmp_path))
    for build in (lambda p, c: p.read_parquet(str(tmp_path)).agg(c("c").count().alias("n")),
                  lambda p, c: p.read_parquet(str(tmp_path)).where(c("a") > 100)
                  .select("a", "b").limit(5)):
        jdf, tdf = build(daft_tpu, daft_tpu.col), build(daft_tpu_torch, col)
        assert plan_signature(Optimizer().optimize(tdf._builder.plan)) == \
            plan_signature(JOptimizer().optimize(jdf._builder.plan))
        assert tdf.to_pydict() == jdf.to_pydict()
