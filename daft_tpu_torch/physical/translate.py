"""Logical → local physical plan translation (port of
``daft_tpu/physical/translate.py``; reference: src/daft-local-plan/src/translate.rs).

Translation is memoized on the logical node's identity, so a subtree that
two parents share (a decorrelated subquery's) becomes ONE physical node,
which the executor runs once (``physical/plan.shared_subtree_ids``).
Intersect/Except lower to distinct + semi/anti joins, matching the
reference's logical rewrites; their ``ALL`` form tags each row with its
occurrence number through a ``row_number`` window first. Not ported yet: the
feedback plane's estimate stamping and ``Shard`` (A.8).
"""

from __future__ import annotations

from daft_tpu_torch.errors import DaftPlanError
from daft_tpu_torch.expressions.expr import ColumnRef
from daft_tpu_torch.logical import plan as lp
from daft_tpu_torch.physical import plan as pp


def translate(node: lp.LogicalPlan, _memo=None) -> pp.PhysicalPlan:
    if _memo is None:
        _memo = {}
    hit = _memo.get(id(node))
    if hit is not None:
        return hit[1]
    out = _translate_one(node, _memo)
    # The entry holds the logical node too: a node built during translation
    # (Intersect's join) must outlive the memo, or its id could be reused.
    _memo[id(node)] = (node, out)
    return out


def _translate_one(node: lp.LogicalPlan, _memo) -> pp.PhysicalPlan:
    def t(n):
        return translate(n, _memo)

    if isinstance(node, lp.InMemorySource):
        return pp.InMemorySource(node.partitions, node.schema)
    if isinstance(node, lp.ScanSource):
        from daft_tpu_torch.context import get_context

        tasks = node.scan_info.to_scan_tasks(node.pushdowns, get_context().execution_config)
        return pp.PhysicalScan(tasks, node.schema)
    if isinstance(node, lp.Project):
        return pp.Project(t(node.children()[0]), node.exprs, node.schema)
    if isinstance(node, lp.UDFProject):
        return pp.UDFProject(t(node.children()[0]), node.udf_expr,
                             node.passthrough, node.schema)
    if isinstance(node, lp.Filter):
        return pp.Filter(t(node.children()[0]), node.predicate)
    if isinstance(node, lp.Explode):
        return pp.Explode(t(node.children()[0]), node.to_explode, node.schema,
                          node.ignore_empty_and_null)
    if isinstance(node, lp.Unpivot):
        return pp.Unpivot(t(node.children()[0]), node.ids, node.values,
                          node.variable_name, node.value_name, node.schema)
    if isinstance(node, lp.Sample):
        return pp.Sample(t(node.children()[0]), node.fraction, node.size,
                         node.with_replacement, node.seed)
    if isinstance(node, lp.MonotonicallyIncreasingId):
        return pp.MonotonicallyIncreasingId(t(node.children()[0]), node.column_name,
                                            node.schema)
    if isinstance(node, lp.Aggregate):
        return pp.Aggregate(t(node.children()[0]), node.agg_exprs, node.group_by,
                            node.schema)
    if isinstance(node, lp.Pivot):
        return pp.Pivot(t(node.children()[0]), node.group_by, node.pivot_col,
                        node.value_col, node.agg_fn, node.names, node.schema)
    if isinstance(node, lp.Limit):
        return pp.Limit(t(node.children()[0]), node.limit, node.offset)
    if isinstance(node, lp.TopN):
        return pp.TopN(t(node.children()[0]), node.sort_by, node.descending,
                       node.nulls_first, node.limit, node.offset)
    if isinstance(node, lp.Sort):
        return pp.Sort(t(node.children()[0]), node.sort_by, node.descending,
                       node.nulls_first)
    if isinstance(node, lp.Distinct):
        return pp.Distinct(t(node.children()[0]), node.on)
    if isinstance(node, lp.Window):
        return pp.Window(t(node.children()[0]), node.window_exprs, node.schema)
    if isinstance(node, lp.Concat):
        return pp.Concat([t(c) for c in node.children()], node.schema)
    if isinstance(node, lp.Join):
        left, right = node.children()
        if node.how == "cross":
            return pp.CrossJoin(t(left), t(right), node.schema, node.suffix)
        merged = {
            r.name() for l, r in zip(node.left_on, node.right_on)
            if isinstance(l, ColumnRef) and isinstance(r, ColumnRef) and l.name_ == r.name_
        }
        return pp.HashJoin(t(left), t(right), node.left_on, node.right_on,
                           node.how, node.schema, f"{node.prefix}{node.suffix}", merged,
                           node.strategy)
    if isinstance(node, lp.AsofJoin):
        left, right = node.children()
        return pp.AsofJoin(t(left), t(right), node.left_on, node.right_on,
                           node.left_by, node.right_by, node.direction,
                           node.schema, node.suffix)
    if isinstance(node, (lp.Intersect, lp.Except)):
        # Distinct form: (semi|anti) join of the deduplicated left against
        # the right. ALL form (SQL INTERSECT ALL / EXCEPT ALL multiset
        # semantics): tag every row on both sides with its occurrence number
        # within its value group, then (semi|anti) join on (values, occ) —
        # per value v, min(l,r) copies match and max(l-r, 0) don't.
        how = "semi" if isinstance(node, lp.Intersect) else "anti"
        left, right = node.children()
        keys = [ColumnRef(n) for n in left.schema.column_names()]
        if not node.is_all:
            return t(lp.Join(lp.Distinct(left), right, keys, keys, how))
        from daft_tpu_torch.expressions.expr import Alias, WindowExpr

        occ = "__occurrence"
        names = set(left.schema.column_names())
        while occ in names:
            occ += "_"

        def tagged(side):
            rn = WindowExpr("row_number", None, tuple(keys), (), ())
            return lp.Window(side, [Alias(rn, occ)])

        join_keys = keys + [ColumnRef(occ)]
        join = lp.Join(tagged(left), lp.Project(tagged(right), join_keys),
                       join_keys, join_keys, how)
        return t(lp.Project(join, keys))
    if isinstance(node, lp.Repartition):
        return pp.Repartition(t(node.children()[0]), node.scheme)
    if isinstance(node, lp.Sink):
        return pp.Write(t(node.children()[0]), node.write_info, node.schema)
    raise DaftPlanError(f"Cannot translate logical node {node.name()}")
