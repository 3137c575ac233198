"""Logical → local physical plan translation (port of
``daft_tpu/physical/translate.py``; reference: src/daft-local-plan/src/translate.rs).

Translation is memoized on the logical node's identity, so a subtree that
two parents share (a decorrelated subquery's) becomes ONE physical node,
which the executor runs once (``physical/plan.shared_subtree_ids``).
Intersect/Except lower to distinct + semi/anti joins, matching the
reference's logical rewrites; their ``ALL`` form needs ``Window`` and raises.
Not ported yet: the feedback plane's estimate stamping (A.8) and every node
the port leaves out (see ``logical/plan.py``).
"""

from __future__ import annotations

from daft_tpu_torch.errors import DaftNotImplementedError, DaftPlanError
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
    if isinstance(node, lp.Aggregate):
        return pp.Aggregate(t(node.children()[0]), node.agg_exprs, node.group_by,
                            node.schema)
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
        # the right.
        how = "semi" if isinstance(node, lp.Intersect) else "anti"
        if node.is_all:
            raise DaftNotImplementedError(
                f"{node.name().upper()} ALL tags each row with its occurrence number through "
                f"a row_number Window, which the port has not yet (ROADMAP A.3.5)")
        left, right = node.children()
        keys = [ColumnRef(n) for n in left.schema.column_names()]
        return t(lp.Join(lp.Distinct(left), right, keys, keys, how))
    if isinstance(node, lp.Sink):
        return pp.Write(t(node.children()[0]), node.write_info, node.schema)
    raise DaftPlanError(f"Cannot translate logical node {node.name()}")
