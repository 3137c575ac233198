"""Logical → local physical plan translation (port of
``daft_tpu/physical/translate.py``; reference: src/daft-local-plan/src/translate.rs).

Not ported yet: the feedback plane's estimate stamping and every node this
slice leaves out (see ``logical/plan.py``).
"""

from __future__ import annotations

from daft_tpu_torch.errors import DaftPlanError
from daft_tpu_torch.logical import plan as lp
from daft_tpu_torch.physical import plan as pp


def translate(node: lp.LogicalPlan) -> pp.PhysicalPlan:
    if isinstance(node, lp.InMemorySource):
        return pp.InMemorySource(node.partitions, node.schema)
    if isinstance(node, lp.Project):
        return pp.Project(translate(node.children()[0]), node.exprs, node.schema)
    if isinstance(node, lp.UDFProject):
        return pp.UDFProject(translate(node.children()[0]), node.udf_expr,
                             node.passthrough, node.schema)
    if isinstance(node, lp.Filter):
        return pp.Filter(translate(node.children()[0]), node.predicate)
    if isinstance(node, lp.Aggregate):
        return pp.Aggregate(translate(node.children()[0]), node.agg_exprs, node.group_by,
                            node.schema)
    if isinstance(node, lp.Limit):
        return pp.Limit(translate(node.children()[0]), node.limit, node.offset)
    raise DaftPlanError(f"Cannot translate logical node {node.name()}")
