"""Logical plan optimizer (port of ``daft_tpu/logical/optimizer.py``).

Reference: src/daft-logical-plan/src/optimization/optimizer.rs:127-280 — an
ordered list of rule batches, each run to fixed point. The port has two
rules, in the JAX package's batch order: SplitUDFs, which isolates UDF calls
into UDFProject nodes so the executor runs them in their own operator
(reference: rules/split_udfs.rs), and PushDownLimit, which composes limits,
moves a limit below a projection and fuses a sort with the limit above it
into a TopN (its scan case waits for the scan, ROADMAP A.3). Not ported yet
(A.3): SimplifyExpressions, UnnestSubqueries, DetectMonotonicId,
PushDownFilter, PushDownSemiAnti, PushDownShard, DropRepartition,
EnrichWithStats, PushDownAggregation, FilterNullJoinKey, ReorderJoins,
PushDownProjection and the final column pruning. A join therefore builds on
the right side as the user wrote it.
"""

from __future__ import annotations

from typing import List, Optional

from daft_tpu_torch.expressions.expr import Alias, ColumnRef, Expr, UdfCall
from daft_tpu_torch.logical import plan as lp


class Rule:
    name = "rule"

    def rewrite(self, node: lp.LogicalPlan) -> Optional[lp.LogicalPlan]:
        """Return a replacement for this node, or None to keep it."""
        raise NotImplementedError


def _rewrite_bottom_up(node: lp.LogicalPlan, rule: Rule) -> lp.LogicalPlan:
    new_children = [_rewrite_bottom_up(c, rule) for c in node.children()]
    if any(a is not b for a, b in zip(new_children, node.children())):
        node = node.with_children(new_children)
    replaced = rule.rewrite(node)
    return replaced if replaced is not None else node


class Optimizer:
    MAX_PASSES = 24

    def __init__(self):
        self.batches: List[List[Rule]] = [[SplitUDFs()], [PushDownLimit()]]

    def optimize(self, plan: lp.LogicalPlan) -> lp.LogicalPlan:
        for batch in self.batches:
            for _ in range(self.MAX_PASSES):
                changed = False
                for rule in batch:
                    new_plan = _rewrite_bottom_up(plan, rule)
                    if new_plan is not plan:
                        plan = new_plan
                        changed = True
                if not changed:
                    break
        return plan


class SplitUDFs(Rule):
    """Project with UDF calls → chain of UDFProject nodes + final Project.

    Reference: rules/split_udfs.rs — isolating each expensive UDF into its own
    operator is what enables batching/backpressure/accelerator placement.
    """

    name = "SplitUDFs"

    def rewrite(self, node):
        if not isinstance(node, lp.Project):
            return None
        if not any(e.has_udf() for e in node.exprs):
            return None
        base = node.children()[0]
        final_exprs: List[Expr] = []
        counter = 0
        for e in node.exprs:
            if not e.has_udf():
                final_exprs.append(e)
                continue

            # Hoist every UdfCall subtree into its own UDFProject.
            def hoist(n: Expr):
                nonlocal base, counter
                if isinstance(n, UdfCall):
                    tmp = f"__udf_{counter}"
                    counter += 1
                    passthrough = [ColumnRef(f.name) for f in base.schema]
                    base = lp.UDFProject(base, Alias(n, tmp), passthrough)
                    return ColumnRef(tmp)
                return None

            rewritten = e.transform(hoist)
            final_exprs.append(Alias(rewritten, e.name()) if rewritten.name() != e.name() else rewritten)
        return lp.Project(base, final_exprs)


class PushDownLimit(Rule):
    name = "PushDownLimit"

    def rewrite(self, node):
        if not isinstance(node, lp.Limit):
            return None
        child = node.children()[0]
        if isinstance(child, lp.Limit):
            # Compose: inner yields [o_in, o_in+l_in); outer takes [o_out, o_out+l_out)
            # of that -> offset o_in+o_out, limit min(l_out, l_in - o_out).
            new_limit = max(0, min(node.limit, child.limit - node.offset))
            return lp.Limit(child.children()[0], new_limit, node.offset + child.offset)
        if isinstance(child, (lp.Project,)):
            return child.with_children([lp.Limit(child.children()[0], node.limit, node.offset)])
        if isinstance(child, lp.Sort):
            return lp.TopN(child.children()[0], child.sort_by, child.descending,
                           child.nulls_first, node.limit, node.offset)
        return None
