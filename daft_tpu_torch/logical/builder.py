"""LogicalPlanBuilder (port of ``daft_tpu/logical/builder.py``; reference:
src/daft-logical-plan/src/builder/mod.rs:61-1240).

Thin, immutable builder over LogicalPlan nodes; the DataFrame API wraps this.
Not ported yet: the unnest/explode markers and window hoisting in ``project``,
and every builder step whose plan node is not ported (see ``logical/plan.py``).
``intersect`` / ``except_`` build their ``ALL`` form, which translation
refuses until ``Window`` is ported (ROADMAP A.3.5).
"""

from __future__ import annotations

from typing import Optional, Sequence

from daft_tpu_torch.expressions.expr import ColumnRef, Expr
from daft_tpu_torch.logical import plan as lp
from daft_tpu_torch.schema import Schema


class LogicalPlanBuilder:
    def __init__(self, plan: lp.LogicalPlan):
        self._plan = plan

    @property
    def plan(self) -> lp.LogicalPlan:
        return self._plan

    @property
    def schema(self) -> Schema:
        return self._plan.schema

    @staticmethod
    def in_memory(partitions: Sequence, schema: Schema) -> "LogicalPlanBuilder":
        return LogicalPlanBuilder(lp.InMemorySource(partitions, schema))

    @staticmethod
    def scan(scan_info) -> "LogicalPlanBuilder":
        return LogicalPlanBuilder(lp.ScanSource(scan_info, scan_info.schema))

    def project(self, exprs: Sequence[Expr]) -> "LogicalPlanBuilder":
        return LogicalPlanBuilder(lp.Project(self._plan, exprs))

    def select(self, exprs: Sequence[Expr]) -> "LogicalPlanBuilder":
        return self.project(exprs)

    def with_columns(self, exprs: Sequence[Expr]) -> "LogicalPlanBuilder":
        new_names = {e.name() for e in exprs}
        keep = [ColumnRef(f.name) for f in self.schema if f.name not in new_names]
        return self.project(keep + list(exprs))

    def filter(self, predicate: Expr) -> "LogicalPlanBuilder":
        return LogicalPlanBuilder(lp.Filter(self._plan, predicate))

    def aggregate(self, agg_exprs: Sequence[Expr], group_by: Sequence[Expr]) -> "LogicalPlanBuilder":
        return LogicalPlanBuilder(lp.Aggregate(self._plan, agg_exprs, group_by))

    def limit(self, n: int, offset: int = 0) -> "LogicalPlanBuilder":
        return LogicalPlanBuilder(lp.Limit(self._plan, n, offset))

    # -- blocking ---------------------------------------------------------
    def sort(self, sort_by: Sequence[Expr], descending: Sequence[bool],
             nulls_first: Optional[Sequence[bool]] = None) -> "LogicalPlanBuilder":
        return LogicalPlanBuilder(lp.Sort(self._plan, sort_by, descending, nulls_first))

    def distinct(self, on: Optional[Sequence[Expr]] = None) -> "LogicalPlanBuilder":
        return LogicalPlanBuilder(lp.Distinct(self._plan, on))

    # -- multi-input ------------------------------------------------------
    def concat(self, other: "LogicalPlanBuilder") -> "LogicalPlanBuilder":
        return LogicalPlanBuilder(lp.Concat([self._plan, other._plan]))

    def join(self, right: "LogicalPlanBuilder", left_on, right_on, how="inner",
             strategy=None, suffix="right.", prefix="") -> "LogicalPlanBuilder":
        return LogicalPlanBuilder(lp.Join(self._plan, right._plan, left_on, right_on,
                                          how, strategy, suffix, prefix))

    def asof_join(self, right: "LogicalPlanBuilder", left_on, right_on,
                  left_by=(), right_by=(), direction="backward",
                  suffix="right.") -> "LogicalPlanBuilder":
        return LogicalPlanBuilder(lp.AsofJoin(self._plan, right._plan, left_on, right_on,
                                              left_by, right_by, direction, suffix))

    def cross_join(self, right: "LogicalPlanBuilder", suffix="right.") -> "LogicalPlanBuilder":
        return LogicalPlanBuilder(lp.Join(self._plan, right._plan, [], [], "cross", None, suffix))

    def intersect(self, right: "LogicalPlanBuilder", is_all=False) -> "LogicalPlanBuilder":
        return LogicalPlanBuilder(lp.Intersect(self._plan, right._plan, is_all))

    def except_(self, right: "LogicalPlanBuilder", is_all=False) -> "LogicalPlanBuilder":
        return LogicalPlanBuilder(lp.Except(self._plan, right._plan, is_all))

    def table_write(self, write_info) -> "LogicalPlanBuilder":
        return LogicalPlanBuilder(lp.Sink(self._plan, write_info))

    def optimize(self) -> "LogicalPlanBuilder":
        from daft_tpu_torch.logical.optimizer import Optimizer

        return LogicalPlanBuilder(Optimizer().optimize(self._plan))
