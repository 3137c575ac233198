"""LogicalPlanBuilder (port of ``daft_tpu/logical/builder.py``; reference:
src/daft-logical-plan/src/builder/mod.rs:61-1240).

Thin, immutable builder over LogicalPlan nodes; the DataFrame API wraps this.
Not ported yet: the unnest/explode markers and window hoisting in ``project``,
and every builder step whose plan node is not ported (see ``logical/plan.py``).
"""

from __future__ import annotations

from typing import Sequence

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

    def project(self, exprs: Sequence[Expr]) -> "LogicalPlanBuilder":
        return LogicalPlanBuilder(lp.Project(self._plan, exprs))

    def select(self, exprs: Sequence[Expr]) -> "LogicalPlanBuilder":
        return self.project(exprs)

    def with_columns(self, exprs: Sequence[Expr]) -> "LogicalPlanBuilder":
        new_names = {e.name() for e in exprs}
        keep = [ColumnRef(f.name) for f in self.schema if f.name not in new_names]
        return self.project(keep + list(exprs))

    def limit(self, n: int, offset: int = 0) -> "LogicalPlanBuilder":
        return LogicalPlanBuilder(lp.Limit(self._plan, n, offset))

    def optimize(self) -> "LogicalPlanBuilder":
        from daft_tpu_torch.logical.optimizer import Optimizer

        return LogicalPlanBuilder(Optimizer().optimize(self._plan))
