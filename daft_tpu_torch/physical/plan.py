"""Local physical plan nodes (port of ``daft_tpu/physical/plan.py``).

Reference: ``LocalPhysicalPlan`` (src/daft-local-plan/src/plan.rs:74-133). Each
node maps 1:1 onto an operator of ``execution/executor.py``. The port has
``InMemorySource``, ``Project``, ``UDFProject``, ``Filter``, ``Limit`` and
``Aggregate`` (global and grouped); the other nodes wait for their logical counterparts
(see ``logical/plan.py``).
"""

from __future__ import annotations

from typing import List, Sequence

from daft_tpu_torch.schema import Schema


class PhysicalPlan:
    def __init__(self, children: Sequence["PhysicalPlan"], schema: Schema):
        self.children = list(children)
        self.schema = schema

    def name(self) -> str:
        return type(self).__name__

    def repr_indent(self, level: int = 0) -> str:
        pad = "  " * level
        lines = [pad + ("* " if level == 0 else "|- ") + self.describe()]
        for c in self.children:
            lines.append(c.repr_indent(level + 1))
        return "\n".join(lines)

    def describe(self) -> str:
        return self.name()

    def __repr__(self) -> str:
        return self.repr_indent()


class InMemorySource(PhysicalPlan):
    def __init__(self, partitions: List, schema: Schema):
        super().__init__([], schema)
        self.partitions = partitions

    def describe(self):
        return f"InMemorySource[{len(self.partitions)}]"


class Project(PhysicalPlan):
    def __init__(self, child: PhysicalPlan, exprs, schema: Schema):
        super().__init__([child], schema)
        self.exprs = exprs


class UDFProject(PhysicalPlan):
    def __init__(self, child: PhysicalPlan, udf_expr, passthrough, schema: Schema):
        super().__init__([child], schema)
        self.udf_expr = udf_expr
        self.passthrough = passthrough

    def describe(self):
        return f"UDFProject[{self.udf_expr!r}]"


class Limit(PhysicalPlan):
    def __init__(self, child: PhysicalPlan, limit: int, offset: int = 0):
        super().__init__([child], child.schema)
        self.limit = limit
        self.offset = offset


class Filter(PhysicalPlan):
    def __init__(self, child: PhysicalPlan, predicate):
        super().__init__([child], child.schema)
        self.predicate = predicate


class Aggregate(PhysicalPlan):
    def __init__(self, child: PhysicalPlan, agg_exprs, group_by, schema: Schema):
        super().__init__([child], schema)
        self.agg_exprs = agg_exprs
        self.group_by = group_by

    def describe(self):
        return f"Aggregate[{len(self.agg_exprs)} aggs, {len(self.group_by)} keys]"
