"""Logical plan nodes (port of ``daft_tpu/logical/plan.py``).

Reference: the ``LogicalPlan`` enum (src/daft-logical-plan/src/logical_plan.rs:35-66).
Nodes are immutable; the output schema is resolved at construction so schema
errors surface at build time. The port has ``InMemorySource``, ``Project``,
``UDFProject``, ``Filter``, ``Limit`` and ``Aggregate`` (global and grouped).
Not ported yet: ``ScanSource``,
``Sample``, ``Explode``, ``Unpivot``, ``MonotonicallyIncreasingId``, ``Sort``,
``TopN``, ``Pivot``, ``Distinct``, ``Window``, ``Concat``,
``Join``, ``AsofJoin``, ``Intersect``/``Except``, ``Repartition``, ``Shard``,
``Sink``, and the cardinality estimates (``approx_stats``) that the
optimizer's join ordering reads.
"""

from __future__ import annotations

from typing import List, Sequence

from daft_tpu_torch.errors import (
    DaftPlanError,
    DaftTypeError,
    DaftValueError,
)
from daft_tpu_torch.expressions.evaluator import resolve_schema
from daft_tpu_torch.expressions.expr import Expr, UdfCall
from daft_tpu_torch.schema import Schema


class LogicalPlan:
    """Base logical plan node."""

    def __init__(self, children: Sequence["LogicalPlan"], schema: Schema):
        self._children = list(children)
        self._schema = schema

    @property
    def schema(self) -> Schema:
        return self._schema

    def children(self) -> List["LogicalPlan"]:
        return list(self._children)

    def with_children(self, children: Sequence["LogicalPlan"]) -> "LogicalPlan":
        raise NotImplementedError

    def name(self) -> str:
        return type(self).__name__

    def multiline_display(self) -> List[str]:
        return [self.name()]

    def repr_indent(self, level: int = 0) -> str:
        pad = "  " * level
        lines = [pad + ("* " if level == 0 else "|- ") + "; ".join(self.multiline_display())]
        for c in self._children:
            lines.append(c.repr_indent(level + 1))
        return "\n".join(lines)

    def __repr__(self) -> str:
        return self.repr_indent()

    def walk(self):
        yield self
        for c in self._children:
            yield from c.walk()


class InMemorySource(LogicalPlan):
    """Materialised partitions already in memory (reference:
    LogicalPlan::Source with InMemory scan info, ops/source.rs)."""

    def __init__(self, partitions: Sequence, schema: Schema):
        super().__init__([], schema)
        self.partitions = list(partitions)

    def with_children(self, children):
        assert not children
        return self

    def multiline_display(self):
        return [f"InMemorySource: {len(self.partitions)} partitions"]


class Project(LogicalPlan):
    def __init__(self, input: LogicalPlan, exprs: Sequence[Expr]):
        self.exprs = list(exprs)
        super().__init__([input], resolve_schema(self.exprs, input.schema))

    def with_children(self, children):
        return Project(children[0], self.exprs)

    def multiline_display(self):
        return [f"Project: {', '.join(repr(e) for e in self.exprs[:6])}{'...' if len(self.exprs) > 6 else ''}"]


class UDFProject(LogicalPlan):
    """An isolated UDF projection (reference: optimizer rule SplitUDFs +
    ops/udf_project — gives the executor a dedicated operator that batches
    for the UDF)."""

    def __init__(self, input: LogicalPlan, udf_expr: Expr, passthrough: Sequence[Expr]):
        self.udf_expr = udf_expr
        self.passthrough = list(passthrough)
        schema = resolve_schema(self.passthrough + [udf_expr], input.schema)
        super().__init__([input], schema)

    def with_children(self, children):
        return UDFProject(children[0], self.udf_expr, self.passthrough)

    def udf(self):
        for node in self.udf_expr.walk():
            if isinstance(node, UdfCall):
                return node.udf
        raise DaftPlanError("UDFProject without UdfCall")

    def multiline_display(self):
        return [f"UDFProject: {self.udf_expr!r}"]


class Limit(LogicalPlan):
    def __init__(self, input: LogicalPlan, limit: int, offset: int = 0):
        self.limit = limit
        self.offset = offset
        super().__init__([input], input.schema)

    def with_children(self, children):
        return Limit(children[0], self.limit, self.offset)

    def multiline_display(self):
        return [f"Limit: {self.limit}" + (f" offset {self.offset}" if self.offset else "")]


class Filter(LogicalPlan):
    def __init__(self, input: LogicalPlan, predicate: Expr):
        pf = predicate.to_field(input.schema)
        if not pf.dtype.is_boolean() and not pf.dtype.is_null():
            raise DaftTypeError(f"Filter predicate must be Boolean, got {pf.dtype!r}")
        self.predicate = predicate
        super().__init__([input], input.schema)

    def with_children(self, children):
        return Filter(children[0], self.predicate)

    def multiline_display(self):
        return [f"Filter: {self.predicate!r}"]


class Aggregate(LogicalPlan):
    """Aggregation, global or by ``group_by``: the schema is the key fields
    followed by the aggregation fields."""

    def __init__(self, input: LogicalPlan, agg_exprs: Sequence[Expr], group_by: Sequence[Expr]):
        self.agg_exprs = list(agg_exprs)
        self.group_by = list(group_by)
        for e in self.agg_exprs:
            if not e.has_agg():
                raise DaftValueError(f"Aggregate expression {e!r} contains no aggregation")
        fields = [g.to_field(input.schema) for g in self.group_by]
        fields += [e.to_field(input.schema) for e in self.agg_exprs]
        super().__init__([input], Schema(fields))

    def with_children(self, children):
        return Aggregate(children[0], self.agg_exprs, self.group_by)

    def multiline_display(self):
        return [f"Aggregate: {[e.name() for e in self.agg_exprs]} "
                f"groupby={[g.name() for g in self.group_by]}"]
