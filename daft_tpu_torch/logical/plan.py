"""Logical plan nodes (port of ``daft_tpu/logical/plan.py``).

Reference: the ``LogicalPlan`` enum (src/daft-logical-plan/src/logical_plan.rs:35-66).
Nodes are immutable; the output schema is resolved at construction so schema
errors surface at build time. The port has ``InMemorySource``, ``Project``,
``UDFProject``, ``Filter``, ``Limit``, ``Aggregate`` (global and grouped),
``Sort``, ``TopN``, ``Distinct``, ``Concat``, ``Intersect``/``Except``,
``Join``, ``AsofJoin``, ``ScanSource`` (file scans and ``DataSource``
plugins, with their pushdowns), ``Sink`` (file writes), ``Sample``,
``Explode``, ``Unpivot``, ``MonotonicallyIncreasingId``, ``Pivot``,
``Window`` and ``Repartition``. Not ported yet: ``Shard`` (ROADMAP A.8).
Every node has ``approx_stats``, the cardinality estimate that the
optimizer's join ordering reads; the feedback plane's observed
cardinalities, which override it in the JAX package, are not ported (A.8).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from daft_tpu_torch.datatype import DataType, unify_dtypes
from daft_tpu_torch.errors import (
    DaftPlanError,
    DaftSchemaError,
    DaftTypeError,
    DaftValueError,
)
from daft_tpu_torch.expressions.evaluator import resolve_schema
from daft_tpu_torch.expressions.expr import AggOp, ColumnRef, Expr, UdfCall
from daft_tpu_torch.schema import Field, Schema
from daft_tpu_torch.stats import ApproxStats


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

    def approx_stats(self) -> ApproxStats:
        """Cardinality estimate used by join ordering (reference:
        src/daft-logical-plan/src/stats.rs)."""
        return self._approx_stats()

    def _approx_stats(self) -> ApproxStats:
        if self._children:
            return self._children[0].approx_stats()
        return ApproxStats()

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

    def _approx_stats(self) -> ApproxStats:
        rows = sum(len(p) for p in self.partitions)
        size = sum(p.size_bytes() for p in self.partitions)
        return ApproxStats(rows, size)


class ScanSource(LogicalPlan):
    """A file-based scan (reference: LogicalPlan::Source + daft-scan ScanTask,
    src/daft-scan/src/lib.rs:350-378). Carries pushdowns set by the
    optimizer: projection, filter, limit, sharding."""

    def __init__(self, scan_info, schema: Schema, pushdowns=None):
        super().__init__([], schema)
        self.scan_info = scan_info
        from daft_tpu_torch.io.scan import Pushdowns

        self.pushdowns = pushdowns or Pushdowns()

    def with_children(self, children):
        assert not children
        return self

    def with_pushdowns(self, pushdowns) -> "ScanSource":
        schema = self._schema
        if pushdowns.columns is not None:
            schema = self._schema.select(pushdowns.columns)
        return ScanSource(self.scan_info, schema, pushdowns)

    def multiline_display(self):
        out = [f"ScanSource: {self.scan_info.display_name()}"]
        if self.pushdowns.columns is not None:
            out.append(f"Projection pushdown = {self.pushdowns.columns}")
        if self.pushdowns.filters is not None:
            out.append(f"Filter pushdown = {self.pushdowns.filters!r}")
        if self.pushdowns.limit is not None:
            out.append(f"Limit pushdown = {self.pushdowns.limit}")
        return out

    def _approx_stats(self) -> ApproxStats:
        stats = ApproxStats(*self.scan_info.estimate_rows_bytes())
        if self.pushdowns.limit is not None and stats.num_rows > self.pushdowns.limit:
            stats = stats.scaled(self.pushdowns.limit / max(stats.num_rows, 1))
        if self.pushdowns.filters is not None:
            from daft_tpu_torch.stats import estimate_selectivity

            stats = stats.scaled(estimate_selectivity(self.pushdowns.filters))
        return stats


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

    def _approx_stats(self) -> ApproxStats:
        s = self._children[0].approx_stats()
        if s.num_rows > self.limit:
            return s.scaled(self.limit / max(s.num_rows, 1))
        return s


class Sample(LogicalPlan):
    def __init__(self, input: LogicalPlan, fraction: Optional[float] = None,
                 size: Optional[int] = None, with_replacement: bool = False,
                 seed: Optional[int] = None):
        self.fraction = fraction
        self.size = size
        self.with_replacement = with_replacement
        self.seed = seed
        super().__init__([input], input.schema)

    def with_children(self, children):
        return Sample(children[0], self.fraction, self.size, self.with_replacement, self.seed)


class Explode(LogicalPlan):
    def __init__(self, input: LogicalPlan, to_explode: Sequence[Expr],
                 ignore_empty_and_null: bool = False):
        self.to_explode = list(to_explode)
        self.ignore_empty_and_null = ignore_empty_and_null
        explode_names = {e.name() for e in self.to_explode}
        fields = []
        for f in input.schema:
            if f.name in explode_names:
                if not f.dtype.is_list():
                    raise DaftTypeError(f"Cannot explode non-list column {f.name!r} ({f.dtype!r})")
                fields.append(Field(f.name, f.dtype.inner))
            else:
                fields.append(f)
        super().__init__([input], Schema(fields))

    def with_children(self, children):
        return Explode(children[0], self.to_explode, self.ignore_empty_and_null)

    def multiline_display(self):
        return [f"Explode: {[e.name() for e in self.to_explode]}"]


class Unpivot(LogicalPlan):
    def __init__(self, input: LogicalPlan, ids: Sequence[Expr], values: Sequence[Expr],
                 variable_name: str = "variable", value_name: str = "value"):
        self.ids = list(ids)
        self.values = list(values)
        self.variable_name = variable_name
        self.value_name = value_name
        if not self.values:
            raise DaftValueError("unpivot requires at least one value column")
        val_dtype = DataType.null()
        for v in self.values:
            val_dtype = unify_dtypes(val_dtype, v.to_field(input.schema).dtype)
        fields = [e.to_field(input.schema) for e in self.ids]
        fields.append(Field(variable_name, DataType.string()))
        fields.append(Field(value_name, val_dtype))
        super().__init__([input], Schema(fields))

    def with_children(self, children):
        return Unpivot(children[0], self.ids, self.values, self.variable_name, self.value_name)


class MonotonicallyIncreasingId(LogicalPlan):
    """Adds a 64-bit id column: high bits = partition index, low bits = row
    index within partition (reference: ops/monotonically_increasing_id.rs)."""

    def __init__(self, input: LogicalPlan, column_name: str = "id"):
        self.column_name = column_name
        fields = [Field(column_name, DataType.uint64())] + input.schema.fields()
        super().__init__([input], Schema(fields))

    def with_children(self, children):
        return MonotonicallyIncreasingId(children[0], self.column_name)


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

    def _approx_stats(self) -> ApproxStats:
        from daft_tpu_torch.stats import estimate_selectivity

        return self._children[0].approx_stats().scaled(estimate_selectivity(self.predicate))


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

    def _approx_stats(self) -> ApproxStats:
        s = self._children[0].approx_stats()
        if not self.group_by:
            return ApproxStats(1, 1024)
        return s.scaled(0.1)


class Pivot(LogicalPlan):
    def __init__(self, input: LogicalPlan, group_by: Sequence[Expr], pivot_col: Expr,
                 value_col: Expr, agg_fn: str, names: Sequence[str]):
        self.group_by = list(group_by)
        self.pivot_col = pivot_col
        self.value_col = value_col
        self.agg_fn = agg_fn
        self.names = list(names)
        fields = [g.to_field(input.schema) for g in self.group_by]
        vf = AggOp(agg_fn, value_col).to_field(input.schema)
        fields += [Field(n, vf.dtype) for n in self.names]
        super().__init__([input], Schema(fields))

    def with_children(self, children):
        return Pivot(children[0], self.group_by, self.pivot_col, self.value_col, self.agg_fn,
                     self.names)


class Sort(LogicalPlan):
    def __init__(self, input: LogicalPlan, sort_by: Sequence[Expr],
                 descending: Sequence[bool], nulls_first: Optional[Sequence[bool]] = None):
        self.sort_by = list(sort_by)
        self.descending = list(descending)
        self.nulls_first = list(nulls_first) if nulls_first is not None else list(descending)
        for e in self.sort_by:
            f = e.to_field(input.schema)
            if not f.dtype.is_comparable():
                raise DaftTypeError(f"Cannot sort by {f.dtype!r}")
        super().__init__([input], input.schema)

    def with_children(self, children):
        return Sort(children[0], self.sort_by, self.descending, self.nulls_first)

    def multiline_display(self):
        return [f"Sort: {[e.name() for e in self.sort_by]} desc={self.descending}"]


class TopN(LogicalPlan):
    """Sort + limit fused (reference: ops/top_n.rs)."""

    def __init__(self, input: LogicalPlan, sort_by: Sequence[Expr], descending: Sequence[bool],
                 nulls_first: Sequence[bool], limit: int, offset: int = 0):
        self.sort_by = list(sort_by)
        self.descending = list(descending)
        self.nulls_first = list(nulls_first)
        self.limit = limit
        self.offset = offset
        super().__init__([input], input.schema)

    def with_children(self, children):
        return TopN(children[0], self.sort_by, self.descending, self.nulls_first, self.limit, self.offset)


class Distinct(LogicalPlan):
    def __init__(self, input: LogicalPlan, on: Optional[Sequence[Expr]] = None):
        self.on = list(on) if on else None
        super().__init__([input], input.schema)

    def with_children(self, children):
        return Distinct(children[0], self.on)


class Window(LogicalPlan):
    def __init__(self, input: LogicalPlan, window_exprs: Sequence[Expr]):
        self.window_exprs = list(window_exprs)
        out_fields = input.schema.fields() + [e.to_field(input.schema) for e in self.window_exprs]
        super().__init__([input], Schema(out_fields))

    def with_children(self, children):
        return Window(children[0], self.window_exprs)


class Concat(LogicalPlan):
    def __init__(self, inputs: Sequence[LogicalPlan]):
        first = inputs[0].schema
        for other in inputs[1:]:
            if other.schema.column_names() != first.column_names():
                raise DaftSchemaError(
                    f"Cannot concat differing schemas: {first!r} vs {other.schema!r}"
                )
        super().__init__(list(inputs), first)

    def with_children(self, children):
        return Concat(children)

    def _approx_stats(self) -> ApproxStats:
        stats = [c.approx_stats() for c in self._children]
        return ApproxStats(sum(s.num_rows for s in stats), sum(s.size_bytes for s in stats))


class Intersect(LogicalPlan):
    def __init__(self, left: LogicalPlan, right: LogicalPlan, is_all: bool = False):
        self.is_all = is_all
        super().__init__([left, right], left.schema)

    def with_children(self, children):
        return Intersect(children[0], children[1], self.is_all)


class Except(LogicalPlan):
    def __init__(self, left: LogicalPlan, right: LogicalPlan, is_all: bool = False):
        self.is_all = is_all
        super().__init__([left, right], left.schema)

    def with_children(self, children):
        return Except(children[0], children[1], self.is_all)


class Join(LogicalPlan):
    def __init__(self, left: LogicalPlan, right: LogicalPlan,
                 left_on: Sequence[Expr], right_on: Sequence[Expr], how: str = "inner",
                 strategy: Optional[str] = None, suffix: str = "right.", prefix: str = ""):
        if how not in ("inner", "left", "right", "outer", "semi", "anti", "cross"):
            raise DaftValueError(f"Unknown join type {how}")
        if strategy not in (None, "auto", "hash", "broadcast", "sort_merge", "cross"):
            raise DaftValueError(f"Unknown join strategy {strategy!r}")
        if strategy == "broadcast" and how in ("right", "outer"):
            raise DaftValueError(
                f"broadcast strategy cannot preserve unmatched build-side rows "
                f"for {how!r} joins; use hash"
            )
        self.left_on = list(left_on)
        self.right_on = list(right_on)
        self.how = how
        self.strategy = strategy  # None=auto | hash | broadcast | sort_merge | cross
        self.suffix = suffix
        self.prefix = prefix
        if len(self.left_on) != len(self.right_on):
            raise DaftValueError("join requires equal numbers of left/right keys")
        if how != "cross" and not self.left_on:
            raise DaftValueError(f"{how} join requires at least one key")
        # Resolve keys eagerly so bad column names fail at plan time.
        for e in self.left_on:
            e.to_field(left.schema)
        for e in self.right_on:
            e.to_field(right.schema)
        fields = list(left.schema.fields())
        if how not in ("semi", "anti"):
            # Right-side join keys with identical names merge into the left key.
            merged = {
                r.name() for l, r in zip(self.left_on, self.right_on)
                if isinstance(l, ColumnRef) and isinstance(r, ColumnRef) and l.name_ == r.name_
            } if how != "cross" else set()
            # A merged key's output dtype unifies both sides (an all-null
            # left key against an int64 right key resolves int64, not null —
            # the execution-time join casts keys the same way).
            if merged:
                right_types = {f.name: f.dtype for f in right.schema}
                for i, f in enumerate(fields):
                    if f.name in merged and f.name in right_types:
                        fields[i] = Field(f.name, unify_dtypes(
                            f.dtype, right_types[f.name]))
            left_names = set(left.schema.column_names())
            for f in right.schema:
                if f.name in merged:
                    continue
                if f.name in left_names:
                    fields.append(f.rename(f"{prefix}{suffix}{f.name}"))
                else:
                    fields.append(f)
        super().__init__([left, right], Schema(fields))

    def with_children(self, children):
        return Join(children[0], children[1], self.left_on, self.right_on, self.how,
                    self.strategy, self.suffix, self.prefix)

    def multiline_display(self):
        return [f"Join[{self.how}]: on {[e.name() for e in self.left_on]}"]

    def _approx_stats(self) -> ApproxStats:
        l = self._children[0].approx_stats()
        r = self._children[1].approx_stats()
        return ApproxStats(max(l.num_rows, r.num_rows), l.size_bytes + r.size_bytes)


class AsofJoin(LogicalPlan):
    """Nearest-key join (reference: asof join in the local execution joins)."""

    def __init__(self, left: LogicalPlan, right: LogicalPlan, left_on: Expr, right_on: Expr,
                 left_by: Sequence[Expr] = (), right_by: Sequence[Expr] = (),
                 direction: str = "backward", suffix: str = "right."):
        self.left_on = left_on
        self.right_on = right_on
        self.left_by = list(left_by)
        self.right_by = list(right_by)
        self.direction = direction
        self.suffix = suffix
        if direction not in ("backward", "forward"):
            raise DaftValueError(
                f"asof direction must be 'backward' or 'forward', got {direction!r}"
            )
        lf = left_on.to_field(left.schema)
        rf = right_on.to_field(right.schema)
        if not lf.dtype.is_comparable() or not rf.dtype.is_comparable():
            raise DaftTypeError("asof join keys must be orderable")
        for e in self.left_by:
            e.to_field(left.schema)
        for e in self.right_by:
            e.to_field(right.schema)
        fields = list(left.schema.fields())
        left_names = set(left.schema.column_names())
        for f in right.schema:
            fields.append(f.rename(f"{suffix}{f.name}") if f.name in left_names else f)
        super().__init__([left, right], Schema(fields))

    def with_children(self, children):
        return AsofJoin(children[0], children[1], self.left_on, self.right_on,
                        self.left_by, self.right_by, self.direction, self.suffix)


class Repartition(LogicalPlan):
    """scheme: ("hash", exprs, n) | ("random", n) | ("range", exprs, desc, n)
    | ("into", n) (reference: ops/repartition.rs + RepartitionSpec)."""

    def __init__(self, input: LogicalPlan, scheme: Tuple):
        self.scheme = scheme
        super().__init__([input], input.schema)

    def with_children(self, children):
        return Repartition(children[0], self.scheme)

    def multiline_display(self):
        return [f"Repartition: {self.scheme[0]}"]


class Sink(LogicalPlan):
    """Write sink (reference: ops/sink.rs + SinkInfo). Produces a small
    result table describing written files."""

    def __init__(self, input: LogicalPlan, write_info):
        self.write_info = write_info
        super().__init__([input], write_info.result_schema())

    def with_children(self, children):
        return Sink(children[0], self.write_info)

    def multiline_display(self):
        return [f"Sink: {self.write_info.display_name()}"]
