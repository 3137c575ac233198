"""LogicalPlanBuilder (port of ``daft_tpu/logical/builder.py``; reference:
src/daft-logical-plan/src/builder/mod.rs:61-1240).

Thin, immutable builder over LogicalPlan nodes; the DataFrame API wraps this.
Not ported yet: ``shard`` (its node, ROADMAP A.8).
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
        from daft_tpu_torch.expressions.expr import Alias, FunctionCall, WindowExpr

        # Top-level unnest(struct_col) markers expand into one struct_get per
        # field (reference: Expression.unnest == .get("*"), expanded by the
        # Rust builder's wildcard resolution). Top-level explode(list_col)
        # markers project the inner expression and append an Explode node
        # (reference: daft/functions/list.py explode usable in select).
        def _is_marker(e: Expr, name: str) -> bool:
            return isinstance(e, FunctionCall) and e.fn_name == name

        explode_names = []
        explode_ignore = False
        if any(_is_marker(e, "unnest") or _is_marker(e, "explode") or
               (isinstance(e, Alias) and
                (_is_marker(e.child, "explode") or _is_marker(e.child, "unnest")))
               for e in exprs):
            from daft_tpu_torch.errors import DaftTypeError

            expanded = []
            for e in exprs:
                if _is_marker(e, "unnest"):
                    inner = e.args[0]
                    dt = inner.to_field(self.schema).dtype
                    if not dt.is_struct():
                        raise DaftTypeError(f"unnest expects a struct column, got {dt!r}")
                    for fname in dt.fields:
                        expanded.append(Alias(
                            FunctionCall("struct_get", [inner], {"name": fname}), fname))
                elif isinstance(e, Alias) and _is_marker(e.child, "unnest"):
                    raise DaftTypeError(
                        "unnest expands to multiple columns and cannot be "
                        "aliased; select(unnest(col)) without .alias()")
                elif _is_marker(e, "explode"):
                    expanded.append(e.args[0])
                    explode_names.append(e.args[0].name())
                    explode_ignore |= bool(e.kwargs.get("ignore_empty_and_null"))
                elif isinstance(e, Alias) and _is_marker(e.child, "explode"):
                    expanded.append(Alias(e.child.args[0], e.name()))
                    explode_names.append(e.name())
                    explode_ignore |= bool(e.child.kwargs.get("ignore_empty_and_null"))
                else:
                    expanded.append(e)
            exprs = expanded

        # Projections containing window expressions plan a Window node that
        # appends the window columns, then a final Project re-shapes
        # (reference: window extraction in the logical builder, daft/window.py).
        window_aliases = []

        def hoist(n: Expr):
            if isinstance(n, WindowExpr):
                name = f"__window_{len(window_aliases)}"
                window_aliases.append(Alias(n, name))
                return ColumnRef(name)
            return None

        rewritten = []
        for e in exprs:
            r = e.transform(hoist)
            rewritten.append(Alias(r, e.name()) if r is not e and r.name() != e.name() else r)
        if window_aliases:
            # One Window node per distinct partition_by spec: keeps each node
            # shuffle-able by a single key set in the distributed planner.
            groups: dict = {}
            for alias in window_aliases:
                key = tuple(pb.key() for pb in alias.child.partition_by)
                groups.setdefault(key, []).append(alias)
            windowed = self._plan
            for group in groups.values():
                windowed = lp.Window(windowed, group)
            out = LogicalPlanBuilder(lp.Project(windowed, rewritten))
        else:
            out = LogicalPlanBuilder(lp.Project(self._plan, exprs))
        if explode_names:
            out = out.explode([ColumnRef(n) for n in explode_names],
                              ignore_empty_and_null=explode_ignore)
        return out

    def select(self, exprs: Sequence[Expr]) -> "LogicalPlanBuilder":
        return self.project(exprs)

    def with_columns(self, exprs: Sequence[Expr]) -> "LogicalPlanBuilder":
        new_names = {e.name() for e in exprs}
        keep = [ColumnRef(f.name) for f in self.schema if f.name not in new_names]
        return self.project(keep + list(exprs))

    def exclude(self, names: Sequence[str]) -> "LogicalPlanBuilder":
        drop = set(names)
        return self.project([ColumnRef(f.name) for f in self.schema if f.name not in drop])

    def filter(self, predicate: Expr) -> "LogicalPlanBuilder":
        return LogicalPlanBuilder(lp.Filter(self._plan, predicate))

    def aggregate(self, agg_exprs: Sequence[Expr], group_by: Sequence[Expr]) -> "LogicalPlanBuilder":
        return LogicalPlanBuilder(lp.Aggregate(self._plan, agg_exprs, group_by))

    def limit(self, n: int, offset: int = 0) -> "LogicalPlanBuilder":
        return LogicalPlanBuilder(lp.Limit(self._plan, n, offset))

    def sample(self, fraction=None, size=None, with_replacement=False, seed=None) -> "LogicalPlanBuilder":
        return LogicalPlanBuilder(lp.Sample(self._plan, fraction, size, with_replacement, seed))

    def explode(self, exprs: Sequence[Expr],
                ignore_empty_and_null: bool = False) -> "LogicalPlanBuilder":
        return LogicalPlanBuilder(lp.Explode(self._plan, exprs, ignore_empty_and_null))

    def unpivot(self, ids, values, variable_name="variable", value_name="value") -> "LogicalPlanBuilder":
        return LogicalPlanBuilder(lp.Unpivot(self._plan, ids, values, variable_name, value_name))

    def add_monotonically_increasing_id(self, column_name: str = "id") -> "LogicalPlanBuilder":
        return LogicalPlanBuilder(lp.MonotonicallyIncreasingId(self._plan, column_name))

    def pivot(self, group_by, pivot_col, value_col, agg_fn, names) -> "LogicalPlanBuilder":
        return LogicalPlanBuilder(lp.Pivot(self._plan, group_by, pivot_col, value_col, agg_fn, names))

    def window(self, window_exprs: Sequence[Expr]) -> "LogicalPlanBuilder":
        return LogicalPlanBuilder(lp.Window(self._plan, window_exprs))

    def repartition_hash(self, exprs: Sequence[Expr], num_partitions: int) -> "LogicalPlanBuilder":
        return LogicalPlanBuilder(lp.Repartition(self._plan, ("hash", list(exprs), num_partitions)))

    def repartition_random(self, num_partitions: int) -> "LogicalPlanBuilder":
        return LogicalPlanBuilder(lp.Repartition(self._plan, ("random", num_partitions)))

    def into_partitions(self, num_partitions: int) -> "LogicalPlanBuilder":
        return LogicalPlanBuilder(lp.Repartition(self._plan, ("into", num_partitions)))

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

    def explain_string(self, show_all: bool = False) -> str:
        out = ["== Unoptimized Logical Plan ==", repr(self._plan)]
        if show_all:
            from daft_tpu_torch.physical.translate import translate

            optimized = self.optimize()._plan
            out += ["", "== Optimized Logical Plan ==", repr(optimized),
                    "", "== Physical Plan ==", repr(translate(optimized))]
        return "\n".join(out)

    def optimize(self) -> "LogicalPlanBuilder":
        from daft_tpu_torch.logical.optimizer import Optimizer

        return LogicalPlanBuilder(Optimizer().optimize(self._plan))
