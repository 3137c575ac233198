"""Local physical plan nodes (port of ``daft_tpu/physical/plan.py``).

Reference: ``LocalPhysicalPlan`` (src/daft-local-plan/src/plan.rs:74-133). Each
node maps 1:1 onto an operator of ``execution/executor.py``. The port has
``InMemorySource``, ``Project``, ``UDFProject``, ``Filter``, ``Explode``,
``Unpivot``, ``Sample``, ``MonotonicallyIncreasingId``, ``Limit``,
``Aggregate`` (global and grouped), ``Pivot``, ``Window``, ``TopN``,
``Sort``, ``Distinct``, ``HashJoin``, ``AsofJoin``, ``CrossJoin``, ``Concat``,
``Repartition``, ``PhysicalScan`` and ``Write``; the distributed nodes
(shuffle reads, two-phase aggregation, sort sampling) are not ported (A.8).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

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


class PhysicalScan(PhysicalPlan):
    def __init__(self, scan_tasks: List, schema: Schema):
        super().__init__([], schema)
        self.scan_tasks = scan_tasks

    def describe(self):
        return f"PhysicalScan[{len(self.scan_tasks)} tasks]"


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


class Explode(PhysicalPlan):
    def __init__(self, child: PhysicalPlan, to_explode, schema: Schema,
                 ignore_empty_and_null: bool = False):
        super().__init__([child], schema)
        self.to_explode = to_explode
        self.ignore_empty_and_null = ignore_empty_and_null


class Unpivot(PhysicalPlan):
    def __init__(self, child: PhysicalPlan, ids, values, variable_name, value_name,
                 schema: Schema):
        super().__init__([child], schema)
        self.ids = ids
        self.values = values
        self.variable_name = variable_name
        self.value_name = value_name


class Sample(PhysicalPlan):
    def __init__(self, child: PhysicalPlan, fraction, size, with_replacement, seed):
        super().__init__([child], child.schema)
        self.fraction = fraction
        self.size = size
        self.with_replacement = with_replacement
        self.seed = seed


class MonotonicallyIncreasingId(PhysicalPlan):
    def __init__(self, child: PhysicalPlan, column_name: str, schema: Schema,
                 partition_offset: int = 0):
        super().__init__([child], schema)
        self.column_name = column_name
        self.partition_offset = partition_offset


class Pivot(PhysicalPlan):
    def __init__(self, child: PhysicalPlan, group_by, pivot_col, value_col, agg_fn, names,
                 schema: Schema):
        super().__init__([child], schema)
        self.group_by = group_by
        self.pivot_col = pivot_col
        self.value_col = value_col
        self.agg_fn = agg_fn
        self.names = names


class Window(PhysicalPlan):
    def __init__(self, child: PhysicalPlan, window_exprs, schema: Schema):
        super().__init__([child], schema)
        self.window_exprs = window_exprs


class Repartition(PhysicalPlan):
    def __init__(self, child: PhysicalPlan, scheme: Tuple):
        super().__init__([child], child.schema)
        self.scheme = scheme

    def describe(self):
        return f"Repartition[{self.scheme[0]}]"


class Aggregate(PhysicalPlan):
    def __init__(self, child: PhysicalPlan, agg_exprs, group_by, schema: Schema):
        super().__init__([child], schema)
        self.agg_exprs = agg_exprs
        self.group_by = group_by

    def describe(self):
        return f"Aggregate[{len(self.agg_exprs)} aggs, {len(self.group_by)} keys]"


class TopN(PhysicalPlan):
    def __init__(self, child: PhysicalPlan, sort_by, descending, nulls_first, limit, offset):
        super().__init__([child], child.schema)
        self.sort_by = sort_by
        self.descending = descending
        self.nulls_first = nulls_first
        self.limit = limit
        self.offset = offset


class Sort(PhysicalPlan):
    def __init__(self, child: PhysicalPlan, sort_by, descending, nulls_first):
        super().__init__([child], child.schema)
        self.sort_by = sort_by
        self.descending = descending
        self.nulls_first = nulls_first


class Distinct(PhysicalPlan):
    def __init__(self, child: PhysicalPlan, on):
        super().__init__([child], child.schema)
        self.on = on


class HashJoin(PhysicalPlan):
    def __init__(self, left: PhysicalPlan, right: PhysicalPlan, left_on, right_on,
                 how, schema: Schema, suffix: str, merged_keys, strategy=None):
        super().__init__([left, right], schema)
        self.left_on = left_on
        self.right_on = right_on
        self.how = how
        self.suffix = suffix
        self.merged_keys = merged_keys
        self.strategy = strategy  # None=auto | broadcast | hash | sort_merge

    def describe(self):
        return f"HashJoin[{self.how}]"


class AsofJoin(PhysicalPlan):
    def __init__(self, left: PhysicalPlan, right: PhysicalPlan, left_on, right_on,
                 left_by, right_by, direction, schema: Schema, suffix: str):
        super().__init__([left, right], schema)
        self.left_on = left_on
        self.right_on = right_on
        self.left_by = left_by
        self.right_by = right_by
        self.direction = direction
        self.suffix = suffix


class CrossJoin(PhysicalPlan):
    def __init__(self, left: PhysicalPlan, right: PhysicalPlan, schema: Schema, suffix: str):
        super().__init__([left, right], schema)
        self.suffix = suffix


class Concat(PhysicalPlan):
    def __init__(self, children: Sequence[PhysicalPlan], schema: Schema):
        super().__init__(list(children), schema)


class Write(PhysicalPlan):
    def __init__(self, child: PhysicalPlan, write_info, schema: Schema):
        super().__init__([child], schema)
        self.write_info = write_info

    def describe(self):
        return f"Write[{self.write_info.display_name()}]"


def shared_subtree_ids(plan: "PhysicalPlan") -> set:
    """ids of DAG nodes referenced by more than one parent (decorrelated
    subqueries share subtrees); the executor runs these exactly once."""
    counts: dict = {}

    def count(n):
        counts[id(n)] = counts.get(id(n), 0) + 1
        if counts[id(n)] == 1:
            for c in n.children:
                count(c)

    count(plan)
    return {i for i, c in counts.items() if c > 1}
