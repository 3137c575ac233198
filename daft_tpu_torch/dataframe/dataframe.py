"""DataFrame: the lazy user-facing API (port of ``daft_tpu/dataframe/dataframe.py``).

Reference: daft/dataframe/dataframe.py. A DataFrame wraps an immutable
LogicalPlanBuilder; transformations return new DataFrames; materialisation
optimizes the plan, translates it and runs it on the local executor. The port
has ``select``, ``with_column``/``with_columns``, ``where``/``filter``,
``limit``, the global ``agg`` and ``sum``/``mean``/``min``/``max``/``count``,
``groupby`` (``dataframe/groupby.py``), ``collect``, ``iter_partitions`` and
``to_pydict``. Not ported yet: the runner layer (native/distributed runners,
admission, plan caches, query log, profiling), SQL predicates,
``sort``/joins/set operations,
``explode``/``unpivot``/``pivot``/``sample``, the writers, the preview and
notebook display, and the pandas/arrow/torch/ray exporters.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Union

from daft_tpu_torch.context import get_context
from daft_tpu_torch.errors import DaftValueError
from daft_tpu_torch.expressions.expression import Expression, col
from daft_tpu_torch.logical.builder import LogicalPlanBuilder
from daft_tpu_torch.micropartition import MicroPartition
from daft_tpu_torch.schema import Schema

ColumnInput = Union[str, Expression]


def _to_expr(c: ColumnInput) -> Expression:
    if isinstance(c, Expression):
        return c
    if isinstance(c, str):
        return col(c)
    raise DaftValueError(f"Expected column name or Expression, got {type(c)}")


def _flatten(items) -> list:
    out = []
    for it in items:
        if isinstance(it, (list, tuple)):
            out.extend(it)
        else:
            out.append(it)
    return out


class DataFrame:
    def __init__(self, builder: LogicalPlanBuilder):
        self._builder = builder
        self._result: Optional[List[MicroPartition]] = None

    @property
    def schema(self) -> Schema:
        return self._builder.schema

    @property
    def column_names(self) -> List[str]:
        return self._builder.schema.column_names()

    def __repr__(self) -> str:
        names = ", ".join(f"{f.name}: {f.dtype!r}" for f in self.schema)
        return f"DataFrame({names})"

    # -- transformations ------------------------------------------------
    def select(self, *columns: ColumnInput) -> "DataFrame":
        return DataFrame(self._builder.select([_to_expr(c)._expr for c in columns]))

    def with_column(self, name: str, expr: Expression) -> "DataFrame":
        return self.with_columns({name: expr})

    def with_columns(self, columns: Dict[str, Expression]) -> "DataFrame":
        exprs = [_to_expr(e).alias(n)._expr for n, e in columns.items()]
        return DataFrame(self._builder.with_columns(exprs))

    def where(self, predicate: Expression) -> "DataFrame":
        return DataFrame(self._builder.filter(predicate._expr))

    filter = where

    def limit(self, n: int, offset: int = 0) -> "DataFrame":
        return DataFrame(self._builder.limit(n, offset))

    # -- aggregation ----------------------------------------------------
    def agg(self, *exprs: Expression) -> "DataFrame":
        """A global aggregation: one row of ``exprs`` over every row."""
        return DataFrame(self._builder.aggregate([e._expr for e in exprs], []))

    def groupby(self, *group_by: ColumnInput) -> "GroupedDataFrame":
        from daft_tpu_torch.dataframe.groupby import GroupedDataFrame

        return GroupedDataFrame(self, _flatten(group_by))

    group_by = groupby

    def _agg_all(self, op: str) -> "DataFrame":
        return self.agg(*[getattr(col(f.name), op)() for f in self.schema
                          if op in ("min", "max", "count") or f.dtype.is_numeric()])

    def sum(self, *cols: ColumnInput) -> "DataFrame":
        return self.agg(*[_to_expr(c).sum() for c in cols]) if cols else self._agg_all("sum")

    def mean(self, *cols: ColumnInput) -> "DataFrame":
        return self.agg(*[_to_expr(c).mean() for c in cols]) if cols else self._agg_all("mean")

    def min(self, *cols: ColumnInput) -> "DataFrame":
        return self.agg(*[_to_expr(c).min() for c in cols]) if cols else self._agg_all("min")

    def max(self, *cols: ColumnInput) -> "DataFrame":
        return self.agg(*[_to_expr(c).max() for c in cols]) if cols else self._agg_all("max")

    def count(self, *cols: ColumnInput) -> "DataFrame":
        return self.agg(*[_to_expr(c).count() for c in cols]) if cols else self._agg_all("count")

    # -- materialisation ------------------------------------------------
    def _run_iter(self) -> Iterator[MicroPartition]:
        from daft_tpu_torch.execution.executor import Executor
        from daft_tpu_torch.physical.translate import translate

        plan = translate(self._builder.optimize().plan)
        return Executor(get_context().execution_config).run(plan)

    def collect(self) -> "DataFrame":
        if self._result is None:
            self._result = list(self._run_iter())
        return self

    def iter_partitions(self) -> Iterator[MicroPartition]:
        if self._result is not None:
            yield from self._result
            return
        yield from self._run_iter()

    def to_pydict(self) -> Dict[str, list]:
        parts = self.collect()._result
        if not parts:
            return {f.name: [] for f in self.schema}
        return MicroPartition.concat(parts).to_pydict()
