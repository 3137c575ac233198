"""DataFrame: the lazy user-facing API (port of ``daft_tpu/dataframe/dataframe.py``).

Reference: daft/dataframe/dataframe.py. A DataFrame wraps an immutable
LogicalPlanBuilder; transformations return new DataFrames; materialisation
optimizes the plan, translates it and runs it on the local executor. This
slice ports ``select``, ``with_column``/``with_columns``, ``limit``,
``collect``, ``iter_partitions`` and ``to_pydict``. Not ported yet: the runner
layer (native/distributed runners, admission, plan caches, query log,
profiling), ``where``/``sort``/``groupby``/``agg``/joins/set operations,
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

    def limit(self, n: int, offset: int = 0) -> "DataFrame":
        return DataFrame(self._builder.limit(n, offset))

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
