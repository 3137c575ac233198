"""DataFrame: the lazy user-facing API (port of ``daft_tpu/dataframe/dataframe.py``).

Reference: daft/dataframe/dataframe.py. A DataFrame wraps an immutable
LogicalPlanBuilder; transformations return new DataFrames; materialisation
optimizes the plan, translates it and runs it on the local executor. The port
has ``select``, ``with_column``/``with_columns`` (window expressions among
them, ``Expression.over``), ``with_columns_renamed``, ``exclude``,
``where``/``filter``, ``limit``, ``offset``, ``sample``, ``explode``,
``unpivot`` (``melt``), ``pivot``, ``drop_nan``, ``drop_null``, ``pipe``,
``shuffle``, the global ``agg`` and its shorthands (``sum``, ``mean``,
``min``, ``max``, ``count``, ``stddev``, ``any_value``, ``var``, ``skew``,
``product``, ``count_distinct``, ``string_agg``, ``agg_list``, ``agg_set``,
``agg_concat``), ``map_groups``, ``groupby``
(``dataframe/groupby.py``), ``sort``, ``distinct`` (``unique``,
``drop_duplicates``), ``join``, ``join_asof``, ``cross_join``, ``concat``
(``union``, ``union_all``), ``union_by_name``, ``union_all_by_name``,
``intersect``, ``intersect_all``, ``except_distinct``, ``except_all``,
``repartition``, ``into_partitions``, ``collect``, ``iter_partitions``,
``to_pydict``, the file writers (``write_parquet``, ``write_csv``,
``write_json``, ``write_ipc``, hive-partitioned by ``partition_cols``) and
``write_sink``; ``collect(timeout=)`` and ``iter_partitions`` (under
``query_timeout_s``) run under the query's cancel token, whose id is
``df.query_id`` while it runs (``cancellation.cancel_query``). Not ported
yet: the runner layer (native/distributed runners, admission, plan caches,
query log, profiling), ``shard``, the table-format and database writers
(A.8), the writers' ``checkpoint=`` (A.2) and their invalidation of cached
reads (the plan cache, A.8), the preview and notebook display, and the
pandas/arrow/torch/ray exporters.
"""

from __future__ import annotations

import uuid
from typing import Dict, Iterator, List, Optional, Sequence, Union

from daft_tpu_torch.cancellation import (
    CancelToken,
    Deadline,
    iter_with_cancel_scope,
    register_query_token,
    unregister_query_token,
)
from daft_tpu_torch.context import get_context, iter_with_frozen_clock
from daft_tpu_torch.errors import DaftNotImplementedError, DaftValueError
from daft_tpu_torch.expressions.expr import ColumnRef
from daft_tpu_torch.expressions.expression import Expression, col, lit
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


def _inner(exprs: Sequence[ColumnInput]) -> list:
    return [_to_expr(e)._expr for e in exprs]


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
        # The id of this frame's latest run, under which its cancel token is
        # registered while it runs.
        self.query_id: Optional[str] = None

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

    def with_columns_renamed(self, mapping: Dict[str, str]) -> "DataFrame":
        exprs = [col(f.name).alias(mapping[f.name])._expr if f.name in mapping
                 else ColumnRef(f.name) for f in self.schema]
        return DataFrame(self._builder.project(exprs))

    def exclude(self, *names: str) -> "DataFrame":
        return DataFrame(self._builder.exclude(list(names)))

    def where(self, predicate: Expression) -> "DataFrame":
        return DataFrame(self._builder.filter(predicate._expr))

    filter = where

    def limit(self, n: int, offset: int = 0) -> "DataFrame":
        return DataFrame(self._builder.limit(n, offset))

    def offset(self, n: int) -> "DataFrame":
        return DataFrame(self._builder.limit(1 << 62, n))

    def sort(self, by: Union[ColumnInput, List[ColumnInput]], desc: Union[bool, List[bool]] = False,
             nulls_first: Optional[Union[bool, List[bool]]] = None) -> "DataFrame":
        by = by if isinstance(by, list) else [by]
        desc = desc if isinstance(desc, list) else [desc] * len(by)
        if nulls_first is not None and not isinstance(nulls_first, list):
            nulls_first = [nulls_first] * len(by)
        return DataFrame(self._builder.sort(_inner(by), desc, nulls_first))

    def distinct(self, *on: ColumnInput) -> "DataFrame":
        return DataFrame(self._builder.distinct(_inner(on) if on else None))

    def sample(self, fraction: Optional[float] = None, *, size: Optional[int] = None,
               with_replacement: bool = False, seed: Optional[int] = None) -> "DataFrame":
        return DataFrame(self._builder.sample(fraction, size, with_replacement, seed))

    def explode(self, *columns: ColumnInput) -> "DataFrame":
        return DataFrame(self._builder.explode(_inner(columns)))

    def unpivot(self, ids: Sequence[ColumnInput], values: Sequence[ColumnInput] = (),
                variable_name: str = "variable", value_name: str = "value") -> "DataFrame":
        ids_e = _inner(ids)
        if not values:
            id_names = {e.name() for e in ids_e}
            values = [f.name for f in self.schema if f.name not in id_names]
        return DataFrame(self._builder.unpivot(ids_e, _inner(values), variable_name, value_name))

    melt = unpivot

    def pivot(self, group_by: Union[ColumnInput, List[ColumnInput]], pivot_col: ColumnInput,
              value_col: ColumnInput, agg_fn: str, names: Optional[List[str]] = None) -> "DataFrame":
        group_by = group_by if isinstance(group_by, list) else [group_by]
        if names is None:
            distinct_vals = self.select(pivot_col).distinct().to_pydict()
            names = [str(v) for v in next(iter(distinct_vals.values()))]
        return DataFrame(self._builder.pivot(
            _inner(group_by), _to_expr(pivot_col)._expr, _to_expr(value_col)._expr, agg_fn,
            names))

    unique = distinct
    drop_duplicates = distinct

    # -- joins and set operations ---------------------------------------
    def join(self, other: "DataFrame", on: Optional[Union[ColumnInput, List[ColumnInput]]] = None,
             left_on=None, right_on=None, how: str = "inner", strategy: Optional[str] = None,
             suffix: str = "right.", prefix: str = "") -> "DataFrame":
        if on is not None:
            on = on if isinstance(on, list) else [on]
            left_on = right_on = on
        if left_on is None or right_on is None:
            raise DaftValueError("join requires `on` or both `left_on` and `right_on`")
        left_on = left_on if isinstance(left_on, list) else [left_on]
        right_on = right_on if isinstance(right_on, list) else [right_on]
        return DataFrame(self._builder.join(
            other._builder, _inner(left_on), _inner(right_on), how, strategy, suffix, prefix))

    def join_asof(self, other: "DataFrame", on: Optional[ColumnInput] = None,
                  left_on: Optional[ColumnInput] = None, right_on: Optional[ColumnInput] = None,
                  by: Optional[Union[ColumnInput, List[ColumnInput]]] = None,
                  direction: str = "backward", suffix: str = "right.") -> "DataFrame":
        """Nearest-key join: each left row takes the right row with the
        greatest key <= its own (backward) or the least >= (forward), within
        equal ``by`` values."""
        if on is not None:
            left_on = right_on = on
        if left_on is None or right_on is None:
            raise DaftValueError("join_asof requires `on` or both `left_on`/`right_on`")
        by = by if isinstance(by, list) else ([by] if by is not None else [])
        return DataFrame(self._builder.asof_join(
            other._builder, _to_expr(left_on)._expr, _to_expr(right_on)._expr,
            _inner(by), _inner(by), direction, suffix))

    def cross_join(self, other: "DataFrame", suffix: str = "right.") -> "DataFrame":
        return DataFrame(self._builder.cross_join(other._builder, suffix))

    def concat(self, other: "DataFrame") -> "DataFrame":
        return DataFrame(self._builder.concat(other._builder))

    union = concat

    def intersect(self, other: "DataFrame") -> "DataFrame":
        return DataFrame(self._builder.intersect(other._builder))

    def intersect_all(self, other: "DataFrame") -> "DataFrame":
        return DataFrame(self._builder.intersect(other._builder, is_all=True))

    def except_distinct(self, other: "DataFrame") -> "DataFrame":
        return DataFrame(self._builder.except_(other._builder))

    def except_all(self, other: "DataFrame") -> "DataFrame":
        """Multiset difference keeping duplicates (reference:
        dataframe.py except_all)."""
        return DataFrame(self._builder.except_(other._builder, is_all=True))

    def union_all(self, other: "DataFrame") -> "DataFrame":
        return self.concat(other)

    def _align_by_name(self, other: "DataFrame") -> "DataFrame":
        """Project `other` onto self's column set by name; columns missing on
        either side surface as nulls (reference: union_by_name semantics)."""
        mine = [f.name for f in self.schema]
        mine_set = set(mine)
        names = mine + [c for c in other.column_names if c not in mine_set]
        self_schema = {f.name: f.dtype for f in self.schema}
        other_schema = {f.name: f.dtype for f in other.schema}

        def side(df, have, other_types):
            return df.select(*[col(n) if n in have else lit(None).cast(other_types[n]).alias(n)
                               for n in names])

        left = side(self, mine_set, other_schema)
        right = side(other, set(other.column_names), self_schema)
        return left.concat(right)

    def union_by_name(self, other: "DataFrame") -> "DataFrame":
        """Distinct union aligning columns by name."""
        return self._align_by_name(other).distinct()

    def union_all_by_name(self, other: "DataFrame") -> "DataFrame":
        """Union-all aligning columns by name."""
        return self._align_by_name(other)

    # -- partitioning ---------------------------------------------------
    def repartition(self, num: int, *partition_by: ColumnInput) -> "DataFrame":
        if partition_by:
            return DataFrame(self._builder.repartition_hash(_inner(partition_by), num))
        return DataFrame(self._builder.repartition_random(num))

    def into_partitions(self, num: int) -> "DataFrame":
        return DataFrame(self._builder.into_partitions(num))

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

    def stddev(self, *cols: ColumnInput) -> "DataFrame":
        return self.agg(*[_to_expr(c).stddev() for c in cols]) if cols else self._agg_all("stddev")

    def any_value(self, *cols: ColumnInput) -> "DataFrame":
        return (self.agg(*[_to_expr(c).any_value() for c in cols]) if cols
                else self._agg_all("any_value"))

    def agg_list(self, *cols: ColumnInput) -> "DataFrame":
        return self.agg(*[_to_expr(c).agg_list() for c in cols])

    list_agg = agg_list

    def agg_set(self, *cols: ColumnInput) -> "DataFrame":
        """Global set (distinct-list) agg, ignoring nulls (reference:
        dataframe.py agg_set)."""
        return self.agg(*[_to_expr(c).agg_set() for c in cols])

    list_agg_distinct = agg_set

    def agg_concat(self, *cols: ColumnInput) -> "DataFrame":
        return self.agg(*[_to_expr(c).agg_concat() for c in cols])

    def var(self, *cols: ColumnInput) -> "DataFrame":
        return (self.agg(*[_to_expr(c).variance() for c in cols]) if cols
                else self._agg_all("variance"))

    def skew(self, *cols: ColumnInput) -> "DataFrame":
        return self.agg(*[_to_expr(c).skew() for c in cols]) if cols else self._agg_all("skew")

    def product(self, *cols: ColumnInput) -> "DataFrame":
        return (self.agg(*[_to_expr(c).product() for c in cols]) if cols
                else self._agg_all("product"))

    def count_distinct(self, *cols: ColumnInput) -> "DataFrame":
        return self.agg(*[_to_expr(c).count_distinct() for c in cols])

    def string_agg(self, *cols: ColumnInput, sep: str = ",") -> "DataFrame":
        return self.agg(*[_to_expr(c).string_agg(sep) for c in cols])

    def map_groups(self, udf) -> "DataFrame":
        """Apply a UDF over the whole frame as one group (reference:
        dataframe.py map_groups; the grouped form lives on GroupedDataFrame)."""
        return self.groupby().map_groups(udf)

    # -- hygiene filters ------------------------------------------------
    def drop_nan(self, *cols: ColumnInput) -> "DataFrame":
        """Drop rows with NaN in the given (default: all float) columns;
        nulls are NOT dropped (reference: dataframe.py drop_nan)."""
        targets = ([_to_expr(c) for c in cols] if cols else
                   [col(f.name) for f in self.schema if f.dtype.is_floating()])
        if not targets:
            return self
        pred = None
        for e in targets:
            keep = ~e.float.is_nan() | e.is_null()
            pred = keep if pred is None else (pred & keep)
        return self.where(pred)

    def drop_null(self, *cols: ColumnInput) -> "DataFrame":
        """Drop rows with nulls in the given (default: all) columns
        (reference: dataframe.py drop_null)."""
        targets = [_to_expr(c) for c in cols] if cols else [col(f.name) for f in self.schema]
        pred = None
        for e in targets:
            pred = e.not_null() if pred is None else (pred & e.not_null())
        return self.where(pred)

    def pipe(self, function, *args, **kwargs):
        """Apply ``function(self, *args, **kwargs)`` (reference: pipe)."""
        return function(self, *args, **kwargs)

    def shuffle(self, seed: Optional[int] = None) -> "DataFrame":
        """Randomly reorder rows (reference: dataframe.py shuffle)."""
        from daft_tpu_torch.functions import random_int

        order = "__shuffle_order"
        while order in self.schema:
            order += "_"
        return (self.with_column(order, random_int(lit(0), seed=seed))
                .sort(order).exclude(order))

    # -- materialisation ------------------------------------------------
    def _run_iter(self, timeout: Optional[float] = None) -> Iterator[MicroPartition]:
        """Run the query under one cancel token, with a deadline of
        ``timeout`` seconds (``query_timeout_s`` when None; none when both
        are None), as the JAX package's runner builds it. On every exit the
        byte ledger closes the query (``get_ledger().profile_for(query_id)``
        then holds its ``mem`` block)."""
        from daft_tpu_torch.execution.executor import Executor
        from daft_tpu_torch.execution.memledger import get_ledger
        from daft_tpu_torch.physical.translate import translate

        cfg = get_context().execution_config
        ledger = get_ledger()
        # The configuration can only turn the ledger off, and doing so drops
        # what it held, so no balance strands (as the JAX package's runner).
        if not cfg.memory_ledger_enabled and ledger.enabled:
            ledger.enabled = False
            ledger.reset()
        ledger.ensure_sampler()
        if timeout is None:
            timeout = cfg.query_timeout_s
        query_id = self.query_id = uuid.uuid4().hex[:16]
        token = CancelToken(Deadline.after(timeout) if timeout is not None else None,
                            query_id=query_id)
        register_query_token(query_id, token)
        run = None
        try:
            plan = translate(self._builder.optimize().plan)
            run = Executor(cfg, cancel_token=token).run(plan)
            # CURRENT_TIMESTAMP is one instant per statement, frozen per
            # resumption as the cancel token is.
            yield from iter_with_cancel_scope(iter_with_frozen_clock(run), token)
        finally:
            if run is not None:
                run.close()  # a failure or an abandoned iteration stops the pool now
            unregister_query_token(query_id)
            ledger.finish_query(query_id)

    def collect(self, timeout: Optional[float] = None) -> "DataFrame":
        """Materialise the query. ``timeout`` (seconds) bounds the whole
        query: on expiry it fails with ``DaftTimeoutError`` at the next morsel
        boundary; None falls back to ``query_timeout_s``."""
        if self._result is None:
            self._result = list(self._run_iter(timeout))
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

    # -- writes ---------------------------------------------------------
    def _write(self, file_format: str, root_dir: str, partition_cols=None,
               compression=None, write_mode="append", checkpoint=None) -> "DataFrame":
        from daft_tpu_torch.io.writers import WriteInfo

        if checkpoint is not None:
            raise DaftNotImplementedError(
                "write checkpoints (daft_tpu/checkpoint.py) are not ported yet (ROADMAP A.2)")
        info = WriteInfo(
            file_format=file_format, root_dir=str(root_dir),
            partition_cols=_inner(partition_cols) if partition_cols else None,
            compression=compression, write_mode=write_mode,
        )
        return DataFrame(self._builder.table_write(info)).collect()

    def write_parquet(self, root_dir: str, compression: str = "snappy",
                      partition_cols=None, write_mode: str = "append",
                      checkpoint=None) -> "DataFrame":
        return self._write("parquet", root_dir, partition_cols, compression, write_mode,
                           checkpoint)

    def write_csv(self, root_dir: str, partition_cols=None, write_mode: str = "append") -> "DataFrame":
        return self._write("csv", root_dir, partition_cols, None, write_mode)

    def write_json(self, root_dir: str, partition_cols=None, write_mode: str = "append") -> "DataFrame":
        return self._write("json", root_dir, partition_cols, None, write_mode)

    def write_ipc(self, root_dir: str, partition_cols=None, write_mode: str = "append") -> "DataFrame":
        return self._write("ipc", root_dir, partition_cols, None, write_mode)

    def write_sink(self, sink) -> "DataFrame":
        """Write through a pluggable DataSink (reference: daft/io/sink.py)."""
        from daft_tpu_torch.dataframe import creation

        sink.start()
        results = [sink.write(part) for part in self.iter_partitions()]
        final = sink.finalize(results)
        return creation.from_pydict(final if isinstance(final, dict) else {"result": [repr(final)]})
