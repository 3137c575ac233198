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
``df.query_id`` while it runs (``cancellation.cancel_query``). The surface
around them: ``columns``, ``in`` and ``df[...]``, ``explain``, the preview
(``repr`` of a collected frame, ``show``, the notebook table),
``with_column_renamed``, ``describe``, ``summarize``, ``into_batches``,
``transform``, ``add_monotonically_increasing_id``, ``count_rows`` /
``len``, ``num_partitions``, ``skip_existing`` and the exporters
(``iter_rows``, ``to_pylist``, ``to_arrow``, ``to_arrow_iter``,
``to_pandas``, ``to_torch_map_dataset``, ``to_torch_iter_dataset``,
``to_torch_dataloader``; ``to_dask_dataframe`` and ``to_ray_dataset`` raise
as in the JAX package). Not ported yet: the runner layer (native and
distributed runners, admission, plan caches, the query log; A.8), and, each
raising ``DaftNotImplementedError`` naming its ROADMAP item (``_LEFT_OUT``),
``shard``, the table-format, database and connector writers (A.8),
``with_checkpoint`` and the writers' ``checkpoint=`` (A.2), and profiling:
``explain(analyze=True)``, ``collect(profile=...)`` and ``metrics`` (A.9.5).
"""

from __future__ import annotations

import uuid
from typing import Any, Dict, Iterator, List, Optional, Sequence, Union

from daft_tpu_torch.cancellation import (
    CancelToken,
    Deadline,
    iter_with_cancel_scope,
    register_query_token,
    unregister_query_token,
)
from daft_tpu_torch.context import get_context, iter_with_frozen_clock
from daft_tpu_torch.errors import DaftIOError, DaftNotImplementedError, DaftValueError
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

    @property
    def columns(self) -> List[Expression]:
        return [col(n) for n in self.column_names]

    def __contains__(self, name: str) -> bool:
        return name in self._builder.schema

    def __getitem__(self, key) -> Expression:
        if isinstance(key, str):
            if key not in self._builder.schema:
                raise DaftValueError(f"Column {key!r} not in schema")
            return col(key)
        if isinstance(key, int):
            return col(self.column_names[key])
        raise DaftValueError(f"Cannot index DataFrame with {key!r}")

    def explain(self, show_all: bool = False, analyze: bool = False) -> None:
        """Print the plan (with ``show_all``: the unoptimized, optimized and
        physical plans)."""
        if analyze:
            raise DaftNotImplementedError(
                "explain(analyze=True) needs the profiler's operator spans, which are not "
                "ported to daft_tpu_torch yet: ROADMAP A.9.5")
        print(self._builder.explain_string(show_all))

    def __repr__(self) -> str:
        if self._result is not None:
            return self._preview_str()
        names = ", ".join(f"{f.name}: {f.dtype!r}" for f in self.schema)
        return f"DataFrame({names})\n(unmaterialized — call .collect() or .show())"

    def _repr_html_(self) -> str:
        """The notebook's preview table (the JAX package's interactive
        display): ``num_preview_rows`` rows, fetched with one more so the
        '... more rows' line is right without running the unlimited plan."""
        from daft_tpu_torch.subscribers.dashboard import (
            DataFrameDisplay,
            generate_interactive_html,
        )

        reg = DataFrameDisplay()
        df_id = reg.register(self, "DataFrame",
                             max_rows=get_context().execution_config.num_preview_rows)
        return generate_interactive_html(reg.get(df_id))

    # -- transformations ------------------------------------------------
    def select(self, *columns: ColumnInput) -> "DataFrame":
        return DataFrame(self._builder.select([_to_expr(c)._expr for c in columns]))

    def with_column(self, name: str, expr: Expression) -> "DataFrame":
        return self.with_columns({name: expr})

    def with_columns(self, columns: Dict[str, Expression]) -> "DataFrame":
        exprs = [_to_expr(e).alias(n)._expr for n, e in columns.items()]
        return DataFrame(self._builder.with_columns(exprs))

    def with_column_renamed(self, existing: str, new: str) -> "DataFrame":
        return self.with_columns_renamed({existing: new})

    def with_columns_renamed(self, mapping: Dict[str, str]) -> "DataFrame":
        exprs = [col(f.name).alias(mapping[f.name])._expr if f.name in mapping
                 else ColumnRef(f.name) for f in self.schema]
        return DataFrame(self._builder.project(exprs))

    def exclude(self, *names: str) -> "DataFrame":
        return DataFrame(self._builder.exclude(list(names)))

    def where(self, predicate: Union[Expression, str]) -> "DataFrame":
        if isinstance(predicate, str):
            from daft_tpu_torch.sql.sql import sql_expr

            predicate = sql_expr(predicate)
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

    def describe(self) -> "DataFrame":
        """The schema: one row per column, its name and type."""
        from daft_tpu_torch.dataframe import creation

        return creation.from_pydict({
            "column": [f.name for f in self.schema],
            "type": [repr(f.dtype) for f in self.schema],
        })

    def summarize(self) -> "DataFrame":
        """Per-column statistics from one global aggregation: count, nulls,
        and for a comparable column its min, max (as strings) and approximate
        distinct count."""
        from daft_tpu_torch.dataframe import creation

        rows = {"column": [], "type": [], "min": [], "max": [], "count": [],
                "count_nulls": [], "approx_count_distinct": []}
        aggs = []
        for f in self.schema:
            c = col(f.name)
            aggs.append(c.count().alias(f"{f.name}__count"))
            aggs.append(c.count("null").alias(f"{f.name}__nulls"))
            if f.dtype.is_comparable() and not f.dtype.is_null():
                aggs.append(c.min().alias(f"{f.name}__min"))
                aggs.append(c.max().alias(f"{f.name}__max"))
                aggs.append(c.approx_count_distinct().alias(f"{f.name}__acd"))
        stats = self.agg(*aggs).to_pydict()

        def render(key):
            v = stats[key][0]
            return None if v is None else str(v)

        for f in self.schema:
            name = f.name
            rows["column"].append(name)
            rows["type"].append(repr(f.dtype))
            rows["count"].append(stats[f"{name}__count"][0])
            rows["count_nulls"].append(stats[f"{name}__nulls"][0])
            has = f"{name}__min" in stats
            rows["min"].append(render(f"{name}__min") if has else None)
            rows["max"].append(render(f"{name}__max") if has else None)
            rows["approx_count_distinct"].append(stats[f"{name}__acd"][0] if has else None)
        return creation.from_pydict(rows)

    def into_batches(self, batch_size: int) -> "DataFrame":
        """Partitions of about ``batch_size`` rows: the query runs once and
        its result is repartitioned."""
        if batch_size <= 0:
            raise DaftValueError(f"batch_size must be positive, got {batch_size}")
        parts = self.collect()._result or []
        total = sum(len(p) for p in parts)
        n = max(1, (total + batch_size - 1) // batch_size)
        mat = DataFrame(LogicalPlanBuilder.in_memory(
            parts or [MicroPartition.empty(self.schema)], self.schema))
        return mat.into_partitions(n)

    def transform(self, func, *args, **kwargs) -> "DataFrame":
        out = func(self, *args, **kwargs)
        if not isinstance(out, DataFrame):
            raise DaftValueError("transform function must return a DataFrame")
        return out

    def add_monotonically_increasing_id(self, column_name: str = "id") -> "DataFrame":
        return DataFrame(self._builder.add_monotonically_increasing_id(column_name))

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

    def num_partitions(self) -> int:
        return max(1, len(self.collect()._result))

    # -- aggregation ----------------------------------------------------
    def agg(self, *exprs: Expression) -> "DataFrame":
        """A global aggregation: one row of ``exprs`` (or lists of them)
        over every row."""
        return DataFrame(self._builder.aggregate(_inner(_flatten(exprs)), []))

    def groupby(self, *group_by: ColumnInput) -> "GroupedDataFrame":
        from daft_tpu_torch.dataframe.groupby import GroupedDataFrame

        return GroupedDataFrame(self, _flatten(group_by))

    group_by = groupby

    def _agg_all(self, op: str) -> "DataFrame":
        return self.agg(*[getattr(col(f.name), op)() for f in self.schema
                          if op in ("min", "max", "count", "any_value")
                          or f.dtype.is_numeric()])

    def sum(self, *cols: ColumnInput) -> "DataFrame":
        return self.agg(*[_to_expr(c).sum() for c in cols]) if cols else self._agg_all("sum")

    def mean(self, *cols: ColumnInput) -> "DataFrame":
        return self.agg(*[_to_expr(c).mean() for c in cols]) if cols else self._agg_all("mean")

    def min(self, *cols: ColumnInput) -> "DataFrame":
        return self.agg(*[_to_expr(c).min() for c in cols]) if cols else self._agg_all("min")

    def max(self, *cols: ColumnInput) -> "DataFrame":
        return self.agg(*[_to_expr(c).max() for c in cols]) if cols else self._agg_all("max")

    def count(self, *cols: ColumnInput) -> "DataFrame":
        """The non-null count of each of ``cols``; with none, the rows as one
        ``count`` column."""
        if cols:
            return self.agg(*[_to_expr(c).count() for c in cols])
        return self.agg(lit(1).count().alias("count"))

    def count_rows(self) -> int:
        result = self.count().to_pydict()
        return int(next(iter(result.values()))[0])

    def __len__(self) -> int:
        return self.count_rows()

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

    def collect(self, timeout: Optional[float] = None, profile=None) -> "DataFrame":
        """Materialise the query. ``timeout`` (seconds) bounds the whole
        query: on expiry it fails with ``DaftTimeoutError`` at the next morsel
        boundary; None falls back to ``query_timeout_s``."""
        if profile:
            raise DaftNotImplementedError(
                "collect(profile=...) needs the profiler's operator spans, which are not "
                "ported to daft_tpu_torch yet: ROADMAP A.9.5")
        if self._result is None:
            self._result = list(self._run_iter(timeout))
        return self

    def show(self, n: int = 8) -> None:
        print(self.limit(n)._materialize_preview(n))

    def _materialize_preview(self, n: int) -> str:
        parts = self.collect()._result
        mp = MicroPartition.concat(parts) if parts else MicroPartition.empty(self.schema)
        return mp.combined().preview_string(n)

    def _preview_str(self) -> str:
        parts = self._result or []
        mp = MicroPartition.concat(parts) if parts else MicroPartition.empty(self.schema)
        return mp.combined().preview_string(get_context().execution_config.num_preview_rows)

    def iter_partitions(self) -> Iterator[MicroPartition]:
        if self._result is not None:
            yield from self._result
            return
        yield from self._run_iter()

    def iter_rows(self) -> Iterator[Dict[str, Any]]:
        for part in self.iter_partitions():
            rb = part.combined()
            names = [c.name for c in rb.columns()]
            if not names:
                yield from ({} for _ in range(len(rb)))
                continue
            for values in zip(*[c.to_pylist() for c in rb.columns()]):
                yield dict(zip(names, values))

    def to_pydict(self) -> Dict[str, list]:
        parts = self.collect()._result
        if not parts:
            return {f.name: [] for f in self.schema}
        return MicroPartition.concat(parts).to_pydict()

    def to_pylist(self) -> List[Dict[str, Any]]:
        return list(self.iter_rows())

    def to_arrow(self):
        parts = self.collect()._result
        if not parts:
            return self.schema.to_arrow().empty_table()
        return MicroPartition.concat(parts).to_arrow_table()

    def to_pandas(self):
        parts = self.collect()._result
        if not parts:
            import pandas as pd

            return pd.DataFrame({f.name: [] for f in self.schema})
        return MicroPartition.concat(parts).combined().to_pandas()

    def to_arrow_iter(self):
        """The result as Arrow record batches, partition by partition."""
        for part in self.iter_partitions():
            yield from part.to_arrow_table().to_batches()

    def to_torch_map_dataset(self):
        """A map-style torch ``Dataset`` over the result's rows, each a dict
        of Python values (as ``iter_rows`` gives them)."""
        import torch.utils.data as tud

        rows = list(self.iter_rows())

        class _MapDataset(tud.Dataset):
            def __len__(self):
                return len(rows)

            def __getitem__(self, idx):
                return rows[idx]

        return _MapDataset()

    def to_torch_iter_dataset(self):
        """An iterable torch ``Dataset`` streaming the rows (``iter_rows``)."""
        import torch.utils.data as tud

        df = self

        class _IterDataset(tud.IterableDataset):
            def __iter__(self):
                return df.iter_rows()

        return _IterDataset()

    def to_torch_dataloader(self, batch_size: int = 1, **kwargs):
        """A torch ``DataLoader`` over ``to_torch_map_dataset``; ``kwargs``
        (``pin_memory``, ``num_workers``, ...) go to the ``DataLoader``."""
        import torch.utils.data as tud

        return tud.DataLoader(self.to_torch_map_dataset(), batch_size=batch_size, **kwargs)

    def to_dask_dataframe(self, *a, **kw):
        raise DaftIOError("to_dask_dataframe requires the dask integration, "
                          "which is not available in this environment")

    def to_ray_dataset(self, *a, **kw):
        raise DaftIOError("to_ray_dataset requires the ray integration, "
                          "which is not available in this environment")

    def skip_existing(self, existing_path, on: Union[ColumnInput, List[ColumnInput]],
                      file_format: str = "parquet") -> "DataFrame":
        """Drop the rows whose key(s) already stand in the data at
        ``existing_path`` (an anti join on them); a missing or empty path
        passes every row, any other error raises."""
        from daft_tpu_torch.io import reads
        from daft_tpu_torch.io.scan import glob_paths

        on = on if isinstance(on, list) else [on]
        names = [_to_expr(c).name() for c in on]
        paths = [str(p) for p in (existing_path if isinstance(existing_path, list)
                                  else [existing_path])]
        try:
            files = glob_paths(paths)
        except Exception:
            files = []
        if not files:
            return self
        existing = getattr(reads, f"read_{file_format}")(paths).select(*names).distinct()
        return self.join(existing, left_on=names, right_on=names, how="anti")

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


#: The JAX package's DataFrame methods the port leaves out, by ROADMAP item.
_LEFT_OUT = {
    "shard": "A.8 (Shard and PushDownShard)",
    "with_checkpoint": "A.2 (pipeline-progress checkpoints)",
    "metrics": "A.9.5 (RuntimeStats)",
    "write_deltalake": "A.8 (the table formats)",
    "write_iceberg": "A.8 (the table formats)",
    "write_sql": "A.8 (the database writers)",
    "write_clickhouse": "A.8 (the connectors)",
    "write_turbopuffer": "A.8 (the connectors)",
    "write_bigtable": "A.8 (the connectors)",
    "write_lance": "A.8 (the connectors)",
    "write_paimon": "A.8 (the connectors)",
    "write_huggingface": "A.8 (the connectors)",
    "set_storage_option": "A.8 (remote IO)",
}


def _left_out(name: str, item: str):
    def method(self, *args, **kwargs):
        raise DaftNotImplementedError(
            f"DataFrame.{name} is not ported to daft_tpu_torch yet: ROADMAP {item}")

    method.__name__ = name
    return method


for _name, _item in _LEFT_OUT.items():
    setattr(DataFrame, _name, _left_out(_name, _item))
