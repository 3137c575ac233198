"""RecordBatch: schema + equal-length Series columns.

Re-designs the reference's ``RecordBatch`` (reference:
src/daft-recordbatch/src/lib.rs:68-72) on Arrow C++ host memory. Relational
ops (filter/take/sort/join/agg/pivot/…) delegate to Arrow Acero / pyarrow
compute where possible (native C++ kernels), to engine kernels otherwise.
Expression evaluation (`eval_expression_list`, reference lib.rs:1623) runs on
the host in this port.

Port of ``daft_tpu/recordbatch.py``. ``agg`` evaluates global and grouped
aggregations (``expressions/agg_eval.py``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

from daft_tpu_torch.datatype import DataType, unify_dtypes
from daft_tpu_torch.errors import DaftTypeError, DaftValueError
from daft_tpu_torch.schema import Field, Schema
from daft_tpu_torch.series import Series


class RecordBatch:
    __slots__ = ("_schema", "_columns", "_num_rows", "_size_bytes")

    def __init__(self, schema: Schema, columns: Sequence[Series], num_rows: Optional[int] = None):
        self._schema = schema
        self._columns = list(columns)
        if num_rows is None:
            if not columns:
                raise DaftValueError("RecordBatch with no columns requires explicit num_rows")
            num_rows = len(columns[0])
        for c in self._columns:
            if len(c) != num_rows:
                raise DaftValueError(
                    f"Column {c.name!r} has length {len(c)}, expected {num_rows}"
                )
        self._num_rows = num_rows

    # ------------------------------------------------------------------ #
    # Constructors / conversions                                          #
    # ------------------------------------------------------------------ #
    @staticmethod
    def empty(schema: Optional[Schema] = None) -> "RecordBatch":
        schema = schema or Schema.empty()
        return RecordBatch(schema, [Series.null(f.name, f.dtype, 0) for f in schema], 0)

    @staticmethod
    def from_pydict(data: Dict[str, Any]) -> "RecordBatch":
        columns = []
        for name, values in data.items():
            if isinstance(values, Series):
                columns.append(values.rename(name))
            elif isinstance(values, (pa.Array, pa.ChunkedArray)):
                columns.append(Series.from_arrow(values, name))
            elif isinstance(values, np.ndarray):
                columns.append(Series.from_numpy(values, name))
            else:
                columns.append(Series.from_pylist(list(values), name))
        schema = Schema([Field(c.name, c.dtype) for c in columns])
        n = len(columns[0]) if columns else 0
        return RecordBatch(schema, columns, n)

    @staticmethod
    def from_arrow_table(table: Union[pa.Table, pa.RecordBatch], schema: Optional[Schema] = None) -> "RecordBatch":
        if isinstance(table, pa.RecordBatch):
            table = pa.Table.from_batches([table])
        columns = []
        for i, col in enumerate(table.columns):
            name = table.schema[i].name
            dtype = schema[name].dtype if schema is not None and name in schema else None
            columns.append(Series.from_arrow(col, name, dtype))
        out_schema = schema if schema is not None else Schema([Field(c.name, c.dtype) for c in columns])
        return RecordBatch(out_schema, columns, table.num_rows)

    def to_arrow_table(self) -> pa.Table:
        if not self._columns:
            return pa.table({})
        return pa.Table.from_arrays(
            [c.to_arrow() for c in self._columns], schema=self._schema.to_arrow()
        )

    def to_pydict(self) -> Dict[str, list]:
        return {c.name: c.to_pylist() for c in self._columns}

    def to_pandas(self):
        import pandas as pd

        return pd.DataFrame({c.name: c.to_pandas() for c in self._columns})

    # ------------------------------------------------------------------ #
    # Introspection                                                       #
    # ------------------------------------------------------------------ #
    @property
    def schema(self) -> Schema:
        return self._schema

    def __len__(self) -> int:
        return self._num_rows

    def num_rows(self) -> int:
        return self._num_rows

    def num_columns(self) -> int:
        return len(self._columns)

    def column_names(self) -> List[str]:
        return self._schema.column_names()

    def columns(self) -> List[Series]:
        return list(self._columns)

    def get_column(self, name: str) -> Series:
        return self._columns[self._schema.index_of(name)]

    def size_bytes(self) -> int:
        # Memoized: batches are immutable, and size_bytes walks every
        # column buffer — the profiler's byte sampling, memory-permit
        # accounting, and spill decisions all ask repeatedly as a morsel
        # flows through stacked pipeline stages.
        cached = getattr(self, "_size_bytes", None)
        if cached is not None:
            return cached
        total = 0
        for c in self._columns:
            if c.dtype.is_python():
                total += 64 * len(c)
            else:
                total += c.to_arrow().nbytes
        self._size_bytes = total
        return total

    def __repr__(self) -> str:
        return f"RecordBatch(num_rows={self._num_rows}, schema={self._schema!r})"

    # ------------------------------------------------------------------ #
    # Expression evaluation                                               #
    # ------------------------------------------------------------------ #
    def eval_expression_list(self, exprs: Sequence) -> "RecordBatch":
        """Evaluate expressions to produce a new RecordBatch (projection).
        (reference: src/daft-recordbatch/src/lib.rs:1623)."""
        from daft_tpu_torch.expressions.evaluator import evaluate_to_batch

        return evaluate_to_batch(self, exprs)

    def eval_expression(self, expr) -> Series:
        from daft_tpu_torch.expressions.evaluator import evaluate

        return evaluate(expr, self)

    # ------------------------------------------------------------------ #
    # Row selection                                                       #
    # ------------------------------------------------------------------ #
    def _with_columns(self, columns: Sequence[Series], num_rows: int) -> "RecordBatch":
        return RecordBatch(self._schema, columns, num_rows)

    def slice(self, start: int, length: Optional[int] = None) -> "RecordBatch":
        if length is None:
            length = self._num_rows - start
        length = max(0, min(length, self._num_rows - start))
        return self._with_columns([c.slice(start, length) for c in self._columns], length)

    def head(self, n: int) -> "RecordBatch":
        return self.slice(0, n)

    def filter(self, mask: Series) -> "RecordBatch":
        if not mask.dtype.is_boolean():
            raise DaftTypeError(f"filter mask must be Boolean, got {mask.dtype!r}")
        out = [c.filter(mask) for c in self._columns]
        n = len(out[0]) if out else int(np.asarray(pc.sum(pc.fill_null(mask.to_arrow(), False)).as_py() or 0))
        return self._with_columns(out, n)

    def take(self, indices: Union[Series, np.ndarray]) -> "RecordBatch":
        n = len(indices)
        return self._with_columns([c.take(indices) for c in self._columns], n)

    def sample(self, fraction: Optional[float] = None, size: Optional[int] = None,
               with_replacement: bool = False, seed: Optional[int] = None) -> "RecordBatch":
        if fraction is not None:
            size = int(self._num_rows * fraction)
        size = min(size or 0, self._num_rows) if not with_replacement else (size or 0)
        rng = np.random.default_rng(seed)
        if with_replacement:
            idx = rng.integers(0, max(self._num_rows, 1), size=size)
        else:
            idx = rng.permutation(self._num_rows)[:size]
        return self.take(idx.astype(np.uint64))

    @staticmethod
    def concat(batches: Sequence["RecordBatch"]) -> "RecordBatch":
        if not batches:
            raise DaftValueError("Cannot concat zero RecordBatches")
        if len(batches) == 1:
            return batches[0]
        first = batches[0]
        names = first.column_names()
        cols = []
        for i, name in enumerate(names):
            cols.append(Series.concat([b._columns[i] for b in batches]).rename(name))
        schema = Schema([Field(c.name, c.dtype) for c in cols])
        return RecordBatch(schema, cols, sum(len(b) for b in batches))

    def union(self, other: "RecordBatch") -> "RecordBatch":
        """Column-wise (horizontal) union."""
        if len(other) != len(self):
            raise DaftValueError("union requires equal row counts")
        return RecordBatch(
            self._schema.union(other._schema), self._columns + other._columns, self._num_rows
        )

    # ------------------------------------------------------------------ #
    # Sorting                                                             #
    # ------------------------------------------------------------------ #
    def argsort(self, sort_keys: Sequence[Series], descending: Sequence[bool],
                nulls_first: Optional[Sequence[bool]] = None) -> Series:
        if nulls_first is None:
            nulls_first = list(descending)
        arrays, sort_spec = {}, []
        for i, (key, desc) in enumerate(zip(sort_keys, descending)):
            kname = f"__sort_{i}"
            arrays[kname] = key.to_arrow()
            sort_spec.append((kname, "descending" if desc else "ascending"))
        table = pa.table(arrays)
        # pyarrow sort_indices supports one global null_placement; use the first
        # key's preference (per-key placement is a later-round native kernel).
        placement = "at_start" if (nulls_first[0] if nulls_first else False) else "at_end"
        idx = pc.sort_indices(table, sort_keys=sort_spec, null_placement=placement)
        return Series.from_arrow(idx.cast(pa.uint64()), "indices", DataType.uint64())

    def sort(self, sort_keys: Sequence[Series], descending: Sequence[bool],
             nulls_first: Optional[Sequence[bool]] = None) -> "RecordBatch":
        return self.take(self.argsort(sort_keys, descending, nulls_first))

    def quantiles(self, num: int, sort_keys: Sequence[Series], descending: Sequence[bool],
                  nulls_first: Optional[Sequence[bool]] = None) -> "RecordBatch":
        """num-1 boundary rows used for range partitioning (reference:
        src/daft-recordbatch quantiles for sort)."""
        sorted_batch = RecordBatch(
            Schema([Field(k.name, k.dtype) for k in sort_keys]), list(sort_keys)
        ).sort(sort_keys, list(descending), nulls_first)
        if len(sorted_batch) == 0 or num <= 1:
            return sorted_batch.head(0)
        idx = (np.arange(1, num) * len(sorted_batch) // num).clip(0, len(sorted_batch) - 1)
        return sorted_batch.take(idx.astype(np.uint64))

    # ------------------------------------------------------------------ #
    # Hashing / partitioning                                              #
    # ------------------------------------------------------------------ #
    def partition_by_hash(self, key_series: Sequence[Series], num_partitions: int) -> List["RecordBatch"]:
        """Split by the combined row hash of ``key_series``: every row of a
        key lands in one part, in input order (``_split_by_ids`` is stable)."""
        from daft_tpu_torch.kernels.hashing import combine_hashes

        if num_partitions <= 1:
            return [self]
        if not key_series:
            raise DaftValueError("partition_by_hash requires at least one key")
        hashes = combine_hashes([k.hash().to_numpy() for k in key_series])
        part_ids = (hashes % np.uint64(num_partitions)).astype(np.int64)
        return self._split_by_ids(part_ids, num_partitions)

    def partition_by_random(self, num_partitions: int, seed: int) -> List["RecordBatch"]:
        rng = np.random.default_rng(seed)
        part_ids = rng.integers(0, num_partitions, size=self._num_rows)
        return self._split_by_ids(part_ids, num_partitions)

    def partition_by_range(self, key_series: Sequence[Series], boundaries: "RecordBatch",
                           descending: Sequence[bool],
                           nulls_first: Optional[Sequence[bool]] = None) -> List["RecordBatch"]:
        num_partitions = len(boundaries) + 1
        if self._num_rows == 0:
            return [self.head(0) for _ in range(num_partitions)]
        if nulls_first is None:
            nulls_first = list(descending)
        # Compare each row against boundary rows lexicographically.
        part_ids = np.zeros(self._num_rows, dtype=np.int64)
        for b in range(len(boundaries)):
            ge = _row_ge(key_series, boundaries, b, descending, nulls_first)
            part_ids += ge.astype(np.int64)
        return self._split_by_ids(part_ids, num_partitions)

    def partition_by_value(self, key_series: Sequence[Series]) -> "Tuple[List[RecordBatch], RecordBatch]":
        """Split into one batch per distinct key combo; returns (parts, keys)."""
        group_ids, uniq_idx = _group_codes(key_series)
        num = len(uniq_idx)
        parts = self._split_by_ids(group_ids, num)
        keys = RecordBatch(
            Schema([Field(k.name, k.dtype) for k in key_series]), list(key_series)
        ).take(uniq_idx.astype(np.uint64))
        return parts, keys

    def _split_by_ids(self, part_ids: np.ndarray, num_partitions: int) -> List["RecordBatch"]:
        order = np.argsort(part_ids, kind="stable")
        sorted_ids = part_ids[order]
        boundaries = np.searchsorted(sorted_ids, np.arange(num_partitions + 1))
        reordered = self.take(order.astype(np.uint64))
        return [
            reordered.slice(int(boundaries[i]), int(boundaries[i + 1] - boundaries[i]))
            for i in range(num_partitions)
        ]

    # ------------------------------------------------------------------ #
    # Joins (Arrow Acero — native C++ hash join)                          #
    # ------------------------------------------------------------------ #
    def hash_join(self, right: "RecordBatch", left_on: Sequence[Series], right_on: Sequence[Series],
                  how: str = "inner", suffix: str = "right.") -> "RecordBatch":
        """Equi-join via Acero (reference: src/daft-recordbatch/src/ops/joins)."""
        how_map = {
            "inner": "inner", "left": "left outer", "right": "right outer",
            "outer": "full outer", "semi": "left semi", "anti": "left anti",
        }
        if how not in how_map:
            raise DaftValueError(f"Unknown join type: {how}")
        lkeys = [f"__jk_l_{i}" for i in range(len(left_on))]
        rkeys = [f"__jk_r_{i}" for i in range(len(right_on))]
        # Build each side's table from data + key arrays in ONE construction:
        # a side whose data columns were all pruned away (e.g. count(*) over
        # a key-only join) has a zero-column/zero-row arrow table that
        # append_column would reject. Acero supports NO null-dtype field —
        # key or payload — so all-None columns ride as int8 all-null arrays
        # (join semantics unchanged: null keys never match) and downstream
        # schema conformance restores the planned dtype.
        def widen_null(dt: DataType) -> DataType:
            return DataType.int8() if dt.is_null() else dt

        def arrow_col(c: Series):
            if c.dtype.is_null():
                return pa.nulls(len(c), pa.int8())
            return c.to_arrow()

        commons = [widen_null(unify_dtypes(lk.dtype, rk.dtype))
                   for lk, rk in zip(left_on, right_on)]
        lt = pa.table({
            **{n: arrow_col(c) for n, c in zip(self.column_names(), self._columns)},
            **{lkeys[i]: left_on[i].cast(commons[i]).to_arrow()
               for i in range(len(left_on))},
        })
        rt = pa.table({
            **{n: arrow_col(c) for n, c in zip(right.column_names(), right._columns)},
            **{rkeys[i]: right_on[i].cast(commons[i]).to_arrow()
               for i in range(len(right_on))},
        })
        # Disambiguate overlapping non-key output names before joining.
        overlap = set(self.column_names()) & set(right.column_names())
        if how in ("semi", "anti"):
            overlap = set()
        rename = {n: f"{suffix}{n}" for n in overlap}
        if rename:
            rt = rt.rename_columns([rename.get(n, n) for n in rt.schema.names])
        # Acero's HashJoinNode always BUILDS on the right input. When the
        # right side is much larger, flip the call so the hash table is built
        # over the small side and the big side streams as the probe
        # (reference: build-side choice in src/daft-physical-plan join
        # strategy). semi/anti flip to their right-variants, which emit the
        # original left rows.
        flip_map = {"inner": "inner", "semi": "right semi", "anti": "right anti",
                    "left": "right outer", "right": "left outer",
                    "outer": "full outer"}
        if how in flip_map and len(rt) > 2 * max(len(lt), 1):
            joined = rt.join(
                lt, keys=rkeys, right_keys=lkeys, join_type=flip_map[how],
                left_suffix="", right_suffix="",
            )
        else:
            joined = lt.join(
                rt, keys=lkeys, right_keys=rkeys, join_type=how_map[how],
                left_suffix="", right_suffix="",
            )
        keep = [n for n in joined.schema.names if not n.startswith("__jk_")]
        joined = joined.select(keep)
        return RecordBatch.from_arrow_table(joined)

    def asof_join(self, right: "RecordBatch", left_on: Series, right_on: Series,
                  left_by: Sequence[Series] = (), right_by: Sequence[Series] = (),
                  direction: str = "backward", suffix: str = "right.") -> "RecordBatch":
        """As-of (nearest-key) join: for each left row, the right row with the
        greatest on-key <= left key (backward) / least >= (forward), within
        equal `by` groups (reference: asof join in swordfish join operators,
        src/daft-local-execution/src/join + benchmarking/asof_join)."""
        if direction not in ("backward", "forward"):
            raise DaftValueError(f"asof direction must be backward/forward, got {direction}")
        n_left = len(self)
        match_idx = np.full(n_left, -1, dtype=np.int64)
        if len(right) and n_left:
            if left_by:
                # Group by the by-keys; combine left+right so codes align.
                all_by = [Series.concat([lb, rb]) for lb, rb in zip(left_by, right_by)]
                codes, _ = _group_codes(all_by)
                l_g, r_g = codes[:n_left], codes[n_left:]
            else:
                l_g = np.zeros(n_left, dtype=np.int64)
                r_g = np.zeros(len(right), dtype=np.int64)
            # Rows with a null on-key never match (to_numpy alone would fill
            # nulls with 0 and let them match key 0 spuriously).
            l_vals, l_null = left_on.to_numpy_masked()
            r_vals, r_null = right_on.to_numpy_masked()
            l_ok = np.ones(n_left, dtype=bool) if l_null is None else ~l_null
            r_ok = np.ones(len(right), dtype=bool) if r_null is None else ~r_null
            for g in np.unique(np.concatenate([l_g, r_g])):
                li = np.nonzero((l_g == g) & l_ok)[0]
                ri = np.nonzero((r_g == g) & r_ok)[0]
                if len(li) == 0 or len(ri) == 0:
                    continue
                order = np.argsort(r_vals[ri], kind="stable")
                sorted_r = r_vals[ri][order]
                if direction == "backward":
                    pos = np.searchsorted(sorted_r, l_vals[li], side="right") - 1
                    valid = pos >= 0
                else:
                    pos = np.searchsorted(sorted_r, l_vals[li], side="left")
                    valid = pos < len(sorted_r)
                match_idx[li[valid]] = ri[order[pos[valid].clip(0, len(sorted_r) - 1)]]
        matched = match_idx >= 0
        safe_idx = np.where(matched, match_idx, 0).astype(np.uint64)
        overlap = set(self.column_names()) & set(right.column_names())
        out_cols = list(self._columns)
        for c in right.columns():
            name = f"{suffix}{c.name}" if c.name in overlap else c.name
            if len(right) == 0 or not matched.any():
                # Nothing to take from (or nothing matched): all-null column.
                out_cols.append(Series.null(name, c.dtype, n_left))
                continue
            taken = c.take(safe_idx)
            if not matched.all():
                taken = taken._with_mask(~matched)
            out_cols.append(taken.rename(name))
        return RecordBatch(Schema([Field(c.name, c.dtype) for c in out_cols]),
                           out_cols, n_left)

    def cross_join(self, right: "RecordBatch", suffix: str = "right.") -> "RecordBatch":
        n_l, n_r = len(self), len(right)
        left_idx = np.repeat(np.arange(n_l, dtype=np.uint64), n_r)
        right_idx = np.tile(np.arange(n_r, dtype=np.uint64), n_l)
        lt = self.take(left_idx)
        rt = right.take(right_idx)
        overlap = set(self.column_names()) & set(right.column_names())
        cols = lt.columns() + [
            c.rename(f"{suffix}{c.name}") if c.name in overlap else c for c in rt.columns()
        ]
        return RecordBatch(Schema([Field(c.name, c.dtype) for c in cols]), cols, n_l * n_r)

    def sort_merge_join(self, right: "RecordBatch", left_on: Sequence[Series],
                        right_on: Sequence[Series], is_sorted: bool = False) -> "RecordBatch":
        # Acero's hash join produces identical results for equi-joins.
        return self.hash_join(right, left_on, right_on, how="inner")

    # ------------------------------------------------------------------ #
    # Reshaping                                                           #
    # ------------------------------------------------------------------ #
    def explode(self, columns: Sequence[str],
                ignore_empty_and_null: bool = False) -> "RecordBatch":
        """Explode list columns (all listed columns must align per-row).
        Empty/null lists yield one null row, or no row at all with
        ``ignore_empty_and_null`` (reference: daft-functions-list explode's
        ignore_empty_and_null flag).

        Reference: src/daft-recordbatch explode + daft-functions-list.
        """
        if not columns:
            raise DaftValueError("explode requires at least one column")
        first = self.get_column(columns[0])
        if not first.dtype.is_list():
            raise DaftTypeError(f"Cannot explode non-list column {columns[0]!r}")
        arr = first.to_arrow()
        lengths = pc.list_value_length(arr)
        lengths_np = np.asarray(pc.fill_null(lengths, 0)).astype(np.int64)
        # All exploded columns must align per-row (reference explode semantics).
        for name in columns[1:]:
            other = self.get_column(name)
            if not other.dtype.is_list():
                raise DaftTypeError(f"Cannot explode non-list column {name!r}")
            other_lengths = np.asarray(
                pc.fill_null(pc.list_value_length(other.to_arrow()), 0)
            ).astype(np.int64)
            if not np.array_equal(other_lengths, lengths_np):
                raise DaftValueError(
                    f"explode columns {columns[0]!r} and {name!r} have mismatched "
                    "list lengths"
                )
        # Empty lists and nulls produce one null row (matches reference
        # default semantics) unless the caller asked to drop them.
        out_counts = lengths_np if ignore_empty_and_null else np.maximum(lengths_np, 1)
        parent_idx = np.repeat(np.arange(self._num_rows, dtype=np.int64), out_counts)
        new_cols = []
        exploded_len = int(out_counts.sum())
        for c in self._columns:
            if c.name in columns:
                if not c.dtype.is_list():
                    raise DaftTypeError(f"Cannot explode non-list column {c.name!r}")
                new_cols.append(_explode_series(c, out_counts, exploded_len,
                                                ignore_empty_and_null))
            else:
                new_cols.append(c.take(parent_idx.astype(np.uint64)))
        schema = Schema([Field(c.name, c.dtype) for c in new_cols])
        return RecordBatch(schema, new_cols, exploded_len)

    def unpivot(self, ids: Sequence[str], values: Sequence[str],
                variable_name: str = "variable", value_name: str = "value") -> "RecordBatch":
        if not values:
            raise DaftValueError("unpivot requires value columns")
        val_dtype = DataType.null()
        for v in values:
            val_dtype = unify_dtypes(val_dtype, self.get_column(v).dtype)
        pieces = []
        for v in values:
            cols = [self.get_column(i) for i in ids]
            cols = cols + [
                Series.full(variable_name, v, self._num_rows, DataType.string()),
                self.get_column(v).cast(val_dtype).rename(value_name),
            ]
            pieces.append(RecordBatch(Schema([Field(c.name, c.dtype) for c in cols]), cols, self._num_rows))
        return RecordBatch.concat(pieces)

    def pivot(self, group_by: Sequence[Series], pivot_col: Series, value_col: Series,
              names: Sequence[str]) -> "RecordBatch":
        parts, keys = self.partition_by_value(list(group_by))
        pivot_name = pivot_col.name
        value_name = value_col.name
        out_value_dtype = value_col.dtype
        col_data: Dict[str, list] = {n: [] for n in names}
        for part in parts:
            pv = part.get_column(pivot_name).to_pylist()
            vv = part.get_column(value_name).to_pylist()
            lookup = dict(zip((str(p) for p in pv), vv))
            for n in names:
                col_data[n].append(lookup.get(n))
        cols = list(keys.columns())
        for n in names:
            cols.append(Series.from_pylist(col_data[n], n, out_value_dtype))
        return RecordBatch(Schema([Field(c.name, c.dtype) for c in cols]), cols, len(keys))

    # ------------------------------------------------------------------ #
    # Aggregation                                                         #
    # ------------------------------------------------------------------ #
    def agg(self, agg_exprs: Sequence, group_by: Sequence = ()) -> "RecordBatch":
        from daft_tpu_torch.expressions.agg_eval import eval_aggregation

        return eval_aggregation(self, agg_exprs, group_by)

    def distinct(self, on: Optional[Sequence[str]] = None) -> "RecordBatch":
        keys = [self.get_column(n) for n in (on or self.column_names())]
        group_ids, uniq_idx = _group_codes(keys)
        return self.take(uniq_idx.astype(np.uint64))

    # ------------------------------------------------------------------ #
    # Display                                                             #
    # ------------------------------------------------------------------ #
    def preview_string(self, max_rows: int = 8) -> str:
        head = self.head(max_rows)
        names = [f"{f.name}\n{f.dtype!r}" for f in self._schema]
        cols = [c.to_pylist() for c in head.columns()]
        widths = []
        rendered = []
        for name, col in zip(names, cols):
            cells = [_render_cell(v) for v in col]
            w = max([len(line) for line in name.split("\n")] + [len(c) for c in cells] + [4])
            w = min(w, 32)
            widths.append(w)
            rendered.append([c[:w] for c in cells])
        header1 = " | ".join(n.split("\n")[0].ljust(w) for n, w in zip(names, widths))
        header2 = " | ".join(n.split("\n")[1].ljust(w) for n, w in zip(names, widths))
        sep = "-+-".join("-" * w for w in widths)
        lines = [header1, header2, sep]
        for i in range(len(head)):
            lines.append(" | ".join(r[i].ljust(w) for r, w in zip(rendered, widths)))
        if self._num_rows > max_rows:
            lines.append(f"... ({self._num_rows} rows total)")
        return "\n".join(lines)


def _row_ge(key_series: Sequence[Series], boundaries: "RecordBatch", b: int,
            descending: Sequence[bool],
            nulls_first: Optional[Sequence[bool]] = None) -> np.ndarray:
    """Lexicographic per-row test: does each row sort at-or-after boundary b?

    Used by range partitioning; honours per-key descending and nulls_first
    flags (defaults match sort defaults: nulls last ascending / first
    descending).
    """
    n = len(key_series[0]) if key_series else 0
    if nulls_first is None:
        nulls_first = list(descending)
    result = np.zeros(n, dtype=bool)      # rows strictly decided >= boundary
    undecided = np.ones(n, dtype=bool)    # rows equal on all keys so far
    for i, (key, desc, nf) in enumerate(zip(key_series, descending, nulls_first)):
        bound_col = boundaries.columns()[i]
        bound_val = bound_col.slice(b, 1)
        rep = Series.concat([bound_val] * n) if n else bound_val.head(0)
        kv, km = key.to_numpy_masked()
        bv, bm = rep.to_numpy_masked()
        k_null = km if km is not None else np.zeros(n, dtype=bool)
        b_null = bm if bm is not None else np.zeros(n, dtype=bool)
        with np.errstate(invalid="ignore"):
            gt = np.zeros(n, dtype=bool)
            eq = np.zeros(n, dtype=bool)
            both_valid = ~k_null & ~b_null
            if both_valid.any():
                gt[both_valid] = (kv[both_valid] < bv[both_valid]) if desc else (kv[both_valid] > bv[both_valid])
                eq[both_valid] = kv[both_valid] == bv[both_valid]
            if nf:
                # Nulls sort first -> any valid key is after a null bound.
                gt |= (~k_null) & b_null
            else:
                # Nulls sort last -> a null key is after any valid bound.
                gt |= k_null & (~b_null)
            eq |= k_null & b_null
        result |= undecided & gt
        undecided &= eq
    # Rows equal to the boundary on every key belong to the right partition.
    result |= undecided
    return result


def _render_cell(v: Any) -> str:
    if v is None:
        return "None"
    if isinstance(v, float):
        return f"{v:.6g}"
    if isinstance(v, np.ndarray):
        return f"<tensor{list(v.shape)}>"
    s = str(v)
    return s if len(s) <= 30 else s[:27] + "..."


def _explode_series(c: Series, out_counts: np.ndarray, exploded_len: int,
                    ignore_empty_and_null: bool = False) -> Series:
    arr = c.to_arrow()
    lengths = np.asarray(pc.fill_null(pc.list_value_length(arr), 0)).astype(np.int64)
    inner_dtype = c.dtype.inner
    flat = arr.flatten()  # non-null list values concatenated
    if ignore_empty_and_null:
        # Empty/null rows emit nothing, so the output IS the flattened values.
        return Series.from_arrow(flat, c.name, inner_dtype)
    # Build the output by interleaving flat values with nulls for empty/null rows.
    out_idx = np.zeros(exploded_len, dtype=np.int64)
    validity = np.ones(exploded_len, dtype=bool)
    pos = 0
    flat_pos = 0
    # Vectorised construction: rows with lengths>0 map to ranges; empties map to null.
    starts_out = np.concatenate([[0], np.cumsum(out_counts)[:-1]])
    flat_starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    nonempty = lengths > 0
    for i in np.nonzero(~nonempty)[0]:
        validity[starts_out[i]] = False
        out_idx[starts_out[i]] = 0
    ne_rows = np.nonzero(nonempty)[0]
    if len(ne_rows):
        reps = lengths[ne_rows]
        base = np.repeat(flat_starts[ne_rows], reps)
        offs_within = np.arange(int(reps.sum()), dtype=np.int64) - np.repeat(
            np.cumsum(reps) - reps, reps
        )
        dest = np.repeat(starts_out[ne_rows], reps) + offs_within
        out_idx[dest] = base + offs_within
        validity[dest] = True
    if len(flat) == 0:
        return Series.null(c.name, inner_dtype, exploded_len)
    taken = pc.take(flat, pa.array(out_idx))
    if not validity.all():
        taken = pc.if_else(pa.array(validity), taken, pa.nulls(exploded_len, taken.type))
    return Series.from_arrow(taken, c.name, inner_dtype)


def _packed_int_keys(keys: Sequence[Series]) -> Optional[np.ndarray]:
    """Two or more null-free integer keys of at most 64 bits together, packed
    into one int64 a row, else None. The packing is injective, so its dense
    ids and first occurrences are those of the per-column codes' combination,
    at one hash pass instead of one a column and one more for the combination."""
    if len(keys) < 2:
        return None
    arrays = []
    for k in keys:
        arr = None if k.dtype.is_python() else k.to_arrow()
        if (not isinstance(arr, pa.Array) or not pa.types.is_integer(arr.type)
                or arr.null_count):
            return None
        arrays.append(arr)
    if sum(a.type.bit_width for a in arrays) > 64:
        return None
    packed = np.zeros(len(arrays[0]), dtype=np.uint64)
    for a in arrays:
        w = a.type.bit_width
        packed = (packed << np.uint64(w)) | np.asarray(a).view(f"uint{w}").astype(np.uint64)
    return packed.view(np.int64)


def _group_codes(keys: Sequence[Series]) -> Tuple[np.ndarray, np.ndarray]:
    """(group_ids per row, first-occurrence row index per group)."""
    n = len(keys[0]) if keys else 0
    if not keys:
        return np.zeros(n, dtype=np.int64), np.zeros(1 if n else 0, dtype=np.int64)

    def _dense(combo: np.ndarray):
        """Hash-based dense group ids via Arrow dictionary encoding: O(n),
        ids numbered by first appearance (Arrow assigns dictionary slots in
        encounter order — no sort needed)."""
        enc = pc.dictionary_encode(
            pa.chunked_array([pa.array(combo)])).combine_chunks()
        inverse = np.asarray(enc.indices).astype(np.int64)
        num = len(enc.dictionary)
        first_idx = np.empty(num, dtype=np.int64)
        first_idx[inverse[::-1]] = np.arange(n - 1, -1, -1)
        return inverse, first_idx

    packed = _packed_int_keys(keys)
    if packed is not None:
        inverse, first_idx = _dense(packed)
        return inverse, first_idx
    codes = []
    radices = []
    for k in keys:
        arr = k.to_arrow() if not k.dtype.is_python() else None
        if arr is not None and not k.dtype.is_nested() and not k.dtype.is_logical():
            enc = pc.dictionary_encode(arr)
            idx = np.asarray(enc.indices.fill_null(-1)).astype(np.int64) + 1  # nulls -> 0
        else:
            # Nested / logical keys: dense codes from each value's repr.
            reprs = pa.array([repr(x) for x in k.to_pylist()], pa.string())
            idx = np.asarray(pc.dictionary_encode(reprs).indices).astype(np.int64)
        codes.append(idx)
        radices.append(int(idx.max()) + 1 if len(idx) else 1)

    # Combine per-column dense codes exactly: a single mixed-radix combo when
    # the whole key-space product fits in int64, else fold columns in
    # pairwise (dense_so_far * radix + code, re-densify) — after each
    # densify the running radix is <= n, so dense*next_radix stays within
    # int64 for any row count; no sort-based unique and no collisions.
    if len(codes) == 1:
        inverse, first_idx = _dense(codes[0])
    else:
        space = 1
        for r in radices:
            space *= r
        if space < 2 ** 62:
            combo = np.zeros(n, dtype=np.int64)
            for c, r in zip(codes, radices):
                combo = combo * np.int64(r) + c
            inverse, first_idx = _dense(combo)
        else:
            inverse, first_idx = _dense(codes[0])
            for c, r in zip(codes[1:], radices[1:]):
                combo = inverse * np.int64(r) + c
                inverse, first_idx = _dense(combo)
    return inverse, first_idx.astype(np.int64)
