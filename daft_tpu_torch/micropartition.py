"""MicroPartition: the unit of data that flows between operators.

Reference: src/daft-micropartition/src/micropartition.rs:35-53 — a schema +
a list of RecordBatches + metadata + optional statistics. Morsels streamed
through the execution engine are MicroPartitions; shuffle writes/reads move
MicroPartitions; scan tasks produce them.

Port of ``daft_tpu/micropartition.py``; ``agg`` is not ported (the executor
aggregates RecordBatches).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import pyarrow as pa

from daft_tpu_torch.errors import DaftValueError
from daft_tpu_torch.recordbatch import RecordBatch
from daft_tpu_torch.schema import Schema
from daft_tpu_torch.stats import TableStatistics


class MicroPartition:
    __slots__ = ("_schema", "_batches", "_statistics")

    def __init__(self, schema: Schema, batches: Sequence[RecordBatch],
                 statistics: Optional[TableStatistics] = None):
        self._schema = schema
        self._batches = [b for b in batches if len(b) > 0]
        self._statistics = statistics

    # ------------------------------------------------------------------ #
    @staticmethod
    def empty(schema: Optional[Schema] = None) -> "MicroPartition":
        return MicroPartition(schema or Schema.empty(), [])

    @staticmethod
    def from_record_batches(batches: Sequence[RecordBatch], schema: Optional[Schema] = None) -> "MicroPartition":
        if schema is None:
            if not batches:
                raise DaftValueError("from_record_batches with no batches requires a schema")
            schema = batches[0].schema
        return MicroPartition(schema, batches)

    @staticmethod
    def from_pydict(data: Dict[str, Any]) -> "MicroPartition":
        rb = RecordBatch.from_pydict(data)
        return MicroPartition(rb.schema, [rb])

    @staticmethod
    def from_arrow_table(table: pa.Table, schema: Optional[Schema] = None) -> "MicroPartition":
        rb = RecordBatch.from_arrow_table(table, schema)
        return MicroPartition(rb.schema, [rb])

    @staticmethod
    def concat(parts: Sequence["MicroPartition"]) -> "MicroPartition":
        if not parts:
            raise DaftValueError("Cannot concat zero MicroPartitions")
        schema = parts[0]._schema
        batches: List[RecordBatch] = []
        for p in parts:
            batches.extend(p._batches)
        return MicroPartition(schema, batches)

    # ------------------------------------------------------------------ #
    @property
    def schema(self) -> Schema:
        return self._schema

    @property
    def statistics(self) -> Optional[TableStatistics]:
        return self._statistics

    def __len__(self) -> int:
        return sum(len(b) for b in self._batches)

    def num_rows(self) -> int:
        return len(self)

    def size_bytes(self) -> int:
        return sum(b.size_bytes() for b in self._batches)

    def record_batches(self) -> List[RecordBatch]:
        return list(self._batches)

    def combined(self) -> RecordBatch:
        """Concatenate into a single RecordBatch (copying)."""
        if not self._batches:
            return RecordBatch.empty(self._schema)
        if len(self._batches) == 1:
            return self._batches[0]
        return RecordBatch.concat(self._batches)

    def __repr__(self) -> str:
        return f"MicroPartition(rows={len(self)}, batches={len(self._batches)}, schema={self._schema!r})"

    # ------------------------------------------------------------------ #
    # Relational ops delegate to the combined RecordBatch. Streaming ops
    # that preserve batch boundaries (eval/filter/slice) map per-batch.
    # ------------------------------------------------------------------ #
    def _map_batches(self, fn, schema: Optional[Schema] = None) -> "MicroPartition":
        out = [fn(b) for b in self._batches]
        return MicroPartition(schema or (out[0].schema if out else self._schema), out)

    def eval_expression_list(self, exprs) -> "MicroPartition":
        if not self._batches:
            from daft_tpu_torch.expressions.evaluator import resolve_schema

            return MicroPartition(resolve_schema(exprs, self._schema), [])
        return self._map_batches(lambda b: b.eval_expression_list(exprs))

    def filter(self, predicate) -> "MicroPartition":
        from daft_tpu_torch.expressions.evaluator import evaluate

        return MicroPartition(
            self._schema,
            [b.filter(evaluate(predicate, b)) for b in self._batches],
        )

    def head(self, n: int) -> "MicroPartition":
        out, remaining = [], n
        for b in self._batches:
            if remaining <= 0:
                break
            take = min(len(b), remaining)
            out.append(b.head(take))
            remaining -= take
        return MicroPartition(self._schema, out)

    def slice(self, start: int, length: int) -> "MicroPartition":
        return MicroPartition(self._schema, [self.combined().slice(start, length)])

    def sample(self, fraction=None, size=None, with_replacement=False, seed=None) -> "MicroPartition":
        return MicroPartition(self._schema, [self.combined().sample(fraction, size, with_replacement, seed)])

    def sort(self, sort_keys, descending, nulls_first=None) -> "MicroPartition":
        from daft_tpu_torch.expressions.evaluator import evaluate

        rb = self.combined()
        keys = [evaluate(k, rb) for k in sort_keys]
        return MicroPartition(self._schema, [rb.sort(keys, descending, nulls_first)])

    def agg(self, agg_exprs, group_by=()) -> "MicroPartition":
        rb = self.combined().agg(agg_exprs, group_by)
        return MicroPartition(rb.schema, [rb])

    def distinct(self, on=None) -> "MicroPartition":
        rb = self.combined().distinct(on)
        return MicroPartition(rb.schema, [rb])

    def explode(self, columns, ignore_empty_and_null: bool = False) -> "MicroPartition":
        out = [b.explode(columns, ignore_empty_and_null) for b in self._batches]
        schema = out[0].schema if out else self._schema
        return MicroPartition(schema, out)

    def partition_by_hash(self, key_exprs, num_partitions: int) -> List["MicroPartition"]:
        from daft_tpu_torch.expressions.evaluator import evaluate

        rb = self.combined()
        keys = [evaluate(k, rb) for k in key_exprs]
        parts = rb.partition_by_hash(keys, num_partitions)
        return [MicroPartition(self._schema, [p]) for p in parts]

    def partition_by_random(self, num_partitions: int, seed: int) -> List["MicroPartition"]:
        parts = self.combined().partition_by_random(num_partitions, seed)
        return [MicroPartition(self._schema, [p]) for p in parts]

    def to_arrow_table(self) -> pa.Table:
        return self.combined().to_arrow_table()

    def to_pydict(self) -> Dict[str, list]:
        return self.combined().to_pydict()

    def with_statistics(self, stats: Optional[TableStatistics]) -> "MicroPartition":
        return MicroPartition(self._schema, self._batches, stats)
