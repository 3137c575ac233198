"""Two-phase (partial → merge → finalize) aggregation, global and grouped
(port of ``daft_tpu/execution/aggregation.py``).

Reference: the reference's grouped-aggregate blocking sink aggregates each input
morsel partially and merges the partials at finalize
(src/daft-local-execution/src/sinks/{aggregate,grouped_aggregate}.rs). Each
AggOp decomposes into

* partial aggs — run per chunk (a global aggregation's on the device when the
  chunk's program compiles, ``ops/compiled_eval.AggChainSpec``; a grouped
  one's through Acero on the host),
* merge aggs — re-aggregate the partial columns by the group keys (associative),
* a final expr — computes the user-visible value from the merged columns.

The port decomposes every aggregation of the JAX package but the UDAFs
(``AggOp.LEFT_OUT``, ROADMAP A.2): the moments, the list partials
(``median``, ``string_agg``, ``list``, ``concat``, ``count_distinct``,
``approx_count_distinct``, merged by ``concat`` and finished by a list kernel),
the DDSketch partials of ``approx_percentile`` and ``skew`` with its
``pow_3_2`` final. The distributed partial stage is not ported (A.8). ``approx_size_bytes`` is
the state-size estimate the executor's grace aggregation spills on under a
memory limit.
"""

from __future__ import annotations

from typing import List, Sequence

from daft_tpu_torch.datatype import DataType
from daft_tpu_torch.errors import DaftValueError
from daft_tpu_torch.expressions.expr import (
    AggOp,
    Alias,
    BinaryOp,
    Cast,
    ColumnRef,
    Expr,
    FunctionCall,
    Literal,
)
from daft_tpu_torch.micropartition import MicroPartition
from daft_tpu_torch.recordbatch import RecordBatch
from daft_tpu_torch.schema import Field, Schema


class TwoPhasePlan:
    """Decomposition of a full aggregation into partial/merge/final exprs."""

    def __init__(self, agg_exprs: Sequence[Expr], group_by: Sequence[Expr]):
        self.group_by = list(group_by)
        self.key_names = [g.name() for g in self.group_by]
        self.partial_exprs: List[Expr] = []
        self.merge_exprs: List[Expr] = []
        counter = [0]

        def decompose(agg: AggOp) -> Expr:
            """Register partial+merge aggs; return the final expr for this agg."""
            i = counter[0]
            counter[0] += 1
            op = agg.op
            child = agg.child

            def add(suffix: str, partial: AggOp, merge_op: str, merge_kwargs=None) -> ColumnRef:
                name = f"__p{i}_{suffix}"
                self.partial_exprs.append(Alias(partial, name))
                self.merge_exprs.append(Alias(AggOp(merge_op, ColumnRef(name), merge_kwargs), name))
                return ColumnRef(name)

            if op in ("sum", "min", "max", "bool_and", "bool_or", "product"):
                return add("v", AggOp(op, child), op)
            if op == "median":
                lst = add("l", AggOp("list", Cast(child, DataType.float64())), "concat")
                return FunctionCall("list_quantile", [lst], {"percentiles": 0.5})
            if op == "string_agg":
                lst = add("l", AggOp("list", child), "concat")
                sep = agg.kwargs.get("sep", ",")
                return FunctionCall("list_join", [FunctionCall("list_compact", [lst]),
                                                  Literal(sep)])
            if op == "any_value":
                return add("v", agg, "any_value", agg.kwargs)
            if op == "count":
                return Cast(add("c", AggOp("count", child, agg.kwargs), "sum"), DataType.uint64())
            if op == "mean":
                s = add("s", AggOp("sum", Cast(child, DataType.float64())), "sum")
                c = add("c", AggOp("count", child), "sum")
                return BinaryOp("truediv", s, Cast(c, DataType.float64()))
            if op == "list":
                return add("l", AggOp("list", child), "concat")
            if op == "concat":
                return add("l", AggOp("concat", child), "concat")
            if op in ("count_distinct", "approx_count_distinct"):
                lst = add("l", AggOp("list", child), "concat")
                return FunctionCall("list_count_distinct", [lst])
            if op in ("stddev", "variance"):
                cf = Cast(child, DataType.float64())
                s = add("s", AggOp("sum", cf), "sum")
                s2 = add("s2", AggOp("sum", BinaryOp("mul", cf, cf)), "sum")
                c = add("c", AggOp("count", child), "sum")
                c_f = Cast(c, DataType.float64())
                mean = BinaryOp("truediv", s, c_f)
                var = BinaryOp("sub", BinaryOp("truediv", s2, c_f), BinaryOp("mul", mean, mean))
                var = FunctionCall("clip", [var], {"min": 0.0, "max": None})
                return var if op == "variance" else FunctionCall("sqrt", [var])
            if op == "skew":
                cf = Cast(child, DataType.float64())
                s = add("s", AggOp("sum", cf), "sum")
                s2 = add("s2", AggOp("sum", BinaryOp("mul", cf, cf)), "sum")
                s3 = add("s3", AggOp("sum", BinaryOp("mul", BinaryOp("mul", cf, cf), cf)), "sum")
                c = add("c", AggOp("count", child), "sum")
                c_f = Cast(c, DataType.float64())
                m = BinaryOp("truediv", s, c_f)
                m2 = BinaryOp("sub", BinaryOp("truediv", s2, c_f), BinaryOp("mul", m, m))
                m3 = BinaryOp(
                    "add",
                    BinaryOp("sub", BinaryOp("truediv", s3, c_f),
                             BinaryOp("mul", BinaryOp("mul", m, BinaryOp("truediv", s2, c_f)),
                                      Cast(Literal(3.0), DataType.float64()))),
                    BinaryOp("mul", Cast(Literal(2.0), DataType.float64()),
                             BinaryOp("mul", BinaryOp("mul", m, m), m)),
                )
                return BinaryOp("truediv", m3, FunctionCall("pow_3_2", [m2]))
            if op == "dd_sketch":
                # Re-decomposition of an already-partial plan: sketches are
                # their own partial form and merge in sketch space.
                return add("v", agg, "dd_merge")
            if op == "approx_percentile":
                # Bounded-memory two-phase: DDSketch partials merged in
                # sketch space (reference: src/daft-sketch).
                sk = add("sk", AggOp("dd_sketch", Cast(child, DataType.float64())), "dd_merge")
                return FunctionCall("dd_quantile", [sk],
                                    {"percentiles": agg.kwargs.get("percentiles")})
            raise DaftValueError(f"Cannot decompose agg op {op}")

        self.final_exprs: List[Expr] = [
            Alias(e.transform(lambda n: decompose(n) if isinstance(n, AggOp) else None), e.name())
            for e in agg_exprs]
        self.merge_group_by = [ColumnRef(n) for n in self.key_names]


class AggState:
    """Streaming aggregation state: partial-agg each morsel, periodically merge
    (bounded memory), finalize at end-of-stream."""

    MERGE_THRESHOLD_ROWS = 1 << 20

    def __init__(self, agg_exprs: Sequence[Expr], group_by: Sequence[Expr], out_schema: Schema,
                 input_schema: Schema = None):
        self.plan = TwoPhasePlan(agg_exprs, group_by)
        self.out_schema = out_schema
        self.input_schema = input_schema
        self._raw: List[RecordBatch] = []      # un-aggregated input morsels
        self._raw_rows = 0
        self._approx_bytes = 0  # running total: size_bytes() once per batch
        # Partial-form batches. INVARIANT: each entry is the output of a
        # grouped aggregation (a flush, a merge, or an ingested partial), so
        # group keys are unique WITHIN a batch: a merge pass is needed exactly
        # when len(_buffers) > 1.
        self._buffers: List[RecordBatch] = []
        self._buffer_rows = 0
        self._merged_rows = 0  # rows of the last merge's output (0: none yet)
        self._needs_merge = False  # set when an ingested batch may break the invariant

    def accumulate(self, mp: MicroPartition) -> None:
        """Buffer raw morsels; partial-agg only when the buffer exceeds the
        threshold. High-cardinality group-bys (most groups unique per morsel)
        would otherwise pay a grouped pass per morsel PLUS a merge pass at the
        end: buffering makes the common in-memory case one hash aggregation."""
        rb = mp.combined()
        if len(rb) == 0:
            return
        self._raw.append(rb)
        self._raw_rows += len(rb)
        self._approx_bytes += rb.size_bytes()
        if self._raw_rows > self.MERGE_THRESHOLD_ROWS:
            self._flush_raw()
            if self._merge_due():
                self._merge()

    def _merge_due(self) -> bool:
        """Merge once the partials pass the threshold and the rows added since
        the last merge outnumber its output (C.38). The JAX package merges on
        every flush past the threshold, so a state of G groups that barely
        shrinks is re-merged whole each time: quadratic in the input. Waiting
        for the new rows to match the merged ones costs at most twice the
        input in merge work; a merge that shrinks the state (few groups) is
        due exactly where the reference's is."""
        return (self._buffer_rows > self.MERGE_THRESHOLD_ROWS
                and self._buffer_rows - self._merged_rows > self._merged_rows)

    def _flush_raw(self) -> None:
        if not self._raw:
            return
        partial = RecordBatch.concat(self._raw).agg(self.plan.partial_exprs, self.plan.group_by)
        self._approx_bytes -= sum(rb.size_bytes() for rb in self._raw)
        self._raw = []
        self._raw_rows = 0
        self._buffers.append(partial)
        self._buffer_rows += len(partial)
        self._approx_bytes += partial.size_bytes()

    def _merge(self) -> None:
        self._flush_raw()
        if len(self._buffers) <= 1 and not self._needs_merge:
            return  # a single partial batch: groups already unique (invariant)
        if not self._buffers:
            return
        merged = RecordBatch.concat(self._buffers).agg(self.plan.merge_exprs,
                                                        self.plan.merge_group_by)
        self._approx_bytes -= sum(rb.size_bytes() for rb in self._buffers)
        self._buffers = [merged]
        self._buffer_rows = self._merged_rows = len(merged)
        self._approx_bytes += merged.size_bytes()
        self._needs_merge = False

    def fork(self) -> "AggState":
        """Independent copy sharing the (immutable) plan and batches: absorb a
        delta into the fork and finalize it; the original stays untouched."""
        clone = AggState.__new__(AggState)
        clone.plan = self.plan
        clone.out_schema = self.out_schema
        clone.input_schema = self.input_schema
        clone._raw = list(self._raw)
        clone._raw_rows = self._raw_rows
        clone._approx_bytes = self._approx_bytes
        clone._buffers = list(self._buffers)
        clone._buffer_rows = self._buffer_rows
        clone._merged_rows = self._merged_rows
        clone._needs_merge = self._needs_merge
        return clone

    def approx_size_bytes(self) -> int:
        """Approximate resident bytes of the buffered raw and partial state
        (the grace aggregation spills on it). Kept as a running total: it is
        read per morsel."""
        return self._approx_bytes

    def partial_batches(self) -> List[RecordBatch]:
        """The merged partial state."""
        self._merge()
        return list(self._buffers)

    def accumulate_partial(self, rb: RecordBatch) -> None:
        """Ingest an already-partial batch, merging past the threshold."""
        if len(rb) == 0:
            return
        self._buffers.append(rb)
        self._buffer_rows += len(rb)
        self._approx_bytes += rb.size_bytes()
        if self._merge_due():
            self._merge()

    def add_partial(self, rb: RecordBatch) -> None:
        """Buffer a partial batch WITHOUT threshold merging: the executor's
        in-memory aggregation merges exactly once at finalize. The threshold
        merge is wrong there: once the merged state itself exceeds the
        threshold (high group counts), every further partial would trigger a
        full O(groups) re-merge, turning ingestion quadratic."""
        if len(rb) == 0:
            return
        self._buffers.append(rb)
        self._buffer_rows += len(rb)
        self._approx_bytes += rb.size_bytes()

    def accumulate_unmerged_partial(self, rb: RecordBatch) -> None:
        """Ingest a partial batch that may hold DUPLICATE group keys (a grace
        bucket's batch coalesces fragments of several spills): forces a merge
        pass before finalize even if it ends up the only buffered batch."""
        if len(rb) == 0:
            return
        self._needs_merge = True
        self.accumulate_partial(rb)

    def partial_schema(self, input_schema: Schema) -> Schema:
        """Schema of the partial-state batches: the key fields, then the partials."""
        key_fields = [g.to_field(input_schema) for g in self.plan.group_by]
        partial_fields = [e.to_field(input_schema) for e in self.plan.partial_exprs]
        return Schema(key_fields + partial_fields)

    def finalize(self) -> RecordBatch:
        from daft_tpu_torch.expressions.evaluator import evaluate

        self._flush_raw()
        if not self._buffers:
            if self.plan.group_by:
                return RecordBatch.empty(self.out_schema)
            # A global aggregation over no rows still yields one row: the
            # partial phase over an empty batch of the input schema.
            merged = RecordBatch.empty(self.input_schema).agg(self.plan.partial_exprs, [])
        else:
            self._merge()
            merged = self._buffers[0]
        key_cols = [merged.get_column(n) for n in self.plan.key_names]
        out_cols = key_cols + [evaluate(e, merged).rename(e.name()) for e in self.plan.final_exprs]
        out = RecordBatch(Schema([Field(c.name, c.dtype) for c in out_cols]), out_cols,
                          len(merged))
        # Cast to the statically resolved output schema.
        casted = []
        for f in self.out_schema:
            c = out.get_column(f.name)
            casted.append(c.cast(f.dtype) if c.dtype != f.dtype else c)
        return RecordBatch(self.out_schema, casted, len(out))
