"""Two-phase (partial → merge → finalize) global aggregation (port of
``daft_tpu/execution/aggregation.py``).

Reference: the reference's aggregate blocking sink aggregates each input
morsel partially and merges the partials at finalize
(src/daft-local-execution/src/sinks/aggregate.rs). Each AggOp decomposes into

* partial aggs — run per chunk (on the device when the chunk's program
  compiles, ``ops/compiled_eval.AggChainSpec``),
* merge aggs — re-aggregate the partial columns (associative),
* a final expr — computes the user-visible value from the merged columns.

The port decomposes sum, mean, min, max and count without group-by keys;
grouped aggregation, its spill and the distributed partial stage are not
ported yet.
"""

from __future__ import annotations

from typing import List, Sequence

from daft_tpu_torch.datatype import DataType
from daft_tpu_torch.errors import DaftNotImplementedError
from daft_tpu_torch.expressions.expr import AggOp, Alias, BinaryOp, Cast, ColumnRef, Expr
from daft_tpu_torch.recordbatch import RecordBatch
from daft_tpu_torch.schema import Schema


class TwoPhasePlan:
    """Decomposition of a global aggregation into partial/merge/final exprs."""

    def __init__(self, agg_exprs: Sequence[Expr], group_by: Sequence[Expr] = ()):
        if group_by:
            raise DaftNotImplementedError("grouped aggregation is not ported to daft_tpu_torch")
        self.group_by: List[Expr] = []
        self.partial_exprs: List[Expr] = []
        self.merge_exprs: List[Expr] = []
        counter = [0]

        def decompose(agg: AggOp) -> Expr:
            """Register partial+merge aggs; return the final expr for this agg."""
            i = counter[0]
            counter[0] += 1

            def add(suffix: str, partial: AggOp, merge_op: str) -> ColumnRef:
                name = f"__p{i}_{suffix}"
                self.partial_exprs.append(Alias(partial, name))
                self.merge_exprs.append(Alias(AggOp(merge_op, ColumnRef(name)), name))
                return ColumnRef(name)

            if agg.op in ("sum", "min", "max"):
                return add("v", AggOp(agg.op, agg.child), agg.op)
            if agg.op == "count":
                return Cast(add("c", AggOp("count", agg.child, agg.kwargs), "sum"), DataType.uint64())
            s = add("s", AggOp("sum", Cast(agg.child, DataType.float64())), "sum")
            c = add("c", AggOp("count", agg.child), "sum")
            return BinaryOp("truediv", s, Cast(c, DataType.float64()))

        self.final_exprs: List[Expr] = [
            Alias(e.transform(lambda n: decompose(n) if isinstance(n, AggOp) else None), e.name())
            for e in agg_exprs]


class AggState:
    """Partial batches in arrival order, merged once at finalize."""

    def __init__(self, agg_exprs: Sequence[Expr], out_schema: Schema, input_schema: Schema):
        self.plan = TwoPhasePlan(agg_exprs)
        self.out_schema = out_schema
        self.input_schema = input_schema
        self._partials: List[RecordBatch] = []

    def partial_schema(self) -> Schema:
        """Schema of the partial-state batches."""
        return Schema([e.to_field(self.input_schema) for e in self.plan.partial_exprs])

    def add_partial(self, rb: RecordBatch) -> None:
        self._partials.append(rb)

    def finalize(self) -> RecordBatch:
        from daft_tpu_torch.expressions.evaluator import evaluate

        if self._partials:
            merged = RecordBatch.concat(self._partials).agg(self.plan.merge_exprs)
        else:
            # A global aggregation over no rows still yields one row: the
            # partial phase over an empty batch of the input schema.
            merged = RecordBatch.empty(self.input_schema).agg(self.plan.partial_exprs)
        out_cols = [evaluate(e, merged).rename(e.name()) for e in self.plan.final_exprs]
        # Cast to the statically resolved output schema.
        casted = [c.cast(f.dtype) if c.dtype != f.dtype else c
                  for c, f in zip(out_cols, self.out_schema)]
        return RecordBatch(self.out_schema, casted, 1)
