"""Expression evaluation over RecordBatches (port of ``daft_tpu/expressions/evaluator.py``).

Reference: ``RecordBatch::eval_expression_list`` / ``eval_expression``
(src/daft-recordbatch/src/lib.rs:1623,1281). Evaluation walks the Expr tree on
the host; a ``UdfCall`` hands its argument Series to the UDF, which is where
the AI providers move a batch to the GPU. Not ported yet: the device-eval path
that fuses numeric subtrees (``daft_tpu/ops/device_eval.py``).
"""

from __future__ import annotations

from typing import Sequence

from daft_tpu_torch.errors import DaftValueError
from daft_tpu_torch.expressions.expr import Alias, ColumnRef, Expr, Literal, UdfCall
from daft_tpu_torch.schema import Field, Schema
from daft_tpu_torch.series import Series


def evaluate(expr: Expr, rb) -> Series:
    n = len(rb)
    if isinstance(expr, ColumnRef):
        return rb.get_column(expr.name_)
    if isinstance(expr, Literal):
        return Series.full("literal", expr.value, n, expr.dtype)
    if isinstance(expr, Alias):
        return evaluate(expr.child, rb).rename(expr.alias)
    if isinstance(expr, UdfCall):
        args = [evaluate(a, rb) for a in expr.args]
        return expr.udf.evaluate(args, expr.kwargs).rename(expr.name())
    raise DaftValueError(f"Cannot evaluate expression node {type(expr).__name__}")


def evaluate_to_batch(rb, exprs: Sequence[Expr]):
    from daft_tpu_torch.recordbatch import RecordBatch

    names = [e.name() for e in exprs]
    if len(set(names)) != len(names):
        raise DaftValueError(f"Duplicate output names in projection: {names}")
    cols = [evaluate(e, rb).rename(nm) for e, nm in zip(exprs, names)]
    schema = Schema([Field(c.name, c.dtype) for c in cols])
    return RecordBatch(schema, cols, len(rb))


def resolve_schema(exprs: Sequence[Expr], input_schema: Schema) -> Schema:
    return Schema([e.to_field(input_schema) for e in exprs])
