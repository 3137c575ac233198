"""Global aggregation evaluation (port of ``daft_tpu/expressions/agg_eval.py``).

Reference: agg kernels in src/daft-core/src/array/ops. Composite aggregation
expressions (``(col('a') * 2).sum() + 1``) are decomposed: the inner AggOp
nodes are computed, then the outer expression is evaluated over their
one-row results, as the reference's planner extracts AggExprs from
projections. The port evaluates global (no group-by) aggregations of sum,
mean, min, max and count; grouped aggregation is not ported yet.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from daft_tpu_torch.errors import DaftNotImplementedError
from daft_tpu_torch.expressions.evaluator import evaluate
from daft_tpu_torch.expressions.expr import AggOp, Alias, ColumnRef, Expr
from daft_tpu_torch.schema import Field, Schema
from daft_tpu_torch.series import Series


def _decompose(exprs: Sequence[Expr]) -> Tuple[List[Tuple[str, AggOp]], List[Expr]]:
    """Extract the unique AggOp nodes; rewrite the outer exprs to reference them."""
    aggs: List[Tuple[str, AggOp]] = []
    keys: Dict[tuple, str] = {}

    def rewrite(e: Expr):
        if isinstance(e, AggOp):
            k = e.key()
            if k not in keys:
                keys[k] = f"__agg_{len(aggs)}"
                aggs.append((keys[k], e))
            return ColumnRef(keys[k])
        return None

    # Keep each original output name: the rewritten tree's natural name would
    # be the synthetic __agg_N column.
    return aggs, [Alias(e.transform(rewrite), e.name()) for e in exprs]


def eval_aggregation(rb, agg_exprs: Sequence[Expr], group_by: Sequence[Expr] = ()):
    from daft_tpu_torch.recordbatch import RecordBatch

    if group_by:
        raise DaftNotImplementedError("grouped aggregation is not ported to daft_tpu_torch")
    named_aggs, outer = _decompose(list(agg_exprs))
    agg_cols = [_global_agg(evaluate(agg.child, rb), agg).rename(name) for name, agg in named_aggs]
    inter = RecordBatch(Schema([Field(c.name, c.dtype) for c in agg_cols]), agg_cols, 1)
    out_cols = [evaluate(e, inter).rename(e.name()) for e in outer]
    return RecordBatch(Schema([Field(c.name, c.dtype) for c in out_cols]), out_cols, 1)


def _global_agg(child: Series, agg: AggOp) -> Series:
    op = agg.op
    if op == "sum":
        return child.sum()
    if op == "mean":
        return child.mean()
    if op == "min":
        return child.min()
    if op == "max":
        return child.max()
    return child.count(agg.kwargs.get("mode", "valid"))
