"""Expression evaluation over RecordBatches (port of ``daft_tpu/expressions/evaluator.py``).

Reference: ``RecordBatch::eval_expression_list`` / ``eval_expression``
(src/daft-recordbatch/src/lib.rs:1623,1281). The host path walks the Expr tree
dispatching to Series ops and registry kernels; a ``UdfCall`` hands its
argument Series to the UDF, which is where the AI providers move a batch to
the GPU. With ``device_eval`` on, the numeric subtrees of a projection run on
``cfg.device`` instead, one cached program per expression set
(``ops/device_eval.py``).
"""

from __future__ import annotations

from typing import List, Sequence

from daft_tpu_torch.errors import DaftError, DaftValueError
from daft_tpu_torch.expressions.expr import (
    AggOp,
    Alias,
    BinaryOp,
    Cast,
    ColumnRef,
    Expr,
    FunctionCall,
    IfElse,
    IsIn,
    Literal,
    UdfCall,
    UnaryOp,
    WindowExpr,
)
from daft_tpu_torch.schema import Field, Schema
from daft_tpu_torch.series import Series

_BINARY_DISPATCH = {
    "add": lambda a, b: a + b,
    "sub": lambda a, b: a - b,
    "mul": lambda a, b: a * b,
    "truediv": lambda a, b: a / b,
    "floordiv": lambda a, b: a // b,
    "mod": lambda a, b: a % b,
    "pow": lambda a, b: a ** b,
    "eq": lambda a, b: a.eq(b),
    "ne": lambda a, b: a.ne(b),
    "lt": lambda a, b: a.lt(b),
    "le": lambda a, b: a.le(b),
    "gt": lambda a, b: a.gt(b),
    "ge": lambda a, b: a.ge(b),
    "eq_null_safe": lambda a, b: a.eq_null_safe(b),
    "and": lambda a, b: a.and_(b),
    "or": lambda a, b: a.or_(b),
    "xor": lambda a, b: a.xor_(b),
}

_UNARY_DISPATCH = {
    "not": Series.not_,
    "negate": Series.negate,
    "abs": Series.abs,
    "is_null": Series.is_null,
    "not_null": Series.not_null,
}


def evaluate(expr: Expr, rb) -> Series:
    n = len(rb)
    if isinstance(expr, ColumnRef):
        return rb.get_column(expr.name_)
    if isinstance(expr, Literal):
        return Series.full("literal", expr.value, n, expr.dtype)
    if isinstance(expr, Alias):
        return evaluate(expr.child, rb).rename(expr.alias)
    if isinstance(expr, Cast):
        return evaluate(expr.child, rb).cast(expr.dtype)
    if isinstance(expr, BinaryOp):
        a, b = evaluate(expr.left, rb), evaluate(expr.right, rb)
        if expr.op in ("lshift", "rshift"):
            av, am = a.to_numpy_masked()
            bv, bm = b.to_numpy_masked()
            out = (av << bv) if expr.op == "lshift" else (av >> bv)
            mask = am if bm is None else (bm if am is None else am | bm)
            return Series.from_numpy(out, a.name, a.dtype)._with_mask(mask)
        return _BINARY_DISPATCH[expr.op](a, b)
    if isinstance(expr, UnaryOp):
        return _UNARY_DISPATCH[expr.op](evaluate(expr.child, rb))
    if isinstance(expr, IsIn):
        items = expr.items
        if isinstance(items, Literal) and isinstance(items.value, (list, tuple)):
            vals = Series.from_pylist(list(items.value), "items")
        else:
            vals = evaluate(items, rb)
        return evaluate(expr.child, rb).is_in(vals)
    if isinstance(expr, IfElse):
        pred = evaluate(expr.pred, rb)
        return pred.if_else(evaluate(expr.if_true, rb), evaluate(expr.if_false, rb))
    if isinstance(expr, FunctionCall):
        from daft_tpu_torch.kernels.registry import get_kernel

        kernel = get_kernel(expr.fn_name)
        return kernel([evaluate(a, rb) for a in expr.args], **expr.kwargs)
    if isinstance(expr, UdfCall):
        args = [evaluate(a, rb) for a in expr.args]
        return expr.udf.evaluate(args, expr.kwargs).rename(expr.name())
    if isinstance(expr, AggOp):
        raise DaftValueError("Aggregation expression evaluated outside an aggregation context")
    if isinstance(expr, WindowExpr):
        raise DaftValueError("Window expression evaluated outside a Window plan node")
    raise DaftValueError(f"Cannot evaluate expression node {type(expr).__name__}")


def evaluate_to_batch(rb, exprs: Sequence[Expr]):
    from daft_tpu_torch.context import get_context
    from daft_tpu_torch.recordbatch import RecordBatch

    exprs = list(exprs)
    names = [e.name() for e in exprs]
    if len(set(names)) != len(names):
        raise DaftValueError(f"Duplicate output names in projection: {names}")
    series_out: List[Series] = [None] * len(exprs)  # type: ignore[list-item]
    if get_context().execution_config.device_eval:
        from daft_tpu_torch.ops.device_eval import try_evaluate_fused

        fused = try_evaluate_fused(rb, exprs)
        if fused is not None:
            for i, s in fused.items():
                series_out[i] = s
    for i, e in enumerate(exprs):
        if series_out[i] is None:
            s = evaluate(e, rb)
            # The resolved schema is the source of truth: the host and device
            # paths both cast their result to the resolved field's dtype.
            try:
                target = e.to_field(rb.schema).dtype
            except (DaftError, KeyError, TypeError, NotImplementedError):
                target = s.dtype  # unresolvable: trust the computed dtype
            if s.dtype != target and not target.is_null():
                s = s.cast(target)
            series_out[i] = s
    cols = [s.rename(nm) for s, nm in zip(series_out, names)]
    schema = Schema([Field(c.name, c.dtype) for c in cols])
    return RecordBatch(schema, cols, len(rb))


def resolve_schema(exprs: Sequence[Expr], input_schema: Schema) -> Schema:
    return Schema([e.to_field(input_schema) for e in exprs])
