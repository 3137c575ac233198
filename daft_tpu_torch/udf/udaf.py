"""User-defined aggregation functions (port of ``daft_tpu/udf/udaf.py``).

Reference: daft/udf/udaf.py — UDAFs aggregate a column per group. Two forms:

* a plain function ``fn(values: list) -> scalar``;
* a class with ``accumulate(values) / finalize()``; adding ``merge(other)``
  opts into INCREMENTAL two-phase aggregation: each partition accumulates
  into its own instance, states merge pairwise, finalize runs once —
  bounded memory per group, no collect-all.

Function UDAFs (no merge) fall back to list-collect → concat → apply,
which stays exact for arbitrary functions. The partial state travels as
``cloudpickle`` bytes, as in the JAX package: a class defined inside a
function pickles by value.
"""

from __future__ import annotations

from typing import Any, Optional

from daft_tpu_torch.datatype import DataType
from daft_tpu_torch.errors import DaftValueError


class Udaf:
    def __init__(self, fn_or_cls, return_dtype: DataType, name: Optional[str] = None):
        self.fn_or_cls = fn_or_cls
        self.return_dtype = return_dtype
        self.name = name or getattr(fn_or_cls, "__name__", "udaf")

    def apply(self, values: list) -> Any:
        target = self.fn_or_cls
        if isinstance(target, type):
            inst = target()
            inst.accumulate(values)
            return inst.finalize()
        return target(values)

    def supports_partial(self) -> bool:
        return isinstance(self.fn_or_cls, type) and hasattr(self.fn_or_cls, "merge")

    def partial_state(self, values: list) -> bytes:
        import cloudpickle

        inst = self.fn_or_cls()
        inst.accumulate(values)
        return cloudpickle.dumps(inst)

    def merge_states(self, blobs: list) -> bytes:
        import cloudpickle

        if not blobs:
            return self.partial_state([])
        inst = cloudpickle.loads(blobs[0])
        for b in blobs[1:]:
            inst.merge(cloudpickle.loads(b))
        return cloudpickle.dumps(inst)

    def finalize_state(self, blob: bytes) -> Any:
        import cloudpickle

        return cloudpickle.loads(blob).finalize()

    def __call__(self, expr) -> "Expression":
        from daft_tpu_torch.expressions.expr import AggOp, ensure_expr
        from daft_tpu_torch.expressions.expression import Expression

        return Expression(AggOp("udaf", ensure_expr(expr), {"udaf": self}))


def udaf(return_dtype: DataType, name: Optional[str] = None):
    """Decorator: ``@udaf(DataType.float64())`` over a function or class
    (reference: daft.udf.udaf)."""

    def deco(fn_or_cls):
        if isinstance(fn_or_cls, type):
            for required in ("accumulate", "finalize"):
                if not hasattr(fn_or_cls, required):
                    raise DaftValueError(f"UDAF class needs a {required}() method")
        return Udaf(fn_or_cls, return_dtype, name)

    return deco
