"""User-facing ``Expression`` wrapper (port of ``daft_tpu/expressions/expression.py``).

``col`` / ``lit`` build expressions; the operators build arithmetic,
comparison and logic; ``cast``, ``if_else``, ``abs``, the numeric functions of
``kernels/numeric.py``, the aggregations (sum, mean, min, max, count) and the
``.float`` / ``.embedding`` namespaces (the kernels of ``kernels/float_ops.py``
and ``kernels/embedding_ops.py``) are ported. Not ported yet: ``is_in``,
``between`` on subqueries, the shift operators, ``apply``, the other
aggregations and the ``.str`` / ``.list`` / ``.dt`` / ``.image`` namespaces.
"""

from __future__ import annotations

from typing import Any, Optional

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
    IfElse,
    Literal,
    UnaryOp,
    ensure_expr,
)
from daft_tpu_torch.schema import Field, Schema


def col(name: str) -> "Expression":
    """Reference a column by name (reference: daft.col)."""
    return Expression(ColumnRef(name))


def lit(value: Any, dtype: Optional[DataType] = None) -> "Expression":
    """A literal value expression (reference: daft.lit)."""
    return Expression(Literal(value, dtype))


class Expression:
    __slots__ = ("_expr",)

    def __init__(self, expr: Expr):
        self._expr = expr

    @staticmethod
    def _from_any(value: Any) -> "Expression":
        if isinstance(value, Expression):
            return value
        return lit(value)

    def to_field(self, schema: Schema) -> Field:
        return self._expr.to_field(schema)

    def name(self) -> str:
        return self._expr.name()

    def __repr__(self) -> str:
        return repr(self._expr)

    def __bool__(self) -> bool:
        raise DaftValueError(
            "Expressions are lazy; use & | ~ for logic, not `and`/`or`/`not`"
        )

    def __hash__(self) -> int:
        return hash(self._expr)

    def alias(self, name: str) -> "Expression":
        return Expression(Alias(self._expr, name))

    def cast(self, dtype: DataType) -> "Expression":
        return Expression(Cast(self._expr, dtype))

    # -- arithmetic -------------------------------------------------------
    def _bin(self, other: Any, op: str, reverse: bool = False) -> "Expression":
        rhs = Expression._from_any(other)._expr
        lhs = self._expr
        if reverse:
            lhs, rhs = rhs, lhs
        return Expression(BinaryOp(op, lhs, rhs))

    def __add__(self, other):
        return self._bin(other, "add")

    def __radd__(self, other):
        return self._bin(other, "add", True)

    def __sub__(self, other):
        return self._bin(other, "sub")

    def __rsub__(self, other):
        return self._bin(other, "sub", True)

    def __mul__(self, other):
        return self._bin(other, "mul")

    def __rmul__(self, other):
        return self._bin(other, "mul", True)

    def __truediv__(self, other):
        return self._bin(other, "truediv")

    def __rtruediv__(self, other):
        return self._bin(other, "truediv", True)

    def __floordiv__(self, other):
        return self._bin(other, "floordiv")

    def __rfloordiv__(self, other):
        return self._bin(other, "floordiv", True)

    def __mod__(self, other):
        return self._bin(other, "mod")

    def __rmod__(self, other):
        return self._bin(other, "mod", True)

    def __pow__(self, other):
        return self._bin(other, "pow")

    def __rpow__(self, other):
        return self._bin(other, "pow", True)

    def __neg__(self):
        return Expression(UnaryOp("negate", self._expr))

    def __abs__(self):
        return self.abs()

    def abs(self) -> "Expression":
        return Expression(UnaryOp("abs", self._expr))

    # -- comparison -------------------------------------------------------
    def __eq__(self, other):  # type: ignore[override]
        return self._bin(other, "eq")

    def __ne__(self, other):  # type: ignore[override]
        return self._bin(other, "ne")

    def __lt__(self, other):
        return self._bin(other, "lt")

    def __le__(self, other):
        return self._bin(other, "le")

    def __gt__(self, other):
        return self._bin(other, "gt")

    def __ge__(self, other):
        return self._bin(other, "ge")

    # -- logic ------------------------------------------------------------
    def __and__(self, other):
        return self._bin(other, "and")

    def __rand__(self, other):
        return self._bin(other, "and", True)

    def __or__(self, other):
        return self._bin(other, "or")

    def __ror__(self, other):
        return self._bin(other, "or", True)

    def __xor__(self, other):
        return self._bin(other, "xor")

    def __invert__(self):
        return Expression(UnaryOp("not", self._expr))

    # -- null handling ----------------------------------------------------
    def is_null(self) -> "Expression":
        return Expression(UnaryOp("is_null", self._expr))

    def not_null(self) -> "Expression":
        return Expression(UnaryOp("not_null", self._expr))

    def between(self, lower, upper) -> "Expression":
        return (self >= lower) & (self <= upper)

    def if_else(self, if_true, if_false) -> "Expression":
        return Expression(IfElse(self._expr, ensure_expr(if_true), ensure_expr(if_false)))

    # -- function helpers -------------------------------------------------
    def _fn(self, _fn_name: str, *args: Any, **kwargs: Any) -> "Expression":
        return Expression(FunctionCall(_fn_name, [self._expr, *(ensure_expr(a) for a in args)], kwargs))

    # -- numeric functions (kernels/numeric.py) ---------------------------
    def ceil(self):
        return self._fn("ceil")

    def floor(self):
        return self._fn("floor")

    def round(self, decimals: int = 0):
        return self._fn("round", decimals=decimals)

    def clip(self, min=None, max=None):
        return self._fn("clip", min=min, max=max)

    def sqrt(self):
        return self._fn("sqrt")

    def cbrt(self):
        return self._fn("cbrt")

    def exp(self):
        return self._fn("exp")

    def expm1(self):
        return self._fn("expm1")

    def log(self, base: float | None = None):
        return self._fn("log", base=base) if base else self._fn("ln")

    def ln(self):
        return self._fn("ln")

    def log1p(self):
        return self._fn("log1p")

    def log2(self):
        return self._fn("log2")

    def log10(self):
        return self._fn("log10")

    def sin(self):
        return self._fn("sin")

    def cos(self):
        return self._fn("cos")

    def tan(self):
        return self._fn("tan")

    def asin(self):
        return self._fn("asin")

    def acos(self):
        return self._fn("acos")

    def atan(self):
        return self._fn("atan")

    def atan2(self, other):
        return self._fn("atan2", other)

    def sinh(self):
        return self._fn("sinh")

    def cosh(self):
        return self._fn("cosh")

    def tanh(self):
        return self._fn("tanh")

    def sign(self):
        return self._fn("sign")

    # -- aggregation constructors ----------------------------------------
    def _agg(self, op: str, **kwargs) -> "Expression":
        return Expression(AggOp(op, self._expr, kwargs))

    def sum(self):
        return self._agg("sum")

    def mean(self):
        return self._agg("mean")

    def avg(self):
        return self._agg("mean")

    def min(self):
        return self._agg("min")

    def max(self):
        return self._agg("max")

    def count(self, mode: str = "valid"):
        return self._agg("count", mode=mode)

    # -- namespaces -------------------------------------------------------
    @property
    def float(self) -> "FloatNamespace":
        return FloatNamespace(self)

    @property
    def embedding(self) -> "EmbeddingNamespace":
        return EmbeddingNamespace(self)


class _Namespace:
    __slots__ = ("_e",)

    def __init__(self, e: Expression):
        self._e = e

    def _fn(self, _fn_name: str, *args, **kwargs) -> Expression:
        return self._e._fn(_fn_name, *args, **kwargs)


class FloatNamespace(_Namespace):
    def is_nan(self):
        return self._fn("is_nan")

    def is_inf(self):
        return self._fn("is_inf")

    def not_nan(self):
        return self._fn("not_nan")

    def fill_nan(self, fill_value):
        return self._fn("fill_nan", fill_value)


class EmbeddingNamespace(_Namespace):
    def cosine_distance(self, other):
        return self._fn("cosine_distance", other)

    def dot(self, other):
        return self._fn("embedding_dot", other)

    def l2_distance(self, other):
        return self._fn("l2_distance", other)

    def l2_normalize(self):
        return self._fn("l2_normalize")
