"""User-facing ``Expression`` wrapper (port of ``daft_tpu/expressions/expression.py``).

``col`` / ``lit`` build expressions; ``alias`` renames one. Not ported yet: the
operator overloads (arithmetic, comparison, logic), ``cast``, and the
``.str`` / ``.list`` / ``.dt`` / ``.image`` / ``.embedding`` namespaces.
"""

from __future__ import annotations

from typing import Any, Optional

from daft_tpu_torch.datatype import DataType
from daft_tpu_torch.errors import DaftValueError
from daft_tpu_torch.expressions.expr import Alias, ColumnRef, Expr, Literal
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
