"""Expression IR.

Port of ``daft_tpu/expressions/expr.py`` (reference: the ``Expr`` enum,
src/daft-dsl/src/expr/mod.rs:222-306) as a small class hierarchy. Nodes are
immutable and structurally hashable; ``to_field`` binds a node to a schema
(src/daft-dsl/src/expr/bound_expr.rs).

This slice ports the nodes the embedding path and a plain projection need:
``ColumnRef``, ``Literal``, ``Alias`` and ``UdfCall``. Not ported yet: ``Cast``,
``BinaryOp``, ``UnaryOp``, ``IsIn``, ``IfElse``, ``FunctionCall`` (the kernel
registry), ``AggOp``, ``WindowExpr`` and the subquery nodes.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, Optional, Sequence, Tuple

from daft_tpu_torch.datatype import DataType
from daft_tpu_torch.errors import DaftValueError
from daft_tpu_torch.schema import Field, Schema


class Expr:
    """Base expression node."""

    __slots__ = ("_key",)

    # -- tree protocol ----------------------------------------------------
    def children(self) -> Tuple["Expr", ...]:
        return ()

    def with_children(self, children: Sequence["Expr"]) -> "Expr":
        if children:
            raise DaftValueError(f"{type(self).__name__} takes no children")
        return self

    # -- naming / typing --------------------------------------------------
    def name(self) -> str:
        for c in self.children():
            return c.name()
        return "literal"

    def to_field(self, schema: Schema) -> Field:
        raise NotImplementedError

    # -- structural identity ----------------------------------------------
    def key(self) -> tuple:
        try:
            return self._key
        except AttributeError:
            k = self._compute_key()
            object.__setattr__(self, "_key", k)
            return k

    def _compute_key(self) -> tuple:
        return (type(self).__name__, tuple(c.key() for c in self.children()), self._attrs_key())

    def _attrs_key(self) -> tuple:
        return ()

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Expr) and self.key() == other.key()

    def __hash__(self) -> int:
        return hash(self.key())

    # -- traversal helpers -------------------------------------------------
    def walk(self) -> Iterator["Expr"]:
        yield self
        for c in self.children():
            yield from c.walk()

    def transform(self, fn: Callable[["Expr"], Optional["Expr"]]) -> "Expr":
        """Bottom-up rewrite; fn returns a replacement or None to keep."""
        new_children = [c.transform(fn) for c in self.children()]
        node = self if all(a is b for a, b in zip(new_children, self.children())) else self.with_children(new_children)
        replaced = fn(node)
        return replaced if replaced is not None else node

    def has_udf(self) -> bool:
        return any(isinstance(e, UdfCall) for e in self.walk())


class ColumnRef(Expr):
    __slots__ = ("name_",)

    def __init__(self, name: str):
        self.name_ = name

    def name(self) -> str:
        return self.name_

    def to_field(self, schema: Schema) -> Field:
        return schema[self.name_]

    def _attrs_key(self) -> tuple:
        return (self.name_,)

    def __repr__(self) -> str:
        return f"col({self.name_})"


class Literal(Expr):
    __slots__ = ("value", "dtype")

    def __init__(self, value: Any, dtype: Optional[DataType] = None):
        self.value = value
        self.dtype = dtype or DataType.infer_from_py(value)

    def to_field(self, schema: Schema) -> Field:
        return Field("literal", self.dtype)

    def _attrs_key(self) -> tuple:
        v = self.value
        if isinstance(v, (list, dict)):
            v = repr(v)
        try:
            hash(v)
        except TypeError:
            v = repr(v)
        return (v, self.dtype)

    def __repr__(self) -> str:
        return f"lit({self.value!r})"


class Alias(Expr):
    __slots__ = ("child", "alias")

    def __init__(self, child: Expr, alias: str):
        self.child = child
        self.alias = alias

    def children(self) -> Tuple[Expr, ...]:
        return (self.child,)

    def with_children(self, children: Sequence[Expr]) -> "Alias":
        return Alias(children[0], self.alias)

    def name(self) -> str:
        return self.alias

    def to_field(self, schema: Schema) -> Field:
        return self.child.to_field(schema).rename(self.alias)

    def _attrs_key(self) -> tuple:
        return (self.alias,)

    def __repr__(self) -> str:
        return f"{self.child!r}.alias({self.alias!r})"


class UdfCall(Expr):
    """A user-defined function call (row-wise or batch).

    Reference: ``PyScalarFn`` row-wise/batch UDF expressions
    (src/daft-dsl/src/python_udf/mod.rs:20, row_wise.rs:64, batch.rs:67).
    The optimizer's SplitUDFs rule isolates these into dedicated UDFProject
    plan nodes so the executor can run them with their own batching.
    """

    __slots__ = ("udf", "args", "kwargs")

    def __init__(self, udf, args: Sequence[Expr], kwargs: Optional[Dict[str, Any]] = None):
        self.udf = udf  # daft_tpu_torch.udf.Udf instance
        self.args = tuple(args)
        self.kwargs = dict(kwargs or {})

    def children(self) -> Tuple[Expr, ...]:
        return self.args

    def with_children(self, children: Sequence[Expr]) -> "UdfCall":
        return UdfCall(self.udf, children, self.kwargs)

    def name(self) -> str:
        if self.args:
            return self.args[0].name()
        return self.udf.name

    def to_field(self, schema: Schema) -> Field:
        return Field(self.name(), self.udf.return_dtype)

    def _attrs_key(self) -> tuple:
        return (id(self.udf), tuple(sorted((k, repr(v)) for k, v in self.kwargs.items())))

    def __repr__(self) -> str:
        return f"udf[{self.udf.name}]({', '.join(map(repr, self.args))})"


def ensure_expr(value: Any) -> Expr:
    from daft_tpu_torch.expressions.expression import Expression

    if isinstance(value, Expr):
        return value
    if isinstance(value, Expression):
        return value._expr
    return Literal(value)
