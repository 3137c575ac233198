"""Expression IR.

Port of ``daft_tpu/expressions/expr.py`` (reference: the ``Expr`` enum,
src/daft-dsl/src/expr/mod.rs:222-306) as a small class hierarchy. Nodes are
immutable and structurally hashable; ``to_field`` binds a node to a schema
(src/daft-dsl/src/expr/bound_expr.rs).

The port has the nodes of the embedding path and of the relational device
layer: ``ColumnRef``, ``Literal``, ``Alias``, ``Cast``, ``BinaryOp``,
``UnaryOp``, ``IfElse``, ``FunctionCall`` (the kernel registry), ``AggOp`` (the
global aggregations sum, mean, min, max and count) and ``UdfCall``. Not ported
yet: ``IsIn``, ``WindowExpr``, the subquery nodes, the shift operators and the
other aggregations.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, Optional, Sequence, Tuple

from daft_tpu_torch.datatype import DataType, TimeUnit, TypeId, unify_dtypes
from daft_tpu_torch.errors import DaftNotImplementedError, DaftTypeError, DaftValueError
from daft_tpu_torch.schema import Field, Schema

COMPARISON_OPS = {"eq", "ne", "lt", "le", "gt", "ge"}
ARITHMETIC_OPS = {"add", "sub", "mul", "truediv", "floordiv", "mod", "pow"}
LOGICAL_OPS = {"and", "or", "xor"}


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

    def column_refs(self) -> "set[str]":
        return {e.name_ for e in self.walk() if isinstance(e, ColumnRef)}

    def has_agg(self) -> bool:
        return any(isinstance(e, AggOp) for e in self.walk())

    def has_udf(self) -> bool:
        return any(isinstance(e, UdfCall) for e in self.walk())

    def has_column_ref(self) -> bool:
        return any(isinstance(e, ColumnRef) for e in self.walk())


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


class Cast(Expr):
    __slots__ = ("child", "dtype")

    def __init__(self, child: Expr, dtype: DataType):
        self.child = child
        self.dtype = dtype

    def children(self) -> Tuple[Expr, ...]:
        return (self.child,)

    def with_children(self, children: Sequence[Expr]) -> "Cast":
        return Cast(children[0], self.dtype)

    def to_field(self, schema: Schema) -> Field:
        return self.child.to_field(schema).with_dtype(self.dtype)

    def _attrs_key(self) -> tuple:
        return (self.dtype,)

    def __repr__(self) -> str:
        return f"cast({self.child!r} as {self.dtype!r})"


class BinaryOp(Expr):
    __slots__ = ("op", "left", "right")

    def __init__(self, op: str, left: Expr, right: Expr):
        if op not in COMPARISON_OPS | ARITHMETIC_OPS | LOGICAL_OPS:
            raise DaftNotImplementedError(f"binary op {op!r} is not ported")
        self.op = op
        self.left = left
        self.right = right

    def children(self) -> Tuple[Expr, ...]:
        return (self.left, self.right)

    def with_children(self, children: Sequence[Expr]) -> "BinaryOp":
        return BinaryOp(self.op, children[0], children[1])

    def to_field(self, schema: Schema) -> Field:
        lf = self.left.to_field(schema)
        rf = self.right.to_field(schema)
        name = self.left.name() if self.left.has_column_ref() or not self.right.has_column_ref() else self.right.name()
        op = self.op
        if op in COMPARISON_OPS or op in LOGICAL_OPS:
            return Field(name, DataType.bool())
        if op == "add" and (lf.dtype.is_string() or rf.dtype.is_string()):
            return Field(name, DataType.string())
        if op in ("add", "sub"):
            # Temporal arithmetic. Result units match the Arrow C++ kernels
            # the Series layer dispatches to:
            #   ts[u1] ± dur[u2]  -> ts[finer(u1,u2)]
            #   date ± dur[u]     -> ts[u]
            #   ts[u1] - ts[u2]   -> dur[finer(u1,u2)];  date - date -> dur[s]
            _ORDER = {TimeUnit.S: 0, TimeUnit.MS: 1, TimeUnit.US: 2, TimeUnit.NS: 3}

            def _finer(a, b):
                return a if _ORDER[a] >= _ORDER[b] else b

            lt, rt = lf.dtype, rf.dtype
            if rt.id == TypeId.DURATION and lt.id == TypeId.TIMESTAMP:
                return Field(name, DataType.timestamp(
                    _finer(lt._params[0], rt._params[0]), lt._params[1]))
            if rt.id == TypeId.DURATION and lt.id == TypeId.DATE:
                return Field(name, DataType.timestamp(rt._params[0]))
            if op == "add" and lt.id == TypeId.DURATION and rt.id == TypeId.TIMESTAMP:
                return Field(name, DataType.timestamp(
                    _finer(lt._params[0], rt._params[0]), rt._params[1]))
            if op == "add" and lt.id == TypeId.DURATION and rt.id == TypeId.DATE:
                return Field(name, DataType.timestamp(lt._params[0]))
            if op == "sub" and lt.id == rt.id == TypeId.TIMESTAMP:
                return Field(name, DataType.duration(
                    _finer(lt._params[0], rt._params[0])))
            if op == "sub" and lt.id == rt.id == TypeId.DATE:
                return Field(name, DataType.duration(TimeUnit.S))
        out = _literal_aware_unify(self.left, self.right, lf.dtype, rf.dtype)
        if op == "truediv":
            out = DataType.float32() if out.id in (TypeId.FLOAT32, TypeId.BFLOAT16) else DataType.float64()
        if not out.is_numeric() and not out.is_temporal() and not out.is_null():
            raise DaftTypeError(f"Cannot {op} {lf.dtype!r} and {rf.dtype!r}")
        return Field(name, out)

    def _attrs_key(self) -> tuple:
        return (self.op,)

    def __repr__(self) -> str:
        return f"({self.left!r} {self.op} {self.right!r})"


class UnaryOp(Expr):
    __slots__ = ("op", "child")

    OPS = {"not", "negate", "abs", "is_null", "not_null"}

    def __init__(self, op: str, child: Expr):
        if op not in self.OPS:
            raise DaftNotImplementedError(f"unary op {op!r} is not ported")
        self.op = op
        self.child = child

    def children(self) -> Tuple[Expr, ...]:
        return (self.child,)

    def with_children(self, children: Sequence[Expr]) -> "UnaryOp":
        return UnaryOp(self.op, children[0])

    def to_field(self, schema: Schema) -> Field:
        f = self.child.to_field(schema)
        if self.op in ("not", "is_null", "not_null"):
            return f.with_dtype(DataType.bool())
        return f

    def _attrs_key(self) -> tuple:
        return (self.op,)

    def __repr__(self) -> str:
        return f"{self.op}({self.child!r})"


class IfElse(Expr):
    __slots__ = ("pred", "if_true", "if_false")

    def __init__(self, pred: Expr, if_true: Expr, if_false: Expr):
        self.pred = pred
        self.if_true = if_true
        self.if_false = if_false

    def children(self) -> Tuple[Expr, ...]:
        return (self.pred, self.if_true, self.if_false)

    def with_children(self, children: Sequence[Expr]) -> "IfElse":
        return IfElse(children[0], children[1], children[2])

    def name(self) -> str:
        return self.if_true.name()

    def to_field(self, schema: Schema) -> Field:
        p = self.pred.to_field(schema)
        if not p.dtype.is_boolean() and not p.dtype.is_null():
            raise DaftTypeError(f"if_else predicate must be Boolean, got {p.dtype!r}")
        t = self.if_true.to_field(schema)
        f = self.if_false.to_field(schema)
        return Field(t.name, unify_dtypes(t.dtype, f.dtype))

    def __repr__(self) -> str:
        return f"if_else({self.pred!r}, {self.if_true!r}, {self.if_false!r})"


class FunctionCall(Expr):
    """A named scalar function from the kernel registry (``kernels/registry.py``).

    Reference: ``Expr::ScalarFn`` + the function registry
    (src/daft-dsl/src/functions/scalar.rs). A name the port's registry does
    not hold raises ``DaftNotImplementedError`` when the plan resolves it.
    """

    __slots__ = ("fn_name", "args", "kwargs")

    def __init__(self, fn_name: str, args: Sequence[Expr], kwargs: Optional[Dict[str, Any]] = None):
        self.fn_name = fn_name
        self.args = tuple(args)
        self.kwargs = dict(kwargs or {})

    def children(self) -> Tuple[Expr, ...]:
        return self.args

    def with_children(self, children: Sequence[Expr]) -> "FunctionCall":
        return FunctionCall(self.fn_name, children, self.kwargs)

    def to_field(self, schema: Schema) -> Field:
        from daft_tpu_torch.kernels.registry import get_kernel

        kernel = get_kernel(self.fn_name)
        fields = [a.to_field(schema) for a in self.args]
        return kernel.resolve(fields, self.kwargs)

    def _attrs_key(self) -> tuple:
        return (self.fn_name, tuple(sorted((k, repr(v)) for k, v in self.kwargs.items())))

    def __repr__(self) -> str:
        inner = ", ".join(repr(a) for a in self.args)
        return f"{self.fn_name}({inner})"


class AggOp(Expr):
    """Aggregation over a (possibly computed) child expression.

    Reference: ``AggExpr`` (src/daft-dsl/src/expr/mod.rs AggExpr enum). The
    port has the aggregations in ``OPS``, global and grouped; those in
    ``LEFT_OUT`` raise ``DaftNotImplementedError`` naming the ROADMAP item
    that ports them.
    """

    OPS = {"sum", "mean", "min", "max", "count", "product", "any_value", "bool_and",
           "bool_or", "stddev", "variance"}
    _LIST = "ROADMAP A.3 (list partials, with the .list namespace)"
    LEFT_OUT = {
        "median": _LIST, "string_agg": _LIST, "list": _LIST, "concat": _LIST,
        "count_distinct": _LIST, "approx_count_distinct": _LIST,
        "approx_percentile": "ROADMAP A.3 (sketch partials, with the .list namespace)",
        "dd_sketch": "ROADMAP A.3 (sketch partials, with the .list namespace)",
        "dd_merge": "ROADMAP A.3 (sketch partials, with the .list namespace)",
        "skew": "ROADMAP A.3 (its pow_3_2 final, with the list aggregations)",
        "udaf": "ROADMAP A.2 (udaf)", "udaf_partial": "ROADMAP A.2 (udaf)",
        "udaf_merge": "ROADMAP A.2 (udaf)",
    }

    __slots__ = ("op", "child", "kwargs")

    def __init__(self, op: str, child: Expr, kwargs: Optional[Dict[str, Any]] = None):
        if op in self.LEFT_OUT:
            raise DaftNotImplementedError(
                f"aggregation {op!r} is not ported to daft_tpu_torch: {self.LEFT_OUT[op]}")
        if op not in self.OPS:
            raise DaftValueError(f"Unknown aggregation op: {op}")
        self.op = op
        self.child = child
        self.kwargs = dict(kwargs or {})

    def children(self) -> Tuple[Expr, ...]:
        return (self.child,)

    def with_children(self, children: Sequence[Expr]) -> "AggOp":
        return AggOp(self.op, children[0], self.kwargs)

    def to_field(self, schema: Schema) -> Field:
        from daft_tpu_torch.series import _sum_dtype

        f = self.child.to_field(schema)
        op = self.op
        if op in ("sum", "product"):
            return f.with_dtype(_sum_dtype(f.dtype))
        if op in ("mean", "stddev", "variance"):
            return f.with_dtype(DataType.float64())
        if op == "count":
            return f.with_dtype(DataType.uint64())
        if op in ("bool_and", "bool_or"):
            return f.with_dtype(DataType.bool())
        return f  # min, max, any_value

    def _attrs_key(self) -> tuple:
        return (self.op, tuple(sorted((k, repr(v)) for k, v in self.kwargs.items())))

    def __repr__(self) -> str:
        return f"{self.op}({self.child!r})"


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


_INT_RANGES = {
    TypeId.INT8: (-(1 << 7), (1 << 7) - 1), TypeId.INT16: (-(1 << 15), (1 << 15) - 1),
    TypeId.INT32: (-(1 << 31), (1 << 31) - 1), TypeId.INT64: (-(1 << 63), (1 << 63) - 1),
    TypeId.UINT8: (0, (1 << 8) - 1), TypeId.UINT16: (0, (1 << 16) - 1),
    TypeId.UINT32: (0, (1 << 32) - 1), TypeId.UINT64: (0, (1 << 64) - 1),
}


def _literal_aware_unify(left: "Expr", right: "Expr", lt: DataType, rt: DataType) -> DataType:
    """Type promotion where bare Python literals adapt to the column's dtype
    instead of widening it: a float literal must not promote a bf16/f32
    column to f64, which would keep the expression off the device (the
    reference instead relies on i64/f64 supertypes, dtype.rs supertype rules)."""

    def adapt(lit: Literal, other: DataType) -> Optional[DataType]:
        if not other.is_numeric():
            return None
        v = lit.value
        if isinstance(v, bool):
            return None
        if isinstance(v, int) and not lit.dtype.is_floating():
            if other.is_integer():
                lo, hi = _INT_RANGES[other.id]
                return other if lo <= v <= hi else None
            if other.is_floating():
                return other
        if isinstance(v, float):
            if other.is_floating():
                return other
            if other.is_integer():
                return DataType.float64()
        return None

    if isinstance(left, Literal) and not isinstance(right, Literal):
        adapted = adapt(left, rt)
        if adapted is not None:
            return adapted
    if isinstance(right, Literal) and not isinstance(left, Literal):
        adapted = adapt(right, lt)
        if adapted is not None:
            return adapted
    return unify_dtypes(lt, rt)


def ensure_expr(value: Any) -> Expr:
    from daft_tpu_torch.expressions.expression import Expression

    if isinstance(value, Expr):
        return value
    if isinstance(value, Expression):
        return value._expr
    return Literal(value)
