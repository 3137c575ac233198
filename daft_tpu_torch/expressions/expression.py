"""User-facing ``Expression`` wrapper (port of ``daft_tpu/expressions/expression.py``).

Mirrors the reference's ``Expression`` class surface (reference:
daft/expressions/expressions.py:138): operators, casts, ``is_in``,
``fill_null``, ``eq_null_safe``, ``try_cast``, the shifts, the numeric and
long-tail functions, the aggregations and the ``.str`` / ``.dt`` /
``.float`` / ``.binary`` / ``.url`` (``parse``) / ``.partitioning`` /
``.image`` / ``.embedding`` / ``.list`` / ``.struct`` / ``.map`` namespaces,
with the reference's flat aliases of the namespaced methods, and windows
(``over``, ``lag`` / ``lead``, ``first_value`` / ``last_value``). Each lowers
onto the port's Expr IR (``expressions/expr.py``) and the kernel registry
(``kernels/registry.py``); ``apply`` is a row-wise UDF over the expression.
A kernel the port left out would raise ``DaftNotImplementedError`` with its
ROADMAP item through ``registry.LEFT_OUT``, which is empty. The flat media methods
(``hdf5_keys``, ``video_frames``, ...) raise ``DaftIOError`` as in the JAX
package: the free functions of ``functions`` are what decode media.
"""

from __future__ import annotations

from typing import Any, Iterable, Iterator, List, Optional, Sequence, Union

from daft_tpu_torch.datatype import DataType
from daft_tpu_torch.errors import DaftIOError, DaftValueError
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


def element() -> "Expression":
    """Placeholder for the current list element inside ``.list.eval`` /
    ``.list.map`` style expressions (reference: daft.element)."""
    return Expression(ColumnRef(""))


def interval(**kwargs: int) -> "Expression":
    import datetime

    return lit(datetime.timedelta(**{k: v for k, v in kwargs.items() if k in (
        "days", "seconds", "microseconds", "milliseconds", "minutes", "hours", "weeks")}))


class Expression:
    __slots__ = ("_expr",)

    def __init__(self, expr: Expr):
        self._expr = expr

    @staticmethod
    def _from_any(value: Any) -> "Expression":
        if isinstance(value, Expression):
            return value
        return lit(value)

    # -- infra ------------------------------------------------------------
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

    # -- naming / casting -------------------------------------------------
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

    def eq_null_safe(self, other) -> "Expression":
        return self._bin(other, "eq_null_safe")

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

    def fill_null(self, fill_value) -> "Expression":
        return Expression(FunctionCall("fill_null", [self._expr, ensure_expr(fill_value)]))

    def is_in(self, items: Union["Expression", Sequence[Any]]) -> "Expression":
        from daft_tpu_torch.dataframe.dataframe import DataFrame

        if isinstance(items, DataFrame):
            # Uncorrelated IN-subquery over a one-column DataFrame; the
            # optimizer unnests it into a semi join (reference:
            # Expr::InSubquery + rules/unnest_subquery.rs).
            from daft_tpu_torch.expressions.expr import InSubquery

            plan = items._builder.plan
            names = plan.schema.column_names()
            if len(names) != 1:
                raise DaftValueError(
                    f"is_in subquery must have exactly one column, got {names}")
            return Expression(InSubquery(self._expr, plan, ColumnRef(names[0])))
        if isinstance(items, Expression):
            rhs = items._expr
        else:
            rhs = Literal(list(items), DataType.python()) if not _is_plain_seq(items) else Literal(list(items))
        return Expression(IsIn(self._expr, rhs))

    def between(self, lower, upper) -> "Expression":
        return (self >= lower) & (self <= upper)

    def if_else(self, if_true, if_false) -> "Expression":
        return Expression(IfElse(self._expr, ensure_expr(if_true), ensure_expr(if_false)))

    # -- function helpers -------------------------------------------------
    def _fn(self, _fn_name: str, *args: Any, **kwargs: Any) -> "Expression":
        return Expression(FunctionCall(_fn_name, [self._expr, *(ensure_expr(a) for a in args)], kwargs))

    def apply(self, func, return_dtype: DataType) -> "Expression":
        from daft_tpu_torch.udf import func as make_udf

        udf = make_udf(func, return_dtype=return_dtype)
        return udf(self)

    # -- numeric functions ------------------------------------------------
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

    def shift_left(self, other):
        return self._bin(other, "lshift")

    def shift_right(self, other):
        return self._bin(other, "rshift")

    def hash(self, seed=None) -> "Expression":
        return self._fn("hash", **({"seed": seed} if seed is not None else {}))

    def minhash(self, num_hashes: int, ngram_size: int, seed: int = 1) -> "Expression":
        return self._fn("minhash", num_hashes=num_hashes, ngram_size=ngram_size, seed=seed)

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

    def count_distinct(self):
        return self._agg("count_distinct")

    def any_value(self, ignore_nulls: bool = False):
        return self._agg("any_value", ignore_nulls=ignore_nulls)

    def agg_list(self):
        return self._agg("list")

    def agg_concat(self):
        return self._agg("concat")

    def stddev(self):
        return self._agg("stddev")

    def skew(self):
        return self._agg("skew")

    def bool_and(self):
        return self._agg("bool_and")

    def bool_or(self):
        return self._agg("bool_or")

    def approx_count_distinct(self):
        return self._agg("approx_count_distinct")

    def approx_percentiles(self, percentiles):
        return self._agg("approx_percentile", percentiles=percentiles)

    def unnest(self) -> "Expression":
        """Expand this struct column into one output column per field when
        used in select() (reference: Expression.unnest / .get("*"))."""
        return self._fn("unnest")

    # -- window -----------------------------------------------------------
    def over(self, window) -> "Expression":
        from daft_tpu_torch.expressions.expr import AggOp, WindowExpr

        inner = self._expr
        if isinstance(inner, WindowExpr):
            # e.g. row_number().over(w): bind the window spec.
            return Expression(WindowExpr(
                inner.func, inner.child, tuple(e._expr for e in window._partition_by),
                tuple(e._expr for e in window._order_by), tuple(window._descending),
                window._frame, inner.kwargs,
            ))
        if isinstance(inner, AggOp):
            func, child = inner.op, inner.child
        else:
            raise DaftValueError("over() requires an aggregation or window function expression")
        return Expression(WindowExpr(
            func, child, tuple(e._expr for e in window._partition_by),
            tuple(e._expr for e in window._order_by), tuple(window._descending),
            window._frame,
        ))

    # -- long-tail flat methods (reference: daft/expressions/expressions.py
    # exposes the function library as flat Expression methods too) ---------
    def try_cast(self, dtype) -> "Expression":
        """Cast; rows that fail become null (reference: Expression.try_cast)."""
        return self._fn("try_cast", dtype=dtype)

    def negate(self) -> "Expression":
        return self._fn("negate")

    def csc(self):
        return self._fn("csc")

    def sec(self):
        return self._fn("sec")

    def cot(self):
        return self._fn("cot")

    def arcsin(self):
        return self._fn("asin")

    def arccos(self):
        return self._fn("acos")

    def arctan(self):
        return self._fn("atan")

    def arctanh(self):
        return self._fn("atanh")

    def arccosh(self):
        return self._fn("acosh")

    def arcsinh(self):
        return self._fn("asinh")

    def radians(self):
        return self._fn("radians")

    def degrees(self):
        return self._fn("degrees")

    def factorial(self):
        return self._fn("factorial")

    def hypot(self, other):
        return self._fn("hypot", other)

    def pmod(self, other):
        return self._fn("pmod", other)

    def is_nan(self):
        return self._fn("is_nan")

    def is_inf(self):
        return self._fn("is_inf")

    def not_nan(self):
        return self._fn("not_nan")

    def fill_nan(self, value):
        return self._fn("fill_nan", value)

    def bitwise_and(self, other):
        return self._fn("bitwise_and", other)

    def bitwise_or(self, other):
        return self._fn("bitwise_or", other)

    def bitwise_xor(self, other):
        return self._fn("bitwise_xor", other)

    def bitwise_not(self):
        return self._fn("bitwise_not")

    def product(self):
        return self._agg("product")

    def median(self):
        return self._agg("median")

    def variance(self):
        return self._agg("variance")

    def string_agg(self, sep: str = ","):
        return self._agg("string_agg", sep=sep)

    def agg_list_distinct(self):
        return self.agg_list().list.distinct()

    agg_set = agg_list_distinct
    list_agg_distinct = agg_list_distinct

    def list_agg(self):
        return self.agg_list()

    def var(self):
        return self.variance()

    def lag(self, offset: int = 1, default=None) -> "Expression":
        from daft_tpu_torch.expressions.expr import WindowExpr

        return Expression(WindowExpr("lag", self._expr, (), (), (),
                                     kwargs={"offset": offset, "default": default}))

    def lead(self, offset: int = 1, default=None) -> "Expression":
        from daft_tpu_torch.expressions.expr import WindowExpr

        return Expression(WindowExpr("lead", self._expr, (), (), (),
                                     kwargs={"offset": offset, "default": default}))

    def first_value(self) -> "Expression":
        from daft_tpu_torch.expressions.expr import WindowExpr

        return Expression(WindowExpr("first_value", self._expr, (), (), ()))

    def last_value(self) -> "Expression":
        from daft_tpu_torch.expressions.expr import WindowExpr

        return Expression(WindowExpr("last_value", self._expr, (), (), ()))

    def length(self) -> "Expression":
        return self._fn("str_length")

    def serialize(self, format: str = "json"):
        return self._fn("serialize", format=format)

    def deserialize(self, format: str = "json"):
        return self._fn("deserialize", format=format)

    def try_deserialize(self, format: str = "json"):
        return self._fn("try_deserialize", format=format)

    def simhash(self, ngram_size: int = 2):
        return self._fn("simhash", ngram_size=ngram_size)

    def encode(self, codec: str = "base64"):
        return self._fn("encode", codec=codec)

    def decode(self, codec: str = "base64"):
        return self._fn("decode", codec=codec)

    def try_encode(self, codec: str = "base64"):
        return self._fn("try_encode", codec=codec)

    def try_decode(self, codec: str = "base64"):
        return self._fn("try_decode", codec=codec)

    def compress(self, codec: str = "zstd"):
        return self._fn("compress", codec=codec)

    def decompress(self, codec: str = "zstd"):
        return self._fn("decompress", codec=codec)

    @property
    def partitioning(self) -> "PartitioningNamespace":
        return PartitioningNamespace(self)

    # -- namespaces -------------------------------------------------------
    @property
    def str(self) -> "StringNamespace":
        return StringNamespace(self)

    @property
    def dt(self) -> "TemporalNamespace":
        return TemporalNamespace(self)

    @property
    def list(self) -> "ListNamespace":
        return ListNamespace(self)

    @property
    def struct(self) -> "StructNamespace":
        return StructNamespace(self)

    @property
    def map(self) -> "MapNamespace":
        return MapNamespace(self)

    @property
    def float(self) -> "FloatNamespace":
        return FloatNamespace(self)

    @property
    def image(self) -> "ImageNamespace":
        return ImageNamespace(self)

    @property
    def embedding(self) -> "EmbeddingNamespace":
        return EmbeddingNamespace(self)

    @property
    def binary(self) -> "BinaryNamespace":
        return BinaryNamespace(self)

    @property
    def url(self) -> "UrlNamespace":
        return UrlNamespace(self)

    def __getitem__(self, key) -> "Expression":
        if isinstance(key, int):
            return self.list.get(key)
        if isinstance(key, str):
            return self.struct.get(key)
        raise DaftValueError(f"Cannot index expression with {key!r}")


class _Namespace:
    __slots__ = ("_e",)

    def __init__(self, e: Expression):
        self._e = e

    def _fn(self, _fn_name: str, *args, **kwargs) -> Expression:
        return self._e._fn(_fn_name, *args, **kwargs)


class StringNamespace(_Namespace):
    def contains(self, pattern):
        return self._fn("str_contains", pattern)

    def startswith(self, prefix):
        return self._fn("str_startswith", prefix)

    def endswith(self, suffix):
        return self._fn("str_endswith", suffix)

    def concat(self, other):
        return self._e + other

    def length(self):
        return self._fn("str_length")

    def length_bytes(self):
        return self._fn("str_length_bytes")

    def lower(self):
        return self._fn("str_lower")

    def upper(self):
        return self._fn("str_upper")

    def capitalize(self):
        return self._fn("str_capitalize")

    def reverse(self):
        return self._fn("str_reverse")

    def lstrip(self):
        return self._fn("str_lstrip")

    def rstrip(self):
        return self._fn("str_rstrip")

    def strip(self):
        return self._fn("str_strip")

    def split(self, pattern, regex: bool = False):
        return self._fn("str_split", pattern, regex=regex)

    def extract(self, pattern, index: int = 0):
        return self._fn("str_extract", pattern, index=index)

    def extract_all(self, pattern, index: int = 0):
        return self._fn("str_extract_all", pattern, index=index)

    def replace(self, pattern, replacement, regex: bool = False):
        return self._fn("str_replace", pattern, replacement, regex=regex)

    def match(self, pattern):
        return self._fn("str_match", pattern)

    def left(self, n):
        return self._fn("str_left", n)

    def right(self, n):
        return self._fn("str_right", n)

    def find(self, substr):
        return self._fn("str_find", substr)

    def rpad(self, length, pad):
        return self._fn("str_rpad", length, pad)

    def lpad(self, length, pad):
        return self._fn("str_lpad", length, pad)

    def repeat(self, n):
        return self._fn("str_repeat", n)

    def like(self, pattern):
        return self._fn("str_like", pattern)

    def ilike(self, pattern):
        return self._fn("str_ilike", pattern)

    def substr(self, start, length=None):
        return self._fn("str_substr", start, length=length)

    def to_date(self, format: str):
        return self._fn("str_to_date", format=format)

    def to_datetime(self, format: str, timezone: Optional[str] = None):
        return self._fn("str_to_datetime", format=format, timezone=timezone)

    def normalize(self, remove_punct=False, lowercase=False, nfd_unicode=False, white_space=False):
        return self._fn("str_normalize", remove_punct=remove_punct, lowercase=lowercase,
                        nfd_unicode=nfd_unicode, white_space=white_space)

    def count_matches(self, patterns, whole_words=False, case_sensitive=True):
        return self._fn("str_count_matches", patterns=patterns, whole_words=whole_words,
                        case_sensitive=case_sensitive)

    def to_camel_case(self):
        return self._fn("str_to_camel_case")

    def to_upper_camel_case(self):
        return self._fn("str_to_upper_camel_case")

    def to_snake_case(self):
        return self._fn("str_to_snake_case")

    def to_upper_snake_case(self):
        return self._fn("str_to_upper_snake_case")

    def to_kebab_case(self):
        return self._fn("str_to_kebab_case")

    def to_upper_kebab_case(self):
        return self._fn("str_to_upper_kebab_case")

    def to_title_case(self):
        return self._fn("str_to_title_case")

    def swapcase(self):
        return self._fn("str_swapcase")

    def translate(self, src, dst):
        return self._fn("str_translate", src, dst)

    def substring_index(self, delim, count):
        return self._fn("str_substring_index", delim, count)

    def soundex(self):
        return self._fn("str_soundex")

    def ascii(self):
        return self._fn("ascii")

    def levenshtein_distance(self, other):
        return self._fn("levenshtein_distance", other)

    def damerau_levenshtein_distance(self, other):
        return self._fn("damerau_levenshtein_distance", other)

    def jaro_similarity(self, other):
        return self._fn("jaro_similarity", other)

    def jaro_winkler_similarity(self, other):
        return self._fn("jaro_winkler_similarity", other)

    def hamming_distance(self, other):
        return self._fn("hamming_distance_str", other)

    def jq(self, query: str):
        return self._fn("json_query", query=query)

    def json_query(self, query: str):
        return self._fn("json_query", query=query)

    def json_array_length(self):
        return self._fn("json_array_length")

    def json_object_keys(self):
        return self._fn("json_object_keys")

    def regexp_replace(self, pattern, replacement):
        return self._fn("str_replace", pattern, replacement, regex=True)

    def regexp_count(self, pattern):
        return self._fn("str_count_matches", pattern, regex=True)

    def regexp_split(self, pattern):
        return self._fn("str_split", pattern, regex=True)

    def zfill(self, width: int):
        return self._fn("str_lpad", width, "0")


class TemporalNamespace(_Namespace):
    def date(self):
        return self._fn("dt_date")

    def day(self):
        return self._fn("dt_day")

    def hour(self):
        return self._fn("dt_hour")

    def minute(self):
        return self._fn("dt_minute")

    def second(self):
        return self._fn("dt_second")

    def millisecond(self):
        return self._fn("dt_millisecond")

    def microsecond(self):
        return self._fn("dt_microsecond")

    def time(self):
        return self._fn("dt_time")

    def month(self):
        return self._fn("dt_month")

    def quarter(self):
        return self._fn("dt_quarter")

    def year(self):
        return self._fn("dt_year")

    def day_of_week(self):
        return self._fn("dt_day_of_week")

    def day_of_month(self):
        return self._fn("dt_day")

    def day_of_year(self):
        return self._fn("dt_day_of_year")

    def week_of_year(self):
        return self._fn("dt_week_of_year")

    def truncate(self, interval: str):
        return self._fn("dt_truncate", interval=interval)

    def to_unix_epoch(self, time_unit: str = "s"):
        return self._fn("dt_to_unix_epoch", time_unit=time_unit)

    def strftime(self, format: Optional[str] = None):
        return self._fn("dt_strftime", format=format)

    def total_seconds(self):
        return self._fn("dt_total_seconds")

    def nanosecond(self):
        return self._fn("dt_nanosecond")

    def unix_date(self):
        return self._fn("dt_unix_date")

    def total_milliseconds(self):
        return self._fn("dt_total_milliseconds")

    def total_microseconds(self):
        return self._fn("dt_total_microseconds")

    def total_nanoseconds(self):
        return self._fn("dt_total_nanoseconds")

    def total_minutes(self):
        return self._fn("dt_total_minutes")

    def total_hours(self):
        return self._fn("dt_total_hours")

    def total_days(self):
        return self._fn("dt_total_days")

    def date_add(self, days):
        if isinstance(days, int):
            return self._fn("date_add", days=days)
        return self._fn("date_add", days)

    def date_sub(self, days):
        if isinstance(days, int):
            return self._fn("date_sub", days=days)
        return self._fn("date_sub", days)

    def date_diff(self, other):
        return self._fn("date_diff", other)

    def add_months(self, months: int):
        return self._fn("add_months", months=months)

    def months_between(self, other):
        return self._fn("months_between", other)

    def last_day(self):
        return self._fn("last_day")

    def next_day(self, day: str):
        return self._fn("next_day", day=day)

    def convert_time_zone(self, timezone: str):
        return self._fn("convert_time_zone", timezone=timezone)

    def replace_time_zone(self, timezone=None):
        return self._fn("replace_time_zone", timezone=timezone)


class ListNamespace(_Namespace):
    def join(self, delimiter):
        return self._fn("list_join", delimiter)

    def value_counts(self):
        return self._fn("list_value_counts")

    def count(self, mode: str = "valid"):
        return self._fn("list_count", mode=mode)

    def lengths(self):
        return self._fn("list_length")

    def length(self):
        return self._fn("list_length")

    def get(self, idx, default=None):
        return self._fn("list_get", idx, default=default)

    def slice(self, start, end=None):
        return self._fn("list_slice", start, end=end)

    def chunk(self, size: int):
        return self._fn("list_chunk", size=size)

    def sum(self):
        return self._fn("list_sum")

    def mean(self):
        return self._fn("list_mean")

    def min(self):
        return self._fn("list_min")

    def max(self):
        return self._fn("list_max")

    def sort(self, desc: bool = False):
        return self._fn("list_sort", desc=desc)

    def distinct(self):
        return self._fn("list_distinct")

    def contains(self, value):
        return self._fn("list_contains", value)

    def explode(self):
        from daft_tpu_torch.errors import DaftValueError

        raise DaftValueError(
            "explode is a plan-level operation: use DataFrame.explode(col) "
            "(one row per list element changes the row count)"
        )

    def flatten(self):
        return self._fn("list_flatten")

    def bool_and(self):
        return self._fn("list_bool_and")

    def bool_or(self):
        return self._fn("list_bool_or")

    def append(self, other):
        return self._fn("list_append", other)

    def map(self, expr):
        mapper = expr._expr if isinstance(expr, Expression) else expr
        return self._fn("list_map", expr=mapper)

    def filter(self, expr):
        pred = expr._expr if isinstance(expr, Expression) else expr
        return self._fn("list_filter", expr=pred)

    def quantile(self, percentiles):
        return self._fn("list_quantile", percentiles=percentiles)

    def count_distinct(self):
        return self._fn("list_count_distinct")


class StructNamespace(_Namespace):
    def get(self, name: str):
        if name == "*":
            # Wildcard expands at projection binding (reference:
            # Expression.unnest == .get("*")).
            return self._fn("unnest")
        return self._fn("struct_get", name=name)


class MapNamespace(_Namespace):
    def get(self, key):
        return self._fn("map_get", key)

    def keys(self):
        return self._fn("map_keys")

    def values(self):
        return self._fn("map_values")


class FloatNamespace(_Namespace):
    def is_nan(self):
        return self._fn("is_nan")

    def is_inf(self):
        return self._fn("is_inf")

    def not_nan(self):
        return self._fn("not_nan")

    def fill_nan(self, fill_value):
        return self._fn("fill_nan", fill_value)


class ImageNamespace(_Namespace):
    def decode(self, on_error: str = "raise", mode=None):
        return self._fn("image_decode", on_error=on_error, mode=mode)

    def encode(self, image_format):
        return self._fn("image_encode", image_format=image_format)

    def resize(self, w: int, h: int):
        return self._fn("image_resize", w=w, h=h)

    def crop(self, bbox):
        return self._fn("image_crop", bbox=bbox)

    def to_mode(self, mode):
        return self._fn("image_to_mode", mode=mode)

    def width(self):
        return self._fn("image_attribute", name="width")

    def height(self):
        return self._fn("image_attribute", name="height")

    def channel(self):
        return self._fn("image_attribute", name="channel")

    def mode(self):
        return self._fn("image_attribute", name="mode")

    def attribute(self, name: str):
        return self._fn("image_attribute", name=name)

    def hash(self, *, method: str = "phash", hash_size: int = 8,
             binbits: int = 3, segments: int = 3):
        return self._fn("image_hash", method=method, hash_size=hash_size,
                        binbits=binbits, segments=segments)

    def to_tensor(self):
        return self._fn("to_tensor")


class EmbeddingNamespace(_Namespace):
    def cosine_distance(self, other):
        return self._fn("cosine_distance", other)

    def dot(self, other):
        return self._fn("embedding_dot", other)

    def l2_distance(self, other):
        return self._fn("l2_distance", other)

    def l2_normalize(self):
        return self._fn("l2_normalize")

    def cosine_similarity(self, other):
        other = other._e if isinstance(other, _Namespace) else other
        return self._fn("cosine_similarity", other)

    def hamming_distance(self, other):
        other = other._e if isinstance(other, _Namespace) else other
        return self._fn("hamming_distance", other)

    def pearson_correlation(self, other):
        other = other._e if isinstance(other, _Namespace) else other
        return self._fn("pearson_correlation", other)


class BinaryNamespace(_Namespace):
    def length(self):
        return self._fn("binary_length")

    def concat(self, other):
        return self._fn("binary_concat", other)

    def slice(self, start, length=None):
        return self._fn("binary_slice", start, length=length)

    def encode(self, codec: str = "base64"):
        return self._fn("encode", codec=codec)

    def decode(self, codec: str = "base64"):
        return self._fn("decode", codec=codec)

    def try_encode(self, codec: str = "base64"):
        return self._fn("try_encode", codec=codec)

    def try_decode(self, codec: str = "base64"):
        return self._fn("try_decode", codec=codec)

    def compress(self, codec: str = "zstd"):
        return self._fn("compress", codec=codec)

    def decompress(self, codec: str = "zstd"):
        return self._fn("decompress", codec=codec)

    def try_compress(self, codec: str = "zstd"):
        return self._fn("try_compress", codec=codec)

    def try_decompress(self, codec: str = "zstd"):
        return self._fn("try_decompress", codec=codec)


class PartitioningNamespace(_Namespace):
    """Partition transforms (reference: daft/functions/partition.py +
    Expression.partitioning in the reference API)."""

    def days(self):
        return self._fn("partition_days")

    def hours(self):
        return self._fn("partition_hours")

    def months(self):
        return self._fn("partition_months")

    def years(self):
        return self._fn("partition_years")

    def iceberg_bucket(self, n: int):
        return self._fn("partition_iceberg_bucket", n=n)

    def iceberg_truncate(self, w: int):
        return self._fn("partition_iceberg_truncate", w=w)



class UrlNamespace(_Namespace):
    def download(self, on_error: str = "raise", max_connections: int = 32):
        return self._fn("url_download", on_error=on_error, max_connections=max_connections)

    def upload(self, location: str, on_error: str = "raise"):
        return self._fn("url_upload", location=location, on_error=on_error)

    def parse(self):
        return self._fn("url_parse")


class ExpressionsProjection:
    """An ordered list of expressions with unique output names
    (reference: daft/expressions/expressions.py ExpressionsProjection)."""

    def __init__(self, exprs: Sequence[Expression]):
        self._exprs = list(exprs)
        seen = set()
        for e in self._exprs:
            n = e.name()
            if n in seen:
                raise DaftValueError(f"Duplicate output name in projection: {n!r}")
            seen.add(n)

    @staticmethod
    def from_schema(schema: Schema) -> "ExpressionsProjection":
        return ExpressionsProjection([col(f.name) for f in schema])

    def __iter__(self) -> Iterator[Expression]:
        return iter(self._exprs)

    def __len__(self) -> int:
        return len(self._exprs)

    def to_inner_exprs(self) -> List[Expr]:
        return [e._expr for e in self._exprs]

    def resolve_schema(self, schema: Schema) -> Schema:
        return Schema([e.to_field(schema) for e in self._exprs])


def _is_plain_seq(items: Iterable[Any]) -> bool:
    return all(isinstance(v, (int, float, str, bytes, bool, type(None))) for v in items)


# --------------------------------------------------------------------------- #
# Flat Expression surface (reference parity)                                  #
# --------------------------------------------------------------------------- #
# The reference exposes most namespace operations ALSO as flat Expression
# methods (reference: daft/expressions/expressions.py Expression, 247 public
# methods). The namespaced API stays the primary surface; these delegates
# close the flat-name gap. Table: flat name -> (namespace property,
# namespace method).
_FLAT_NS_DELEGATES = {
    # strings
    "ascii": ("str", "ascii"), "capitalize": ("str", "capitalize"),
    "concat": ("str", "concat"), "contains": ("str", "contains"),
    "count_matches": ("str", "count_matches"),
    "damerau_levenshtein_distance": ("str", "damerau_levenshtein_distance"),
    "endswith": ("str", "endswith"), "find": ("str", "find"),
    "hamming_distance_str": ("str", "hamming_distance"),
    "ilike": ("str", "ilike"),
    "jaro_similarity": ("str", "jaro_similarity"),
    "jaro_winkler_similarity": ("str", "jaro_winkler_similarity"),
    "jq": ("str", "jq"), "left": ("str", "left"),
    "length_bytes": ("str", "length_bytes"),
    "levenshtein_distance": ("str", "levenshtein_distance"),
    "like": ("str", "like"), "lower": ("str", "lower"),
    "lpad": ("str", "lpad"), "lstrip": ("str", "lstrip"),
    "normalize": ("str", "normalize"),
    "regexp": ("str", "match"), "regexp_count": ("str", "regexp_count"),
    "regexp_extract": ("str", "extract"),
    "regexp_extract_all": ("str", "extract_all"),
    "regexp_replace": ("str", "regexp_replace"),
    "regexp_split": ("str", "regexp_split"),
    "repeat": ("str", "repeat"), "replace": ("str", "replace"),
    "reverse": ("str", "reverse"), "right": ("str", "right"),
    "rpad": ("str", "rpad"), "rstrip": ("str", "rstrip"),
    "soundex": ("str", "soundex"), "split": ("str", "split"),
    "strip": ("str", "strip"),
    "startswith": ("str", "startswith"), "substr": ("str", "substr"),
    "substring_index": ("str", "substring_index"),
    "to_camel_case": ("str", "to_camel_case"),
    "to_date": ("str", "to_date"), "to_datetime": ("str", "to_datetime"),
    "to_kebab_case": ("str", "to_kebab_case"),
    "to_snake_case": ("str", "to_snake_case"),
    "to_title_case": ("str", "to_title_case"),
    "to_upper_camel_case": ("str", "to_upper_camel_case"),
    "to_upper_kebab_case": ("str", "to_upper_kebab_case"),
    "to_upper_snake_case": ("str", "to_upper_snake_case"),
    "translate": ("str", "translate"), "upper": ("str", "upper"),
    # temporal
    "convert_time_zone": ("dt", "convert_time_zone"),
    "date": ("dt", "date"), "date_trunc": ("dt", "truncate"),
    "day": ("dt", "day"), "day_of_month": ("dt", "day_of_month"),
    "day_of_week": ("dt", "day_of_week"),
    "day_of_year": ("dt", "day_of_year"), "hour": ("dt", "hour"),
    "microsecond": ("dt", "microsecond"),
    "millisecond": ("dt", "millisecond"), "minute": ("dt", "minute"),
    "month": ("dt", "month"), "nanosecond": ("dt", "nanosecond"),
    "quarter": ("dt", "quarter"),
    "replace_time_zone": ("dt", "replace_time_zone"),
    "second": ("dt", "second"), "strftime": ("dt", "strftime"),
    "time": ("dt", "time"), "to_unix_epoch": ("dt", "to_unix_epoch"),
    "total_days": ("dt", "total_days"), "total_hours": ("dt", "total_hours"),
    "total_microseconds": ("dt", "total_microseconds"),
    "total_milliseconds": ("dt", "total_milliseconds"),
    "total_minutes": ("dt", "total_minutes"),
    "total_nanoseconds": ("dt", "total_nanoseconds"),
    "total_seconds": ("dt", "total_seconds"),
    "unix_date": ("dt", "unix_date"),
    "week_of_year": ("dt", "week_of_year"), "year": ("dt", "year"),
    # lists
    "chunk": ("list", "chunk"), "explode": ("list", "explode"),
    "get": ("list", "get"), "slice": ("list", "slice"),
    "value_counts": ("list", "value_counts"),
    "list_append": ("list", "append"), "list_bool_and": ("list", "bool_and"),
    "list_bool_or": ("list", "bool_or"),
    "list_contains": ("list", "contains"), "list_count": ("list", "count"),
    "list_distinct": ("list", "distinct"), "list_filter": ("list", "filter"),
    "list_flatten": ("list", "flatten"), "list_join": ("list", "join"),
    "list_map": ("list", "map"), "list_max": ("list", "max"),
    "list_mean": ("list", "mean"), "list_min": ("list", "min"),
    "list_sort": ("list", "sort"), "list_sum": ("list", "sum"),
    # maps
    "map_get": ("map", "get"), "map_keys": ("map", "keys"),
    # embeddings
    "cosine_distance": ("embedding", "cosine_distance"),
    "cosine_similarity": ("embedding", "cosine_similarity"),
    "dot_product": ("embedding", "dot"),
    "euclidean_distance": ("embedding", "l2_distance"),
    "hamming_distance": ("embedding", "hamming_distance"),
    "pearson_correlation": ("embedding", "pearson_correlation"),
    # images
    "convert_image": ("image", "to_mode"), "crop": ("image", "crop"),
    "decode_image": ("image", "decode"), "encode_image": ("image", "encode"),
    "image_attribute": ("image", "attribute"),
    "image_channel": ("image", "channel"), "image_hash": ("image", "hash"),
    "image_height": ("image", "height"), "image_mode": ("image", "mode"),
    "image_to_tensor": ("image", "to_tensor"),
    "image_width": ("image", "width"), "resize": ("image", "resize"),
    # urls / files
    "download": ("url", "download"), "parse_url": ("url", "parse"),
    "upload": ("url", "upload"),
    # binary
    "try_compress": ("binary", "try_compress"),
    "try_decompress": ("binary", "try_decompress"),
    # partitioning
    "partition_days": ("partitioning", "days"),
    "partition_hours": ("partitioning", "hours"),
    "partition_iceberg_bucket": ("partitioning", "iceberg_bucket"),
    "partition_iceberg_truncate": ("partitioning", "iceberg_truncate"),
    "partition_months": ("partitioning", "months"),
    "partition_years": ("partitioning", "years"),
}

#: Flat name -> registry kernel (no namespace home).
_FLAT_KERNEL_DELEGATES = {
    "decode_image_file": "decode_image_file",
    "file_exists": "file_exists",
    "file_path": "file_path",
    "file_size": "file_size",
    "image_file_metadata": "image_file_metadata",
    "jaccard_similarity": "jaccard_similarity",
    "video_metadata": "video_metadata",
}

#: Surfaces present for parity but gated on media/HDF5 integrations, as in
#: the JAX package (the free functions in ``functions`` decode media).
_FLAT_GATED = {
    "hdf5_attrs": "h5py", "hdf5_keys": "h5py", "hdf5_metadata": "h5py",
    "video_frames": "av", "video_keyframes": "av",
}


def _install_flat_surface() -> None:
    def ns_delegate(ns: str, meth: str, flat: str):
        def f(self, *args, **kwargs):
            return getattr(getattr(self, ns), meth)(*args, **kwargs)

        f.__name__ = flat
        f.__qualname__ = f"Expression.{flat}"
        f.__doc__ = (f"Flat alias of ``.{ns}.{meth}`` "
                     f"(reference: daft Expression.{flat}).")
        return f

    def kernel_delegate(kernel: str, flat: str):
        def f(self, *args, **kwargs):
            return self._fn(kernel, *args, **kwargs)

        f.__name__ = flat
        f.__qualname__ = f"Expression.{flat}"
        f.__doc__ = f"Kernel ``{kernel}`` (reference: daft Expression.{flat})."
        return f

    def gated(flat: str, dep: str):
        def f(self, *args, **kwargs):
            raise DaftIOError(
                f"Expression.{flat} requires the {dep} integration, which is "
                f"not available in this environment; the surface is reserved "
                f"for parity with the reference and activates when the "
                f"dependency is present")

        f.__name__ = flat
        f.__qualname__ = f"Expression.{flat}"
        f.__doc__ = f"Gated on {dep} (reference: daft Expression.{flat})."
        return f

    for flat, (ns, meth) in _FLAT_NS_DELEGATES.items():
        if not hasattr(Expression, flat):
            setattr(Expression, flat, ns_delegate(ns, meth, flat))
    for flat, kernel in _FLAT_KERNEL_DELEGATES.items():
        if not hasattr(Expression, flat):
            setattr(Expression, flat, kernel_delegate(kernel, flat))
    for flat, dep in _FLAT_GATED.items():
        if not hasattr(Expression, flat):
            setattr(Expression, flat, gated(flat, dep))


_install_flat_surface()


def _expr_pow(self, other) -> "Expression":
    """Element-wise power (reference: daft Expression.pow / power)."""
    return self.__pow__(other)


def _expr_arctan2(self, other) -> "Expression":
    """Four-quadrant arctangent (reference: daft Expression.arctan2)."""
    return self.atan2(other)


def _expr_coalesce(self, *others) -> "Expression":
    """First non-null across self and others (reference: Expression.coalesce)."""
    return self._fn("coalesce", *others)


def _expr_percentile(self, percentiles) -> "Expression":
    """Approximate percentile aggregation (reference: Expression.percentile)."""
    return self.approx_percentiles(percentiles)


def _expr_is_column(self) -> bool:
    """True when this expression is a bare column reference."""
    return isinstance(self._expr, ColumnRef)


def _expr_is_literal(self) -> bool:
    """True when this expression is a literal value."""
    return isinstance(self._expr, Literal)


def _expr_column_name(self) -> str:
    """Output column name (reference: Expression.column_name)."""
    return self.name()


Expression.pow = _expr_pow
Expression.power = _expr_pow
Expression.arctan2 = _expr_arctan2
Expression.coalesce = _expr_coalesce
Expression.percentile = _expr_percentile
Expression.is_column = _expr_is_column
Expression.is_literal = _expr_is_literal
Expression.column_name = property(_expr_column_name)
