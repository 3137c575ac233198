"""Free-function expression library (port of ``daft_tpu/functions/__init__.py``).

Reference: daft/functions. Most functions are thin wrappers over registry
kernels (``kernels/registry.py``); the AI functions live in
``functions/ai.py`` and the file, HDF5, video and process functions in
``functions/media.py``. What the port leaves out raises
``DaftNotImplementedError`` naming its ROADMAP item when a plan resolves it
(``registry.LEFT_OUT``): ``download`` / ``upload`` (remote IO).
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Union

from daft_tpu_torch.datatype import DataType
from daft_tpu_torch.errors import DaftValueError
from daft_tpu_torch.expressions.expr import FunctionCall, ensure_expr
from daft_tpu_torch.expressions.expression import Expression, col, lit


def _fn(_fn_name: str, *args, **kwargs) -> Expression:
    # The kernel's name is positional-only in spirit: a kernel may take a
    # ``name=`` keyword (``struct_get``), which the JAX package's ``_fn(name,
    # ...)`` refuses with a TypeError (ROADMAP C.35).
    return Expression(FunctionCall(_fn_name, [ensure_expr(a) for a in args], kwargs))


# -- general ---------------------------------------------------------------
def coalesce(*exprs) -> Expression:
    return _fn("coalesce", *exprs)


def fill_null(expr, value) -> Expression:
    return _fn("fill_null", expr, value)


def hash(expr, seed: Optional[int] = None) -> Expression:
    return _fn("hash", expr, **({"seed": seed} if seed is not None else {}))


def minhash(expr, num_hashes: int, ngram_size: int, seed: int = 1) -> Expression:
    return _fn("minhash", expr, num_hashes=num_hashes, ngram_size=ngram_size, seed=seed)


def concat_ws(sep, *exprs) -> Expression:
    return _fn("concat_ws", sep, *exprs)


def if_else(pred, if_true, if_false) -> Expression:
    p = pred if isinstance(pred, Expression) else lit(pred)
    return p.if_else(if_true, if_false)


def when(pred, value) -> "CaseWhen":
    return CaseWhen().when(pred, value)


class CaseWhen:
    """SQL-style CASE WHEN chain."""

    def __init__(self):
        self._branches = []

    def when(self, pred, value) -> "CaseWhen":
        self._branches.append((pred, value))
        return self

    def otherwise(self, value) -> Expression:
        out = value if isinstance(value, Expression) else lit(value)
        for pred, val in reversed(self._branches):
            p = pred if isinstance(pred, Expression) else lit(pred)
            out = p.if_else(val, out)
        return out


# -- numeric ---------------------------------------------------------------
def sqrt(e):
    return _fn("sqrt", e)


def exp(e):
    return _fn("exp", e)


def log(e, base: Optional[float] = None):
    return _fn("log", e, base=base) if base else _fn("ln", e)


def sin(e):
    return _fn("sin", e)


def cos(e):
    return _fn("cos", e)


def tan(e):
    return _fn("tan", e)


def abs(e):
    return ensure_expr_wrap(e).abs()


def ceil(e):
    return _fn("ceil", e)


def floor(e):
    return _fn("floor", e)


def round(e, decimals: int = 0):
    return _fn("round", e, decimals=decimals)


def clip(e, min=None, max=None):
    return _fn("clip", e, min=min, max=max)


def ensure_expr_wrap(e) -> Expression:
    return e if isinstance(e, Expression) else lit(e)


# -- distance / embedding --------------------------------------------------
def cosine_distance(a, b) -> Expression:
    return _fn("cosine_distance", a, b)


def l2_distance(a, b) -> Expression:
    return _fn("l2_distance", a, b)


def dot(a, b) -> Expression:
    return _fn("embedding_dot", a, b)


def l2_normalize(a) -> Expression:
    return _fn("l2_normalize", a)


# -- columnar --------------------------------------------------------------
def columns_sum(*exprs) -> Expression:
    out = ensure_expr_wrap(exprs[0])
    for e in exprs[1:]:
        out = out + e
    return out


def columns_mean(*exprs) -> Expression:
    return columns_sum(*exprs) / float(len(exprs))


def columns_min(*exprs) -> Expression:
    return _fn("elementwise_min", *exprs)


def columns_max(*exprs) -> Expression:
    return _fn("elementwise_max", *exprs)


# -- geo -------------------------------------------------------------------
def great_circle_distance(lat1, lon1, lat2, lon2, radius: float = 6371000.0) -> Expression:
    """Haversine distance in meters (reference: daft-geo)."""
    return _fn("great_circle_distance", lat1, lon1, lat2, lon2, radius=radius)


# -- window ----------------------------------------------------------------
def row_number() -> Expression:
    from daft_tpu_torch.expressions.expr import WindowExpr

    return Expression(WindowExpr("row_number", None, (), (), ()))


def rank() -> Expression:
    from daft_tpu_torch.expressions.expr import WindowExpr

    return Expression(WindowExpr("rank", None, (), (), ()))


def dense_rank() -> Expression:
    from daft_tpu_torch.expressions.expr import WindowExpr

    return Expression(WindowExpr("dense_rank", None, (), (), ()))


def monotonically_increasing_id() -> Expression:
    """Marker expression; the optimizer's DetectMonotonicId rule rewrites the
    containing projection into a MonotonicallyIncreasingId plan op
    (reference: optimization/rules/detect_monotonic_id.rs)."""
    return Expression(FunctionCall("monotonically_increasing_id", []))


def __getattr__(name: str):
    if name in _AI_LAZY:
        from daft_tpu_torch.functions import ai as ai_mod

        return getattr(ai_mod, name)
    raise AttributeError(f"module 'daft_tpu_torch.functions' has no attribute {name!r}")


# ======================================================================= #
# Long-tail function surface (reference: daft/functions — 303 exported    #
# functions across numeric/str/list/struct/datetime/binary/bitwise/misc/  #
# columnar/distance/similarity/window/partition/file/audio/video).        #
# ======================================================================= #

# -- numeric long tail -----------------------------------------------------
def cbrt(e):
    return _fn("cbrt", e)


def csc(e):
    return _fn("csc", e)


def sec(e):
    return _fn("sec", e)


def cot(e):
    return _fn("cot", e)


def sinh(e):
    return _fn("sinh", e)


def cosh(e):
    return _fn("cosh", e)


def tanh(e):
    return _fn("tanh", e)


def arcsin(e):
    return _fn("asin", e)


def arccos(e):
    return _fn("acos", e)


def arctan(e):
    return _fn("atan", e)


def arctan2(a, b):
    return _fn("atan2", a, b)


def arctanh(e):
    return _fn("atanh", e)


def arccosh(e):
    return _fn("acosh", e)


def arcsinh(e):
    return _fn("asinh", e)


def radians(e):
    return _fn("radians", e)


def degrees(e):
    return _fn("degrees", e)


def negate(e):
    return _fn("negate", e)


def factorial(e):
    return _fn("factorial", e)


def hypot(a, b):
    return _fn("hypot", a, b)


def pmod(a, b):
    return _fn("pmod", a, b)


def bin(e):
    return _fn("bin", e)


def conv(e, from_base: int, to_base: int):
    return _fn("conv", e, from_base=from_base, to_base=to_base)


def log2(e):
    return _fn("log2", e)


def log10(e):
    return _fn("log10", e)


def log1p(e):
    return _fn("log1p", e)


def ln(e):
    return _fn("ln", e)


def expm1(e):
    return _fn("expm1", e)


def sign(e):
    return _fn("sign", e)


def e() -> Expression:
    import math

    return lit(math.e)


def pi() -> Expression:
    import math

    return lit(math.pi)


def pow(a, b):
    return ensure_expr_wrap(a) ** b


power = pow


def is_nan(e):
    return _fn("is_nan", e)


def is_inf(e):
    return _fn("is_inf", e)


def not_nan(e):
    return _fn("not_nan", e)


def fill_nan(e, value):
    return _fn("fill_nan", e, value)


def between(e, lower, upper):
    return ensure_expr_wrap(e).between(lower, upper)


def abs(e):
    return ensure_expr_wrap(e).abs()


def ceil(e):
    return _fn("ceil", e)


def floor(e):
    return _fn("floor", e)


# -- bitwise ---------------------------------------------------------------
def bitwise_and(a, b):
    return _fn("bitwise_and", a, b)


def bitwise_or(a, b):
    return _fn("bitwise_or", a, b)


def bitwise_xor(a, b):
    return _fn("bitwise_xor", a, b)


def bitwise_not(e):
    return _fn("bitwise_not", e)


def shift_left(a, b):
    return _fn("shift_left", a, b)


def shift_right(a, b):
    return _fn("shift_right", a, b)


# -- string long tail ------------------------------------------------------
def contains(e, pattern):
    return _fn("str_contains", e, pattern)


def split(e, sep, regex: bool = False):
    return _fn("str_split", e, sep, regex=regex)


def lower(e):
    return _fn("str_lower", e)


def upper(e):
    return _fn("str_upper", e)


def lstrip(e):
    return _fn("str_lstrip", e)


def rstrip(e):
    return _fn("str_rstrip", e)


def strip(e):
    return _fn("str_strip", e)


def reverse(e):
    return _fn("str_reverse", e)


def capitalize(e):
    return _fn("str_capitalize", e)


def to_camel_case(e):
    return _fn("str_to_camel_case", e)


def to_upper_camel_case(e):
    return _fn("str_to_upper_camel_case", e)


def to_snake_case(e):
    return _fn("str_to_snake_case", e)


def to_upper_snake_case(e):
    return _fn("str_to_upper_snake_case", e)


def to_kebab_case(e):
    return _fn("str_to_kebab_case", e)


def to_upper_kebab_case(e):
    return _fn("str_to_upper_kebab_case", e)


def to_title_case(e):
    return _fn("str_to_title_case", e)


def swapcase(e):
    return _fn("str_swapcase", e)


def left(e, n):
    return _fn("str_left", e, n)


def right(e, n):
    return _fn("str_right", e, n)


def lpad(e, length, pad=" "):
    return _fn("str_lpad", e, length, pad)


def rpad(e, length, pad=" "):
    return _fn("str_rpad", e, length, pad)


def repeat(e, n):
    return _fn("str_repeat", e, n)


def like(e, pattern):
    return _fn("str_like", e, pattern)


def ilike(e, pattern):
    return _fn("str_ilike", e, pattern)


def substr(e, start, length=None):
    return _fn("str_substr", e, start, length) if length is not None else _fn("str_substr", e, start)


def endswith(e, suffix):
    return _fn("str_endswith", e, suffix)


def startswith(e, prefix):
    return _fn("str_startswith", e, prefix)


def normalize(e, **kwargs):
    return _fn("str_normalize", e, **kwargs)


def count_matches(e, patterns, **kwargs):
    return _fn("str_count_matches", e, patterns, **kwargs)


def length_bytes(e):
    return _fn("str_length_bytes", e)


def regexp(e, pattern):
    return _fn("str_match", e, pattern)


regexp_match = regexp


def regexp_count(e, pattern):
    return _fn("str_count_matches", e, pattern, regex=True)


def regexp_extract(e, pattern, index: int = 0):
    return _fn("str_extract", e, pattern, index=index)


def regexp_extract_all(e, pattern, index: int = 0):
    return _fn("str_extract_all", e, pattern, index=index)


def regexp_split(e, pattern):
    return _fn("str_split", e, pattern, regex=True)


def replace(e, search, replacement, regex: bool = False):
    return _fn("str_replace", e, search, replacement, regex=regex)


def regexp_replace(e, pattern, replacement):
    return _fn("str_replace", e, pattern, replacement, regex=True)


def find(e, substring):
    return _fn("str_find", e, substring)


def translate(e, src, dst):
    return _fn("str_translate", e, src, dst)


def substring_index(e, delim, count):
    return _fn("str_substring_index", e, delim, count)


def soundex(e):
    return _fn("str_soundex", e)


def ascii_func(e):
    return _fn("ascii", e)


def chr_func(e):
    return _fn("chr", e)


def space(e):
    return _fn("space", e)


def format(fmt: str, *args):
    return _fn("format_string", *args, fmt=fmt)


def hamming_distance_str(a, b):
    return _fn("hamming_distance_str", a, b)


def levenshtein_distance(a, b):
    return _fn("levenshtein_distance", a, b)


def damerau_levenshtein_distance(a, b):
    return _fn("damerau_levenshtein_distance", a, b)


def jaro_similarity(a, b):
    return _fn("jaro_similarity", a, b)


def jaro_winkler_similarity(a, b):
    return _fn("jaro_winkler_similarity", a, b)


def jq(e, query: str):
    return _fn("json_query", e, query=query)


def json_query(e, query: str):
    return _fn("json_query", e, query=query)


def json_array_length(e):
    return _fn("json_array_length", e)


def json_object_keys(e):
    return _fn("json_object_keys", e)


def json_tuple(e, *paths):
    cols = [_fn("json_query", e, query=p if p.startswith((".", "[")) else f".{p}").alias(f"c{i}")
            for i, p in enumerate(paths)]
    return cols


def serialize(e, format: str = "json"):
    return _fn("serialize", e, format=format)


def deserialize(e, format: str = "json"):
    return _fn("deserialize", e, format=format)


def try_deserialize(e, format: str = "json"):
    return _fn("try_deserialize", e, format=format)


def tokenize_encode(e, tokens_path: str = "cl100k_base", **kwargs):
    return _fn("tokenize_encode", e, tokens_path=tokens_path, **kwargs)


def tokenize_decode(e, tokens_path: str = "cl100k_base", **kwargs):
    return _fn("tokenize_decode", e, tokens_path=tokens_path, **kwargs)


# -- binary ----------------------------------------------------------------
def encode(e, codec: str = "base64"):
    return _fn("encode", e, codec=codec)


def decode(e, codec: str = "base64"):
    return _fn("decode", e, codec=codec)


def try_encode(e, codec: str = "base64"):
    return _fn("try_encode", e, codec=codec)


def try_decode(e, codec: str = "base64"):
    return _fn("try_decode", e, codec=codec)


def compress(e, codec: str = "zstd"):
    return _fn("compress", e, codec=codec)


def decompress(e, codec: str = "zstd"):
    return _fn("decompress", e, codec=codec)


def try_compress(e, codec: str = "zstd"):
    return _fn("try_compress", e, codec=codec)


def try_decompress(e, codec: str = "zstd"):
    return _fn("try_decompress", e, codec=codec)


# -- list ------------------------------------------------------------------
def element() -> Expression:
    """The per-element variable inside list_map/list_filter lambdas."""
    return col("__list_element__")


def value_counts(e):
    return _fn("list_value_counts", e)


def chunk(e, size: int):
    return _fn("list_chunk", e, size=size)


def list_join(e, sep):
    return _fn("list_join", e, sep)


def list_flatten(e):
    return _fn("list_flatten", e)


def list_count(e, mode: str = "valid"):
    return _fn("list_count", e, mode=mode)


def list_sum(e):
    return _fn("list_sum", e)


def list_mean(e):
    return _fn("list_mean", e)


def list_min(e):
    return _fn("list_min", e)


def list_max(e):
    return _fn("list_max", e)


def list_bool_and(e):
    return _fn("list_bool_and", e)


def list_bool_or(e):
    return _fn("list_bool_or", e)


def list_sort(e, desc: bool = False):
    return _fn("list_sort", e, desc=desc)


def list_distinct(e):
    return _fn("list_distinct", e)


def list_map(e, expr):
    mapper = expr._expr if isinstance(expr, Expression) else expr
    return _fn("list_map", e, expr=mapper)


def list_filter(e, expr):
    pred = expr._expr if isinstance(expr, Expression) else expr
    return _fn("list_filter", e, expr=pred)


def list_append(e, other):
    return _fn("list_append", e, other)


def list_contains(e, item):
    return _fn("list_contains", e, item)


def list_get(e, idx, default=None):
    return _fn("list_get", e, idx, default=default)


def list_slice(e, start, end=None):
    return _fn("list_slice", e, start, end=end)


# -- struct / map ----------------------------------------------------------
def struct_get(e, name: str):
    return _fn("struct_get", e, name=name)


def map_get(e, key):
    return _fn("map_get", e, key)


# -- datetime long tail ----------------------------------------------------
def date(e):
    return _fn("dt_date", e)


def day(e):
    return _fn("dt_day", e)


def hour(e):
    return _fn("dt_hour", e)


def minute(e):
    return _fn("dt_minute", e)


def second(e):
    return _fn("dt_second", e)


def millisecond(e):
    return _fn("dt_millisecond", e)


def microsecond(e):
    return _fn("dt_microsecond", e)


def nanosecond(e):
    return _fn("dt_nanosecond", e)


def month(e):
    return _fn("dt_month", e)


def quarter(e):
    return _fn("dt_quarter", e)


def year(e):
    return _fn("dt_year", e)


def day_of_week(e):
    return _fn("dt_day_of_week", e)


def day_of_month(e):
    return _fn("dt_day", e)


dayofmonth = day_of_month


def day_of_year(e):
    return _fn("dt_day_of_year", e)


dayofyear = day_of_year


def week_of_year(e):
    return _fn("dt_week_of_year", e)


weekofyear = week_of_year


def strftime(e, format=None):
    return _fn("dt_strftime", e, format=format)


date_format = strftime


def total_seconds(e):
    return _fn("dt_total_seconds", e)


def total_milliseconds(e):
    return _fn("dt_total_milliseconds", e)


def total_microseconds(e):
    return _fn("dt_total_microseconds", e)


def total_nanoseconds(e):
    return _fn("dt_total_nanoseconds", e)


def total_minutes(e):
    return _fn("dt_total_minutes", e)


def total_hours(e):
    return _fn("dt_total_hours", e)


def total_days(e):
    return _fn("dt_total_days", e)


def to_date(e, format: str = "%Y-%m-%d"):
    return _fn("str_to_date", e, format=format)


def to_datetime(e, format: str = "%Y-%m-%dT%H:%M:%S", timezone=None):
    return _fn("str_to_datetime", e, format=format, timezone=timezone)


def unix_date(e):
    return _fn("dt_unix_date", e)


def date_from_unix_date(e):
    return _fn("date_from_unix_date", e)


def timestamp_seconds(e):
    return _fn("timestamp_seconds", e)


def timestamp_millis(e):
    return _fn("timestamp_millis", e)


def timestamp_micros(e):
    return _fn("timestamp_micros", e)


from_unixtime = timestamp_seconds


def date_add(e, days):
    if isinstance(days, int):
        return _fn("date_add", e, days=days)
    return _fn("date_add", e, days)


dateadd = date_add


def date_sub(e, days):
    if isinstance(days, int):
        return _fn("date_sub", e, days=days)
    return _fn("date_sub", e, days)


def date_diff(a, b):
    return _fn("date_diff", a, b)


datediff = date_diff


def add_months(e, months: int):
    return _fn("add_months", e, months=months)


def months_between(a, b):
    return _fn("months_between", a, b)


def last_day(e):
    return _fn("last_day", e)


def next_day(e, day: str):
    return _fn("next_day", e, day=day)


def make_date(y, m, d):
    return _fn("make_date", y, m, d)


def date_trunc(unit: str, e):
    return _fn("dt_truncate", e, interval=f"1 {unit}")


trunc = date_trunc


def to_unix_epoch(e, time_unit: str = "s"):
    return _fn("dt_to_unix_epoch", e, time_unit=time_unit)


def convert_time_zone(e, timezone: str):
    return _fn("convert_time_zone", e, timezone=timezone)


convert_timezone = convert_time_zone


def replace_time_zone(e, timezone=None):
    return _fn("replace_time_zone", e, timezone=timezone)


def from_utc_timestamp(e, timezone: str):
    return _fn("convert_time_zone", _fn("replace_time_zone", e, timezone="UTC"),
               timezone=timezone)


def to_utc_timestamp(e, timezone: str):
    return _fn("convert_time_zone", _fn("replace_time_zone", e, timezone=timezone),
               timezone="UTC")


def current_date() -> Expression:
    import datetime as _dt

    return lit(_dt.date.today())


def current_timestamp() -> Expression:
    import datetime as _dt

    return lit(_dt.datetime.now())


def current_timezone() -> Expression:
    import time as _time

    return lit(_time.tzname[0])


def datepart(part: str, e):
    part = part.lower()
    mapping = {"year": "dt_year", "month": "dt_month", "day": "dt_day",
               "hour": "dt_hour", "minute": "dt_minute", "second": "dt_second",
               "quarter": "dt_quarter", "week": "dt_week_of_year",
               "dayofweek": "dt_day_of_week", "dayofyear": "dt_day_of_year"}
    if part not in mapping:
        raise DaftValueError(f"Unknown datepart {part!r}")
    return _fn(mapping[part], e)


# -- misc ------------------------------------------------------------------
def uuid(n=None) -> Expression:
    return _fn("uuid", n if n is not None else lit(1))


def random_int(e, lower: int = 0, upper: int = 2 ** 31, seed=None):
    return _fn("random_int", e, lower=lower, upper=upper, seed=seed)


def eq_null_safe(a, b):
    return _fn("eq_null_safe", a, b)


def cast(e, dtype):
    return ensure_expr_wrap(e).cast(dtype)


def try_cast(e, dtype):
    return ensure_expr_wrap(e).try_cast(dtype)


def is_null(e):
    return ensure_expr_wrap(e).is_null()


def not_null(e):
    return ensure_expr_wrap(e).not_null()


def is_in(e, items):
    return ensure_expr_wrap(e).is_in(items)


def simhash(e, ngram_size: int = 2):
    return _fn("simhash", e, ngram_size=ngram_size)


def length(e):
    return ensure_expr_wrap(e).length()


def get(e, key, default=None):
    if isinstance(key, int):
        return _fn("list_get", e, key, default=default)
    return ensure_expr_wrap(e)[key]


def slice(e, start, end=None):
    return _fn("list_slice", e, start, end=end)


def concat(*exprs):
    out = ensure_expr_wrap(exprs[0])
    for x in exprs[1:]:
        out = out + x
    return out


# -- columnar --------------------------------------------------------------
def columns_avg(*exprs):
    return columns_mean(*exprs)


# -- distance / similarity -------------------------------------------------
def euclidean_distance(a, b):
    return _fn("l2_distance", a, b)


def dot_product(a, b):
    return _fn("embedding_dot", a, b)


def cosine_similarity(a, b):
    return _fn("cosine_similarity", a, b)


def hamming_distance(a, b):
    return _fn("hamming_distance", a, b)


def pearson_correlation(a, b):
    return _fn("pearson_correlation", a, b)


def jaccard_similarity(a, b):
    return _fn("jaccard_similarity", a, b)


# -- window long tail ------------------------------------------------------
def percent_rank() -> Expression:
    from daft_tpu_torch.expressions.expr import WindowExpr

    return Expression(WindowExpr("percent_rank", None, (), (), ()))


def lag(e, offset: int = 1, default=None):
    from daft_tpu_torch.expressions.expr import WindowExpr, ensure_expr

    return Expression(WindowExpr("lag", ensure_expr(e), (), (), (),
                                 kwargs={"offset": offset, "default": default}))


def lead(e, offset: int = 1, default=None):
    from daft_tpu_torch.expressions.expr import WindowExpr, ensure_expr

    return Expression(WindowExpr("lead", ensure_expr(e), (), (), (),
                                 kwargs={"offset": offset, "default": default}))


def first_value(e):
    from daft_tpu_torch.expressions.expr import WindowExpr, ensure_expr

    return Expression(WindowExpr("first_value", ensure_expr(e), (), (), ()))


def last_value(e):
    from daft_tpu_torch.expressions.expr import WindowExpr, ensure_expr

    return Expression(WindowExpr("last_value", ensure_expr(e), (), (), ()))


# -- aggregation free functions --------------------------------------------
def _agg(op, e, **kwargs):
    from daft_tpu_torch.expressions.expr import AggOp, ensure_expr

    return Expression(AggOp(op, ensure_expr(e), kwargs or None))


def count(e, mode: str = "valid"):
    return _agg("count", e, mode=mode)


def count_distinct(e):
    return _agg("count_distinct", e)


def sum(e):
    return _agg("sum", e)


def product(e):
    return _agg("product", e)


def mean(e):
    return _agg("mean", e)


avg = mean


def median(e):
    return _agg("median", e)


def stddev(e):
    return _agg("stddev", e)


stddev_pop = stddev


def var(e):
    return _agg("variance", e)


var_pop = var


def min(e):
    return _agg("min", e)


def max(e):
    return _agg("max", e)


def bool_and(e):
    return _agg("bool_and", e)


def bool_or(e):
    return _agg("bool_or", e)


def any_value(e, ignore_nulls: bool = False):
    return _agg("any_value", e, ignore_nulls=ignore_nulls)


def skew(e):
    return _agg("skew", e)


def approx_count_distinct(e):
    return _agg("approx_count_distinct", e)


def approx_percentiles(e, percentiles):
    return _agg("approx_percentile", e, percentiles=percentiles)


def percentile(e, p):
    return _agg("approx_percentile", e, percentiles=p)


def list_agg(e):
    return _agg("list", e)


def list_agg_distinct(e):
    return _fn("list_distinct", _agg("list", e))


def string_agg(e, sep: str = ","):
    return _agg("string_agg", e, sep=sep)


# -- partition transforms --------------------------------------------------
def partition_days(e):
    return _fn("partition_days", e)


def partition_hours(e):
    return _fn("partition_hours", e)


def partition_months(e):
    return _fn("partition_months", e)


def partition_years(e):
    return _fn("partition_years", e)


def partition_iceberg_bucket(e, n: int):
    return _fn("partition_iceberg_bucket", e, n=n)


def partition_iceberg_truncate(e, w: int):
    return _fn("partition_iceberg_truncate", e, w=w)


# -- url / file ------------------------------------------------------------
def download(e, **kwargs):
    return _fn("url_download", e, **kwargs)


def upload(e, location, **kwargs):
    return _fn("url_upload", e, location, **kwargs)


def parse_url(e):
    return _fn("url_parse", e)


def file_path(e):
    return ensure_expr_wrap(e)


def file_size(e):
    return _fn("file_size", e)


def file_exists(e):
    return _fn("file_exists", e)


def guess_mime_type(e):
    return _fn("guess_mime_type", e)


# -- media -----------------------------------------------------------------
def audio_metadata(e):
    return _fn("audio_metadata", e)


def resample(e, target_rate: int = 16000, source_rate=None):
    kw = {"target_rate": target_rate}
    if source_rate is not None:
        kw["source_rate"] = source_rate
    return _fn("audio_resample", e, **kw)


def video_metadata(e):
    return _fn("video_metadata", e)


# -- image (free-function wrappers over image kernels) ---------------------
def resize(e, w: int, h: int):
    return _fn("image_resize", e, w=w, h=h)


def crop(e, bbox):
    return _fn("image_crop", e, bbox=bbox)


def encode_image(e, image_format: str = "PNG"):
    return _fn("image_encode", e, image_format=image_format)


def decode_image(e, mode=None):
    return _fn("image_decode", e, mode=mode)


def convert_image(e, mode: str):
    return _fn("image_to_mode", e, mode=mode)


# -- image accessors (reference: daft/functions/image.py) ------------------
def image_attribute(image, name: str):
    return ensure_expr_wrap(image)._fn("image_attribute", name=name)


def image_width(image):
    return image_attribute(image, "width")


def image_height(image):
    return image_attribute(image, "height")


def image_channel(image):
    return image_attribute(image, "channel")


def image_mode(image):
    return image_attribute(image, "mode")


def image_hash(image, *, method: str = "phash", hash_size: int = 8,
               binbits: int = 3, segments: int = 3):
    """Perceptual image hash -> FixedSizeBinary (reference: image.py
    image_hash; methods: phash/phash_simple/dhash/dhash_vertical/ahash/
    whash/crop_resistant/colorhash)."""
    return ensure_expr_wrap(image)._fn(
        "image_hash", method=method, hash_size=hash_size, binbits=binbits,
        segments=segments)


def image_to_tensor(image):
    return ensure_expr_wrap(image)._fn("to_tensor")


# -- struct / list / map long tail -----------------------------------------
def to_struct(*fields, **named_fields):
    """Pack columns into one struct column (reference: struct.py to_struct)."""
    exprs = [ensure_expr_wrap(f) for f in fields]
    names = [e._expr.name() for e in exprs]
    for n, e in named_fields.items():
        exprs.append(ensure_expr_wrap(e))
        names.append(n)
    return Expression(FunctionCall("pack_struct", [e._expr for e in exprs],
                                   {"names": names}))


def to_list(*items):
    """Pack N columns into one list column per row (reference: list.py
    to_list)."""
    return Expression(FunctionCall(
        "list_pack", [ensure_expr_wrap(i)._expr for i in items], {}))


def unnest(expr):
    """Expand a struct column into one output column per field (reference:
    struct.py unnest = expr.get("*"); expansion happens at projection
    binding in LogicalPlanBuilder.project)."""
    return ensure_expr_wrap(expr)._fn("unnest")


def seq(n):
    """[0..n-1] list per row (reference: list.py seq)."""
    return ensure_expr_wrap(n)._fn("list_seq")


def map_keys(expr):
    return ensure_expr_wrap(expr)._fn("map_keys")


def map_values(expr):
    return ensure_expr_wrap(expr)._fn("map_values")


def explode(list_expr, ignore_empty_and_null: bool = False):
    """Marker usable in select() to explode a list column: the projection
    binds the inner expression and appends an Explode node; with
    ignore_empty_and_null, empty/null lists produce no row (reference:
    list.py explode)."""
    return ensure_expr_wrap(list_expr)._fn(
        "explode", ignore_empty_and_null=ignore_empty_and_null)


# -- datetime long tail ----------------------------------------------------
def time(expr):
    """Extract the time-of-day component (reference: datetime.py time)."""
    return ensure_expr_wrap(expr).dt.time()


def make_timestamp(year, month, day, hour, minute, second,
                   timezone: Optional[str] = None):
    """Build Timestamp[us] from components; invalid dates -> null
    (reference: datetime.py make_timestamp)."""
    parts = [ensure_expr_wrap(e)._expr
             for e in (year, month, day, hour, minute, second)]
    return Expression(FunctionCall("make_timestamp", parts,
                                   {"timezone": timezone}))


def make_timestamp_ltz(year, month, day, hour, minute, second,
                       timezone: str = "UTC"):
    """make_timestamp carrying local-time-zone metadata (reference:
    datetime.py make_timestamp_ltz)."""
    return make_timestamp(year, month, day, hour, minute, second,
                          timezone=timezone)


# -- uuid7 partition transforms (reference: partition.py) ------------------
def extract_minute_uuid7(expr):
    return ensure_expr_wrap(expr)._fn("extract_minute_uuid7")


def extract_hour_uuid7(expr):
    return ensure_expr_wrap(expr)._fn("extract_hour_uuid7")


def extract_day_uuid7(expr):
    return ensure_expr_wrap(expr)._fn("extract_day_uuid7")


def extract_month_uuid7(expr):
    return ensure_expr_wrap(expr)._fn("extract_month_uuid7")


# -- window ----------------------------------------------------------------
def over(expr, window):
    """Apply a Window spec to an expression (reference: window.py over)."""
    return ensure_expr_wrap(expr).over(window)


# -- typed files / hdf5 / video / process ----------------------------------
from daft_tpu_torch.functions.media import (  # noqa: E402
    audio_file,
    decode_image_file,
    file,
    hdf5_attrs,
    hdf5_file,
    hdf5_keys,
    hdf5_metadata,
    image_file,
    image_file_metadata,
    run_process,
    video_file,
    video_frames,
    video_keyframes,
)

_AI_LAZY = ("embed_text", "embed_image", "classify_text", "classify_image",
            "prompt", "llm_generate")


def __dir__():
    return sorted(set(globals()) | set(_AI_LAZY))
