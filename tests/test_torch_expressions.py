"""The port's expression library (``.str``, ``.dt``, ``.binary``, ``url.parse``,
``is_in``, ``fill_null``, ``eq_null_safe``, ``try_cast``, the shifts and the
host kernels behind them) against the JAX package, on the CPU.

Mirrors tests/test_expressions.py; its ``.list`` and struct cases are in
tests/test_torch_nested.py. Then one case per kernel of the port's
``string_ops``, ``temporal_ops``, ``binary_ops``, ``uri_ops``, ``misc_ops``
and ``extended_ops``: the same seeded columns (nulls, empty strings,
non-ASCII text, NaN, dates around leap days, time zones) go through the JAX
package and through the port (``device="cpu"``). Strings, integers,
booleans, dates, binaries and structs must be equal; floats too, bit for bit
(NaN equal to NaN), except ``great_circle_distance`` and
``pearson_correlation``, held at rtol 1e-12 (``FLOAT_RTOL``). Each case also
takes the same route as in the JAX package: the device layer's fused and
host expressions by reason. A coverage test holds every kernel name of the
JAX package's six modules to a case here or to the port's table of
left-out names.
"""

import base64
import datetime
import math
import pathlib
import zlib
from importlib import import_module

import numpy as np
import pyarrow as pa
import pytest

import daft_tpu
import daft_tpu_torch
from daft_tpu.ops import device_eval as jde
from daft_tpu_torch.errors import DaftNotImplementedError
from daft_tpu_torch.kernels import registry as preg
from daft_tpu_torch.ops import device_eval as tde

PKGS = (daft_tpu, daft_tpu_torch)
N = 48
FLOAT_RTOL = {"great_circle_distance": 1e-12, "pearson_correlation": 1e-12}
HERE = str(pathlib.Path(__file__).resolve())


@pytest.fixture(autouse=True)
def _configs():
    with daft_tpu.execution_config_ctx(result_cache_enabled=False, device_eval_min_rows=1), \
            daft_tpu_torch.execution_config_ctx(device="cpu", result_cache_enabled=False,
                                                device_eval_min_rows=1):
        yield


# -- mirrors of tests/test_expressions.py -------------------------------------
def _mirror_df(pkg):
    return pkg.from_pydict({
        "s": ["Hello World", "foo bar", None, "xyz"],
        "i": [1, -2, 3, 4],
        "f": [1.5, -2.5, float("nan"), 4.0],
    })


def _both(build, data=None):
    """``build(pkg, df)``'s ``to_pydict`` in the JAX package and the port."""
    outs = []
    for pkg in PKGS:
        df = _mirror_df(pkg) if data is None else pkg.from_pydict(data)
        outs.append(build(pkg, df).to_pydict())
    return outs


def _assert_same(a, b, rtol=0.0):
    assert a.keys() == b.keys()
    for k in a:
        assert len(a[k]) == len(b[k]), k
        for x, y in zip(a[k], b[k]):
            if isinstance(x, float) and isinstance(y, float):
                if math.isnan(x) or math.isnan(y):
                    assert math.isnan(x) and math.isnan(y), (k, x, y)
                elif rtol:
                    assert abs(x - y) <= rtol * abs(y), (k, x, y)
                else:
                    assert x == y, (k, x, y)
            else:
                assert x == y and type(x) is type(y), (k, x, y)


def test_str_namespace():
    jax, port = _both(lambda pkg, df: df.select(
        pkg.col("s").str.upper().alias("u"),
        pkg.col("s").str.length().alias("n"),
        pkg.col("s").str.contains("o").alias("c"),
        pkg.col("s").str.split(" ").alias("sp")))
    _assert_same(jax, port)
    assert port["u"] == ["HELLO WORLD", "FOO BAR", None, "XYZ"]
    assert port["n"] == [11, 7, None, 3]
    assert port["c"] == [True, True, None, False]
    assert port["sp"][0] == ["Hello", "World"]


def test_str_more():
    jax, port = _both(lambda pkg, df: df.select(
        pkg.col("s").str.left(3).alias("l3"),
        pkg.col("s").str.lower().alias("lo"),
        pkg.col("s").str.replace("o", "0").alias("rep"),
        pkg.col("s").str.like("He%").alias("lk")))
    _assert_same(jax, port)
    assert port["l3"] == ["Hel", "foo", None, "xyz"]
    assert port["rep"][0] == "Hell0 W0rld"
    assert port["lk"] == [True, False, None, False]


def test_temporal():
    data = {"d": [datetime.datetime(2024, 3, 15, 10, 30), datetime.datetime(2020, 1, 1)]}
    jax, port = _both(lambda pkg, df: df.select(
        pkg.col("d").dt.year().alias("y"), pkg.col("d").dt.month().alias("m"),
        pkg.col("d").dt.day().alias("dd"), pkg.col("d").dt.hour().alias("h")), data)
    _assert_same(jax, port)
    assert port["y"] == [2024, 2020]
    assert port["m"] == [3, 1]
    assert port["h"] == [10, 0]


def test_if_else_between_isin():
    jax, port = _both(lambda pkg, df: df.select(
        (pkg.col("i") > 0).if_else(pkg.lit("pos"), pkg.lit("neg")).alias("sign"),
        pkg.col("i").between(1, 3).alias("btw"),
        pkg.col("i").is_in([1, 4]).alias("in_")))
    _assert_same(jax, port)
    assert port["sign"] == ["pos", "neg", "pos", "pos"]
    assert port["btw"] == [True, False, True, False]
    assert port["in_"] == [True, False, False, True]


def test_null_handling():
    jax, port = _both(lambda pkg, df: df.select(
        pkg.col("s").is_null().alias("n"), pkg.col("s").fill_null("??").alias("f")))
    _assert_same(jax, port)
    assert port["n"] == [False, False, True, False]
    assert port["f"][2] == "??"


def test_hash_minhash():
    jax, port = _both(lambda pkg, df: df.select(pkg.col("s").hash().alias("h")))
    _assert_same(jax, port)
    assert port["h"][0] is not None
    data = {"t": ["a b c d", "a b c d", "x y z w"]}
    jax, port = _both(lambda pkg, df: df.select(
        pkg.col("t").minhash(num_hashes=16, ngram_size=2).alias("mh")), data)
    _assert_same(jax, port)
    assert port["mh"][0] == port["mh"][1] != port["mh"][2]


def test_coalesce():
    data = {"a": [None, 2], "b": [10, 20]}
    outs = []
    for pkg in PKGS:
        outs.append(pkg.from_pydict(data).select(
            _F(pkg).coalesce(pkg.col("a"), pkg.col("b")).alias("c")).to_pydict())
    _assert_same(*outs)
    assert outs[1]["c"] == [10, 2]


def test_great_circle_distance():
    from daft_tpu_torch.expressions.expr import FunctionCall
    from daft_tpu_torch.functions import great_circle_distance

    dt = daft_tpu_torch
    df = dt.from_pydict({"lat1": [52.52, 0.0, None, 91.0], "lon1": [13.40, 0.0, 0.0, 0.0],
                         "lat2": [48.85, 0.0, 0.0, 0.0], "lon2": [2.35, 90.0, 0.0, 0.0]})
    c = dt.col
    out = df.select(great_circle_distance(c("lat1"), c("lon1"), c("lat2"), c("lon2"))
                    .alias("d")).to_pydict()["d"]
    assert out[0] == pytest.approx(877_700, rel=0.01)     # Berlin -> Paris
    assert out[1] == pytest.approx(10_007_543, rel=0.001)  # a quarter circumference
    assert out[2] is None and out[3] is None  # a null and an out-of-range latitude
    three = dt.Expression(FunctionCall("great_circle_distance",
                                       [c("lat1")._expr, c("lon1")._expr, c("lat2")._expr]))
    with pytest.raises(Exception, match="great_circle_distance"):
        df.select(three).to_pydict()


# -- one case per kernel --------------------------------------------------------
_STRINGS = ["Hello World", "", "  padded  ", "ümlaut Ünïcode", "日本語テキスト", "abc\n",
            "foo_bar-baz", "CamelCaseWord", "a.b.c.d", "special requests here", "x",
            "MIXED case 123", "tab\tsep", "emoji 🙂 ok", "Straße", "hello hello"]
_DATES = [datetime.date(2020, 2, 28), datetime.date(2020, 2, 29), datetime.date(2020, 3, 1),
          datetime.date(2000, 2, 29), datetime.date(1900, 3, 1), datetime.date(2100, 2, 28),
          datetime.date(2019, 12, 31), datetime.date(2021, 1, 1), datetime.date(1970, 1, 1),
          datetime.date(2024, 2, 29)]
_JSON = ['{"a": {"b": [1, 2, 3]}}', '[1, 2]', 'nope', '{"x": "y", "z": null}', '[]', "{}",
         '{"a": {"b": ["q"]}}']


def _uuid7(ms: int, tail: int) -> str:
    h = f"{ms:012x}7{tail % 4096:03x}8{tail % 4095:03x}{tail:012x}"
    return f"{h[:8]}-{h[8:12]}-{h[12:16]}-{h[16:20]}-{h[20:32]}"


def _columns() -> dict:
    """The shared seeded columns: every fifth or so value null."""
    rng = np.random.default_rng(12)

    def pick(pool, null_every=5):
        idx = rng.integers(0, len(pool), N)
        return [None if i % null_every == 3 else pool[j] for i, j in enumerate(idx)]

    base = datetime.datetime(2020, 2, 28, 22, 15, 30, 123456)
    ts = [base + datetime.timedelta(seconds=int(s), microseconds=int(u))
          for s, u in zip(rng.integers(0, 3 * 86400, N), rng.integers(0, 10 ** 6, N))]
    f = rng.standard_normal(N) * 10
    f[[2, 11]] = np.nan
    emb = rng.standard_normal((N, 8)).astype(np.float32)
    emb2 = emb + rng.standard_normal((N, 8)).astype(np.float32)
    s2_pool = ["kitten", "sitting", "", "Hello Wordl", "ümlaut", "abc", "x"]
    same_len = ["karolin", "kathrin", "1011101", "1001001", "abcdefg"]
    ints = rng.integers(-1000, 1000, N)
    small = rng.integers(0, 8, N)
    comp = [b"hello", b"", b"\x00\x01\xff", "ümlaut".encode()]
    return {
        "s": pick(_STRINGS),
        "s2": pick(s2_pool, 7),
        "h1": pick(same_len), "h2": pick(same_len, 9),
        "i": [None if k % 6 == 1 else int(v) for k, v in enumerate(ints)],
        "small": [None if k % 7 == 2 else int(v) for k, v in enumerate(small)],
        "fact": [None if k % 7 == 2 else int(v) for k, v in enumerate(rng.integers(0, 21, N))],
        "f": [None if k % 9 == 4 else float(v) for k, v in enumerate(f)],
        "d": pick(_DATES),
        "d2": pick(_DATES, 8),
        "ts": [None if k % 8 == 5 else v for k, v in enumerate(ts)],
        "dur": [None if k % 7 == 0 else datetime.timedelta(seconds=int(s), microseconds=int(u))
                for k, (s, u) in enumerate(zip(rng.integers(-10 ** 6, 10 ** 6, N),
                                               rng.integers(0, 10 ** 6, N)))],
        "b": pick(comp),
        "z": pick([zlib.compress(x) for x in comp]),
        "b64": pick([base64.b64encode(x).decode() for x in comp] + ["!!not base64!!"]),
        "j": pick(_JSON),
        "url": pick(["https://user@example.com:8443/a/b?q=1#frag", "http://h.io", "",
                     "file:///tmp/x.parquet", "s3://bucket/key/part-0.parquet",
                     "ftp://ftp.example.org/ü.txt", "no scheme at all"]),
        "num": pick(["12", "-7", "3.5", "abc", "", " 42", "99999999999"]),
        "dstr": pick(["2020-02-29", "2021-12-31", "1999-01-01", "2024-02-29"]),
        "tstr": pick(["2020-02-29 23:59:59", "2021-03-28 02:30:00", "1999-01-01 00:00:00"]),
        "y": pick([2020, 2021, 2000, 1900, 2024]), "m": pick([1, 2, 12]),
        "dd": pick([28, 1, 15]), "hh": pick([0, 12, 23]), "mi": pick([0, 30, 59]),
        "sec": pick([0.0, 59.5, 12.25, 59.9999999]),
        "lat1": pick([52.52, 0.0, -33.9, 91.0, float("nan")]),
        "lon1": pick([13.40, 0.0, 151.2, -181.0]),
        "lat2": pick([48.85, 0.0, 40.7]), "lon2": pick([2.35, 90.0, -74.0]),
        "la": pick([["x", "y"], ["x"], [], ["ü", "x", "y"]]),
        "lb": pick([["x"], ["z"], ["y", "x"], []]),
        "u7": pick([_uuid7(ms, t) for ms, t in ((1_700_000_000_123, 5), (86_400_000, 77),
                                                (1_582_934_400_000, 1234))]),
        "path": pick([HERE, HERE + ".missing.png", str(pathlib.Path(HERE).parent)]),
        "lf": pick([[1.5, -2.0, None], [], [3.25], [0.0, 7.5, 1.0, -4.0]]),
        "emb": emb, "emb2": emb2,
    }


def _frame(pkg, cols):
    data = {k: v for k, v in cols.items() if k not in ("emb", "emb2")}
    emb_t = pkg.DataType.embedding(pkg.DataType.float32(), 8)
    data["emb"] = pkg.Series.from_numpy(cols["emb"], "emb", emb_t)
    data["emb2"] = pkg.Series.from_numpy(cols["emb2"], "emb2", emb_t)
    df = pkg.from_pydict(data)
    tz = pkg.DataType.timestamp("us", "America/New_York")
    return _materialized(pkg, df.with_columns({
        "ts": pkg.col("ts").cast(pkg.DataType.timestamp("us")),
        "tstz": pkg.col("ts").dt.replace_time_zone("UTC").cast(tz),
        "i32": pkg.col("i").cast(pkg.DataType.int32()),
        "f32": pkg.col("f").cast(pkg.DataType.float32()),
        "shift": pkg.col("small").cast(pkg.DataType.int64()),
        "d": pkg.col("d").cast(pkg.DataType.date()),
        "d2": pkg.col("d2").cast(pkg.DataType.date()),
        "b": pkg.col("b").cast(pkg.DataType.binary()),
        "z": pkg.col("z").cast(pkg.DataType.binary()),
    }))


def _materialized(pkg, df):
    """``df``'s result as a new in-memory DataFrame, so that a query over it
    counts only its own expressions on the device layer's counters."""
    rb = pkg.MicroPartition.concat(list(df.iter_partitions())).combined()
    return pkg.from_pydict({n: rb.get_column(n) for n in rb.column_names()})


def _F(pkg):
    return import_module(f"{pkg.__name__}.functions")


#: kernel name -> [(case id, build(pkg, col, F) -> Expression)].
CASES = {
    # string_ops
    "str_contains": [("", lambda p, c, F: c("s").str.contains("o"))],
    "str_startswith": [("", lambda p, c, F: c("s").str.startswith("He"))],
    "str_endswith": [("", lambda p, c, F: c("s").str.endswith("d"))],
    "str_match": [("re2", lambda p, c, F: c("s").str.match(r"^[a-z]+$"))],
    "str_length": [("", lambda p, c, F: c("s").str.length())],
    "str_length_bytes": [("", lambda p, c, F: c("s").str.length_bytes())],
    "str_lower": [("", lambda p, c, F: c("s").str.lower())],
    "str_upper": [("", lambda p, c, F: c("s").str.upper())],
    "str_capitalize": [("", lambda p, c, F: c("s").str.capitalize())],
    "str_reverse": [("", lambda p, c, F: c("s").str.reverse())],
    "str_lstrip": [("", lambda p, c, F: c("s").str.lstrip())],
    "str_rstrip": [("", lambda p, c, F: c("s").str.rstrip())],
    "str_strip": [("", lambda p, c, F: c("s").str.strip())],
    "str_split": [("plain", lambda p, c, F: c("s").str.split(" ")),
                  ("regex", lambda p, c, F: c("s").str.split(r"[ _.-]", regex=True))],
    "str_extract": [("", lambda p, c, F: c("s").str.extract(r"(\w)(\w+)", 2))],
    "str_extract_all": [("", lambda p, c, F: c("s").str.extract_all(r"\w+$"))],
    "str_replace": [("plain", lambda p, c, F: c("s").str.replace("l", "L")),
                    ("regex", lambda p, c, F: c("s").str.replace(r"\s+", "_", regex=True))],
    "str_left": [("", lambda p, c, F: c("s").str.left(3))],
    "str_right": [("", lambda p, c, F: c("s").str.right(3))],
    "str_find": [("", lambda p, c, F: c("s").str.find("l"))],
    "str_rpad": [("", lambda p, c, F: c("s").str.rpad(8, "*"))],
    "str_lpad": [("", lambda p, c, F: c("s").str.lpad(8, "ü"))],
    "str_repeat": [("", lambda p, c, F: c("s").str.repeat(2))],
    "str_like": [("", lambda p, c, F: c("s").str.like("%l%o%")),
                 ("newline", lambda p, c, F: c("s").str.like("abc"))],
    "str_ilike": [("", lambda p, c, F: c("s").str.ilike("%HELLO%"))],
    "str_substr": [("", lambda p, c, F: c("s").str.substr(1, 3)),
                   ("to_end", lambda p, c, F: c("s").str.substr(2))],
    "str_to_date": [("", lambda p, c, F: c("dstr").str.to_date("%Y-%m-%d"))],
    "str_to_datetime": [("naive", lambda p, c, F: c("tstr").str.to_datetime("%Y-%m-%d %H:%M:%S")),
                        ("tz", lambda p, c, F: c("tstr").str.to_datetime(
                            "%Y-%m-%d %H:%M:%S", timezone="Asia/Kolkata"))],
    "str_normalize": [("", lambda p, c, F: c("s").str.normalize(
        remove_punct=True, lowercase=True, nfd_unicode=True, white_space=True))],
    "str_count_matches": [("", lambda p, c, F: c("s").str.count_matches(
        ["l", "o"], case_sensitive=False)),
        ("words", lambda p, c, F: c("s").str.count_matches("hello", whole_words=True))],
    "concat_ws": [("", lambda p, c, F: F.concat_ws("-", c("s"), c("s2"), c("url").fill_null("u")))],
    # temporal_ops
    **{f"dt_{k}": [("", (lambda k: lambda p, c, F: getattr(c("ts").dt, k)())(k))]
       for k in ("day", "hour", "minute", "second", "millisecond", "microsecond", "month",
                 "quarter", "year", "day_of_year", "week_of_year", "date", "day_of_week",
                 "time", "nanosecond", "unix_date")},
    "dt_to_unix_epoch": [("", lambda p, c, F: c("ts").dt.to_unix_epoch("us"))],
    "dt_truncate": [("", lambda p, c, F: c("ts").dt.truncate("1 hour"))],
    "dt_strftime": [("ts", lambda p, c, F: c("ts").dt.strftime()),
                    ("date", lambda p, c, F: c("d").dt.strftime())],
    **{f"dt_total_{k}": [("", (lambda k: lambda p, c, F: getattr(c("dur").dt, f"total_{k}")())(k))]
       for k in ("seconds", "milliseconds", "microseconds", "minutes", "hours", "days",
                 "nanoseconds")},
    "date_from_unix_date": [("", lambda p, c, F: F.date_from_unix_date(c("i")))],
    "timestamp_seconds": [("", lambda p, c, F: F.timestamp_seconds(c("i")))],
    "timestamp_millis": [("", lambda p, c, F: F.timestamp_millis(c("i")))],
    "timestamp_micros": [("", lambda p, c, F: F.timestamp_micros(c("i")))],
    "date_add": [("days", lambda p, c, F: c("d").dt.date_add(1)),
                 ("column", lambda p, c, F: F.date_add(c("d"), c("small")))],
    "date_sub": [("days", lambda p, c, F: c("d").dt.date_sub(366)),
                 ("column", lambda p, c, F: F.date_sub(c("d"), c("small")))],
    "date_diff": [("", lambda p, c, F: c("d").dt.date_diff(c("d2")))],
    "add_months": [("", lambda p, c, F: c("d").dt.add_months(12)),
                   ("ts", lambda p, c, F: c("ts").dt.add_months(-1))],
    "months_between": [("", lambda p, c, F: c("d").dt.months_between(c("d2")))],
    "last_day": [("", lambda p, c, F: c("d").dt.last_day())],
    "next_day": [("", lambda p, c, F: c("d").dt.next_day("sat"))],
    "make_date": [("", lambda p, c, F: F.make_date(c("y"), c("m"), c("dd")))],
    "replace_time_zone": [("", lambda p, c, F: c("tstz").dt.replace_time_zone("Europe/Berlin")),
                          ("naive", lambda p, c, F: c("tstz").dt.replace_time_zone())],
    "convert_time_zone": [("", lambda p, c, F: c("tstz").dt.convert_time_zone("Asia/Tokyo")),
                          ("naive", lambda p, c, F: c("ts").dt.convert_time_zone("UTC"))],
    "make_timestamp": [("", lambda p, c, F: F.make_timestamp(
        c("y"), c("m"), c("dd"), c("hh"), c("mi"), c("sec"))),
        ("tz", lambda p, c, F: F.make_timestamp(
            c("y"), c("m"), c("dd"), c("hh"), c("mi"), c("sec"), timezone="America/New_York"))],
    **{f"extract_{k}_uuid7": [("", (lambda k: lambda p, c, F: getattr(
        F, f"extract_{k}_uuid7")(c("u7")))(k))] for k in ("minute", "hour", "day", "month")},
    # binary_ops
    "binary_length": [("", lambda p, c, F: c("b").binary.length())],
    "binary_concat": [("", lambda p, c, F: c("b").binary.concat(c("z")))],
    "binary_slice": [("", lambda p, c, F: c("b").binary.slice(1, 2))],
    # uri_ops
    "url_parse": [("", lambda p, c, F: c("url").url.parse())],
    # misc_ops
    "hash": [("", lambda p, c, F: c("s").hash()), ("seed", lambda p, c, F: c("i").hash(seed=7))],
    "fill_null": [("", lambda p, c, F: c("i").fill_null(0)),
                  ("str", lambda p, c, F: c("s").fill_null("?"))],
    "coalesce": [("", lambda p, c, F: F.coalesce(c("i"), c("small"), p.lit(-1)))],
    "minhash": [("", lambda p, c, F: c("s").minhash(num_hashes=8, ngram_size=2, seed=3))],
    "great_circle_distance": [("", lambda p, c, F: F.great_circle_distance(
        c("lat1"), c("lon1"), c("lat2"), c("lon2")))],
    # extended_ops: numeric, with a device lowering
    **{k: [("", (lambda k: lambda p, c, F: getattr(F, k)(c("f32")))(k))]
       for k in ("csc", "sec", "cot", "radians", "degrees", "negate")},
    "atanh": [("", lambda p, c, F: F.arctanh(c("f32")))],
    "acosh": [("", lambda p, c, F: F.arccosh(c("f32")))],
    "asinh": [("", lambda p, c, F: F.arcsinh(c("f32")))],
    "hypot": [("", lambda p, c, F: F.hypot(c("f32"), c("f32")))],
    "pmod": [("", lambda p, c, F: F.pmod(c("i32"), p.lit(7)))],
    "bitwise_and": [("", lambda p, c, F: F.bitwise_and(c("i32"), p.lit(12)))],
    "bitwise_or": [("", lambda p, c, F: F.bitwise_or(c("i32"), p.lit(3)))],
    "bitwise_xor": [("", lambda p, c, F: F.bitwise_xor(c("i32"), c("i32")))],
    "bitwise_not": [("", lambda p, c, F: F.bitwise_not(c("i32")))],
    "cosine_similarity": [("", lambda p, c, F: F.cosine_similarity(c("emb"), c("emb2")))],
    # extended_ops: host only
    "factorial": [("", lambda p, c, F: F.factorial(c("fact")))],
    "bin": [("", lambda p, c, F: F.bin(c("small")))],
    "conv": [("", lambda p, c, F: F.conv(c("i"), 10, 16))],
    "shift_left": [("", lambda p, c, F: F.shift_left(c("i"), c("shift")))],
    "shift_right": [("", lambda p, c, F: F.shift_right(c("i"), c("shift")))],
    **{f"str_{k}": [("", (lambda k: lambda p, c, F: getattr(c("s").str, k)())(k))]
       for k in ("to_camel_case", "to_upper_camel_case", "to_snake_case",
                 "to_upper_snake_case", "to_kebab_case", "to_upper_kebab_case",
                 "to_title_case", "swapcase", "soundex")},
    "str_translate": [("", lambda p, c, F: c("s").str.translate("loü", "LO"))],
    "str_substring_index": [("", lambda p, c, F: c("s").str.substring_index(".", 2)),
                            ("neg", lambda p, c, F: F.substring_index(c("s"), " ", -1))],
    "ascii": [("", lambda p, c, F: c("s").str.ascii())],
    "chr": [("", lambda p, c, F: F.chr_func(c("small") + 64))],
    "space": [("", lambda p, c, F: F.space(c("small")))],
    "format_string": [("", lambda p, c, F: F.format("%s|%d", c("s"), c("i")))],
    "levenshtein_distance": [("", lambda p, c, F: c("s").str.levenshtein_distance(c("s2")))],
    "damerau_levenshtein_distance": [
        ("", lambda p, c, F: c("s").str.damerau_levenshtein_distance(c("s2")))],
    "jaro_similarity": [("", lambda p, c, F: c("s").str.jaro_similarity(c("s2")))],
    "jaro_winkler_similarity": [
        ("", lambda p, c, F: c("s").str.jaro_winkler_similarity(c("s2")))],
    "hamming_distance_str": [("", lambda p, c, F: c("h1").str.hamming_distance(c("h2")))],
    "json_query": [("", lambda p, c, F: c("j").str.json_query(".a.b[1]"))],
    "json_array_length": [("", lambda p, c, F: c("j").str.json_array_length())],
    "json_object_keys": [("", lambda p, c, F: c("j").str.json_object_keys())],
    "serialize": [("", lambda p, c, F: c("s").serialize())],
    "deserialize": [("", lambda p, c, F: F.deserialize(c("j").str.json_array_length()
                                                      .cast(p.DataType.string())))],
    "try_deserialize": [("", lambda p, c, F: c("j").try_deserialize())],
    "encode": [("base64", lambda p, c, F: c("b").encode("base64")),
               ("hex", lambda p, c, F: c("s").encode("hex"))],
    "decode": [("", lambda p, c, F: c("b").encode("base64").decode("base64"))],
    "try_encode": [("", lambda p, c, F: c("s").try_encode("utf-8"))],
    "try_decode": [("", lambda p, c, F: c("b64").try_decode("base64"))],
    "compress": [("zlib", lambda p, c, F: c("b").compress("zlib")),
                 ("zstd", lambda p, c, F: c("s").compress("zstd"))],
    "decompress": [("", lambda p, c, F: c("z").decompress("zlib"))],
    "try_compress": [("", lambda p, c, F: c("b").binary.try_compress("zlib"))],
    "try_decompress": [("", lambda p, c, F: c("z").binary.try_decompress("zlib"))],
    "random_int": [("", lambda p, c, F: F.random_int(c("i"), 0, 1000, seed=42))],
    "eq_null_safe": [("", lambda p, c, F: F.eq_null_safe(c("i"), c("small")))],
    "simhash": [("", lambda p, c, F: c("s").simhash())],
    "partition_days": [("", lambda p, c, F: c("ts").partitioning.days())],
    "partition_hours": [("", lambda p, c, F: c("ts").partitioning.hours())],
    "partition_months": [("", lambda p, c, F: c("d").partitioning.months())],
    "partition_years": [("", lambda p, c, F: c("d").partitioning.years())],
    "partition_iceberg_bucket": [("", lambda p, c, F: c("s").partitioning.iceberg_bucket(7))],
    "partition_iceberg_truncate": [("int", lambda p, c, F: c("i").partitioning.iceberg_truncate(10)),
                                   ("str", lambda p, c, F: c("s").partitioning.iceberg_truncate(3))],
    "hamming_distance": [("", lambda p, c, F: F.hamming_distance(c("emb"), c("emb2")))],
    "pearson_correlation": [("", lambda p, c, F: F.pearson_correlation(c("emb"), c("emb2")))],
    "jaccard_similarity": [("", lambda p, c, F: F.jaccard_similarity(c("la"), c("lb")))],
    "file_size": [("", lambda p, c, F: F.file_size(c("path")))],
    "file_exists": [("", lambda p, c, F: F.file_exists(c("path")))],
    "guess_mime_type": [("", lambda p, c, F: F.guess_mime_type(c("path")))],
    "try_cast": [("int", lambda p, c, F: c("num").try_cast(p.DataType.int64())),
                 ("float", lambda p, c, F: c("num").try_cast(p.DataType.float64()))],
    "list_count_distinct": [("", lambda p, c, F: c("la").list.count_distinct())],
    "list_quantile": [("one", lambda p, c, F: c("lf").list.quantile(0.5)),
                      ("many", lambda p, c, F: c("lf").list.quantile([0.1, 0.9]))],
    "pow_3_2": [("", lambda p, c, F: _call(p, "pow_3_2", c("f")))],
    # The UDAF finalizers: over each row's list, and over each row's
    # pickled partial state (made by a row-wise UDF from the same list).
    "udaf_apply": [("", lambda p, c, F: _call(p, "udaf_apply", c("lf"), udaf=_udaf(p)))],
    "udaf_finalize": [("", lambda p, c, F: _call(
        p, "udaf_finalize", c("lf").apply(_pickled_state, p.DataType.binary()),
        udaf=_udaf(p, _SumState)))],
}


def _list_sum(values):
    return float(sum(values)) if values else None


class _SumState:
    """A UDAF class with ``merge``: the sum of the values it accumulated."""

    def __init__(self):
        self.total, self.n = 0.0, 0

    def accumulate(self, values):
        self.total += sum(values)
        self.n += len(values)

    def merge(self, other):
        self.total += other.total
        self.n += other.n

    def finalize(self):
        return self.total if self.n else None


def _udaf(pkg, fn_or_cls=_list_sum):
    return pkg.udf.udaf(pkg.DataType.float64())(fn_or_cls)


def _pickled_state(values):
    import cloudpickle

    if values is None:
        return None
    state = _SumState()
    state.accumulate([v for v in values if v is not None])
    return cloudpickle.dumps(state)


def _call(pkg, name, *args, **kwargs):
    """The registry kernel ``name`` over ``args`` as ``pkg``'s Expression."""
    call = import_module(f"{pkg.__name__}.expressions.expr").FunctionCall
    return pkg.Expression(call(name, [a._expr for a in args], kwargs))
#: Kernels whose output is not a function of the inputs, checked on their own
#: below, and the nodes that are no kernel: ``monotonically_increasing_id`` is
#: a marker the optimizer rewrites (``test_left_out_kernels_raise_through_a_plan_with_their_item``
#: and tests/test_torch_optimizer.py), ``dd_quantile`` reads the sketches of
#: ``approx_percentile`` (tests/test_torch_nested.py); ``url_download`` /
#: ``url_upload`` read and write files (``test_left_out_kernels_raise_through_a_plan_with_their_item``
#: and tests/test_torch_remote_io.py).
SPECIAL = {"uuid", "today", "now", "monotonically_increasing_id", "dd_quantile",
           "url_download", "url_upload"}
_PARAMS = [pytest.param(name, build, id=f"{name}-{cid}" if cid else name)
           for name, cases in CASES.items() for cid, build in cases]


#: The port's host reasons as the JAX package counts them: its chain records
#: ``nullable_unsafe`` and a device error under the device layer's own names,
#: and it counts the 64-bit cap as ``not_fusable``.
_AS_JAX = {"chain_nullable_unsafe": "nullable_unsafe", "chain_device_error": "device_error",
           "dtype_64bit": "not_fusable"}


def _route_snapshots():
    """(the JAX package's, the port's) device-layer routes since the last
    reset: fused expressions and host expressions by reason."""
    jsnap = jde.device_eval_metrics.snapshot()
    psnap = tde.device_eval_counters.snapshot()
    host = {}
    for k, v in psnap["host_exprs"].items():
        k = _AS_JAX.get(k, k)
        if not k.startswith("chain_"):
            host[k] = host.get(k, 0) + v
    return ({"fused_exprs": jsnap["fused_exprs"], "host": jsnap["fallback_reasons"]},
            {"fused_exprs": psnap["fused_exprs"], "host": host})


@pytest.mark.parametrize("name, build", _PARAMS)
def test_kernel_parity(name, build):
    cols = _columns()
    frames = [_frame(pkg, cols) for pkg in PKGS]
    outs = []
    jde.device_eval_metrics.reset()
    tde.device_eval_counters.reset()
    for pkg, df in zip(PKGS, frames):
        # The route counters count per morsel. A UDF without a batch_size
        # (the ``.apply`` of ``udaf_finalize``) is re-morselled by a
        # latency-driven batching in both packages, whose boundaries follow
        # the host's load (test_dynamic_batching_follows_the_same_latencies),
        # so the counted routes are compared over fixed morsels.
        with pkg.execution_config_ctx(udf_dynamic_batching=False):
            outs.append(df.select(build(pkg, pkg.col, _F(pkg)).alias("o")).to_pydict())
    _assert_same(outs[0], outs[1], FLOAT_RTOL.get(name, 0.0))
    assert any(v is not None for v in outs[1]["o"]), "every row is null: the case tests nothing"
    jax, port = _route_snapshots()
    assert jax == port


@pytest.mark.parametrize("latencies_ms", [
    [0.4, 0.8],                      # an idle host: 1 row, then the rest
    [11.6, 0.9, 1.0],                # a 12 ms stall on the first morsel
    [250.0, 300.0, 0.5, 0.5, 0.5],   # past the 0.2 s target: contract
], ids=["idle", "stall", "overshoot"])
def test_dynamic_batching_follows_the_same_latencies(latencies_ms):
    """The latency-driven batching of a UDF without a batch_size re-slices
    a 48-row stream at the same boundaries in both packages when each batch
    takes the same time: its boundaries are a function of the measured
    latencies, which the host's load moves (ROADMAP C.47)."""
    from daft_tpu.execution import dynamic_batching as jdb
    from daft_tpu_torch.execution import dynamic_batching as tdb

    sizes = []
    for pkg, mod in zip(PKGS, (jdb, tdb)):
        state = mod.LatencyConstrainedBatching(target_latency_s=0.2, b_max=256 * 1024).make_state()
        lat = iter(latencies_ms + [0.5] * 48)
        source = [pkg.MicroPartition.from_pydict({"x": list(range(i, i + 8))})
                  for i in range(0, 48, 8)]
        seen = []
        for mp in mod.dynamic_remorsel(iter(source), state):
            seen.append(len(mp))
            state.record(len(mp), next(lat) / 1e3)
        sizes.append(seen)
    assert sizes[0] == sizes[1]
    assert sum(sizes[1]) == 48


def test_random_kernels_and_the_frozen_clock():
    """``uuid`` is random: 36-character distinct strings in both packages.
    ``today`` and ``now`` read the per-query clock: one instant for every
    morsel of a statement, within the run's wall-clock bracket, as in the
    JAX package."""
    cols = {"i": list(range(40))}
    for pkg in PKGS:
        F = _F(pkg)
        u = pkg.from_pydict(cols).select(F.uuid(pkg.col("i")).alias("u")).to_pydict()["u"]
        assert len(set(u)) == 40 and all(len(x) == 36 and x.count("-") == 4 for x in u)
        call = import_module(f"{pkg.__name__}.expressions.expr").FunctionCall
        with pkg.execution_config_ctx(default_morsel_size=7):
            before = datetime.datetime.now(datetime.timezone.utc).replace(tzinfo=None)
            out = pkg.from_pydict(cols).where(pkg.col("i") >= 0).select(
                pkg.Expression(call("now", [pkg.col("i")._expr])).alias("n"),
                pkg.Expression(call("today", [pkg.col("i")._expr])).alias("t")).to_pydict()
            after = datetime.datetime.now(datetime.timezone.utc).replace(tzinfo=None)
        assert len(set(out["n"])) == 1 and len(set(out["t"])) == 1, pkg.__name__
        assert before <= out["n"][0] <= after
        assert out["t"][0] in (before.date(), after.date())


def test_query_now_is_frozen_inside_a_query_only():
    from daft_tpu_torch.context import frozen_clock_scope, iter_with_frozen_clock, query_now

    at = datetime.datetime(2020, 2, 29, 12, tzinfo=datetime.timezone.utc)
    with frozen_clock_scope(at):
        assert query_now() == at
    assert query_now() != at

    def gen():
        yield query_now()
        yield query_now()

    a, b = list(iter_with_frozen_clock(gen()))
    assert a == b != query_now()


def test_every_kernel_is_ported_with_a_case_or_left_out_with_its_item():
    """Every name the JAX package's string, temporal, binary, URI, misc and
    extended kernel modules register is in the port's registry with a parity
    case here, or in ``LEFT_OUT`` with the ROADMAP item that ports it, and
    ``get_kernel`` raises naming that item."""
    from daft_tpu.kernels import registry as jreg

    modules = {f"daft_tpu.kernels.{m}" for m in
               ("string_ops", "temporal_ops", "binary_ops", "uri_ops", "misc_ops", "extended_ops")}
    names = [n for n, k in jreg.all_kernels().items() if k.fn.__module__ in modules]
    assert len(names) > 150
    ported = preg.all_kernels()
    for n in names:
        if n in ported:
            assert n in CASES or n in SPECIAL, f"{n} is ported without a parity case"
        else:
            item = preg.LEFT_OUT.get(n)
            assert item and item.startswith("ROADMAP A."), n
            with pytest.raises(DaftNotImplementedError, match=item.split(" (")[0].replace(".", r"\.")):
                preg.get_kernel(n)
    assert set(preg.LEFT_OUT) <= set(jreg.all_kernels())
    assert not set(ported) - set(jreg.all_kernels())


def _wav(rate: int = 8000, frames: int = 400) -> bytes:
    import io
    import wave

    pcm = np.random.default_rng(rate).integers(-32768, 32767, frames, dtype=np.int16)
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(pcm.tobytes())
    return buf.getvalue()


#: Each kernel's input column for the cases that ROADMAP A.3.5 and A.2
#: brought, and its keywords for ``pkg``.
_BROUGHT = {"list_sum": {"a": [[1, 2, None], None, []]}, "pow_3_2": {"a": [4.0, None, 2.25]},
            "monotonically_increasing_id": {"a": ["x", "y", None]},
            "udaf_apply": {"a": [[1.0, 2.5, None], None, []]},
            "audio_metadata": {"a": [_wav(), None]}}
_BROUGHT_KWARGS = {"udaf_apply": lambda pkg: {"udaf": _udaf(pkg)}}


@pytest.mark.parametrize("name", ["url_download", "url_upload", "list_sum", "monotonically_increasing_id",
                                  "udaf_apply", "pow_3_2", "audio_metadata"])
def test_left_out_kernels_raise_through_a_plan_with_their_item(name, tmp_path):
    """A kernel the port left out would raise through a plan naming its
    ROADMAP item; ``registry.LEFT_OUT`` is empty since ROADMAP A.8.2 brought
    ``url_download`` and ``url_upload``. Those, and the ones ROADMAP A.3.5 and
    A.2 brought (``list_sum``, ``pow_3_2``, the
    ``monotonically_increasing_id`` marker, which ``DetectMonotonicId``
    rewrites, ``udaf_apply`` and ``audio_metadata``), run through the same
    plan as in the JAX package: an upload's locations differ by their random
    names, so its bytes read back are compared."""
    data = _BROUGHT.get(name, {"a": ["x"]})
    if name == "url_download":
        (tmp_path / "x.bin").write_bytes(b"payload")
        data = {"a": [str(tmp_path / "x.bin"), None]}
    elif name == "url_upload":
        data = {"a": [b"abc", None]}

    def run(pkg):
        kwargs = _BROUGHT_KWARGS.get(name, lambda p: {})(pkg)
        if name == "url_upload":
            kwargs = {"location": str(tmp_path / pkg.__name__)}
        out = pkg.from_pydict(data).select(
            _call(pkg, name, pkg.col("a"), **kwargs).alias("o")).to_pydict()
        if name == "url_upload":
            out["o"] = [None if p is None else open(p, "rb").read() for p in out["o"]]
        return out

    assert not preg.LEFT_OUT
    assert run(daft_tpu) == run(daft_tpu_torch) and name not in preg.LEFT_OUT


def test_left_out_namespaces_raise_with_their_item():
    """``apply`` (ROADMAP A.2) gives the JAX package's rows; the ``.list`` /
    ``.struct`` / ``.map`` namespaces, ``[]``, ``over``, ``lag`` and
    ``median`` that A.3.5 brought build the JAX package's expressions."""
    c = daft_tpu_torch.col("a")
    applied = [pkg.from_pydict({"a": [-2, None, 3]}).select(
        pkg.col("a").apply(lambda v: None if v is None else abs(v), pkg.DataType.int64())
    ).to_pydict() for pkg in PKGS]
    assert applied[0] == applied[1] == {"a": [2, None, 3]}
    w = [pkg.Window().partition_by("g").order_by("a") for pkg in PKGS]
    builds = (lambda p, i: p.col("a").list.sum(), lambda p, i: p.col("a").struct.get("x"),
              lambda p, i: p.col("a").map.get("k"), lambda p, i: p.col("a")[0],
              lambda p, i: p.col("a").sum().over(w[i]), lambda p, i: p.col("a").lag().over(w[i]),
              lambda p, i: p.col("a").median())
    for build in builds:
        jax_expr, port_expr = (build(pkg, i)._expr for i, pkg in enumerate(PKGS))
        assert repr(port_expr) == repr(jax_expr) and port_expr.name() == jax_expr.name()
        assert type(port_expr).__name__ == type(jax_expr).__name__
    # An IN subquery over a DataFrame is ported: it builds the InSubquery
    # node that the optimizer unnests into a semi join.
    from daft_tpu_torch.expressions.expr import InSubquery

    assert isinstance(c.is_in(daft_tpu_torch.from_pydict({"a": [1]}))._expr, InSubquery)


# -- nodes: is_in, eq_null_safe, the shifts -------------------------------------
@pytest.mark.parametrize("build", [
    lambda p: p.col("i").is_in([1, -2, None, 40]),
    lambda p: p.col("s").is_in(["Hello World", "", "日本語テキスト"]),
    lambda p: p.col("d").is_in([datetime.date(2020, 2, 29), datetime.date(1900, 3, 1)]),
    lambda p: p.col("i").is_in(p.col("small")),
    lambda p: p.col("i").eq_null_safe(p.col("small")),
    lambda p: p.col("s").eq_null_safe(p.lit(None)),
    lambda p: p.col("i").shift_left(p.col("shift")),
    lambda p: p.col("i32").shift_right(2),
    lambda p: ~p.col("f").is_in([float("nan")]),
], ids=["isin_int", "isin_str", "isin_date", "isin_column", "eq_null_safe",
        "eq_null_safe_null_literal", "lshift", "rshift", "isin_nan"])
def test_new_nodes_equal_the_jax_package_and_take_its_route(build):
    cols = _columns()
    frames = [_frame(pkg, cols) for pkg in PKGS]
    jde.device_eval_metrics.reset()
    tde.device_eval_counters.reset()
    outs = [df.select(build(pkg).alias("o")).to_pydict() for pkg, df in zip(PKGS, frames)]
    _assert_same(*outs)
    jax, port = _route_snapshots()
    assert jax == port
    assert port["host"] == {"not_fusable": 1} and port["fused_exprs"] == 0


def _jax_chain_kinds() -> dict:
    from daft_tpu import metrics

    snap = metrics.get_registry().snapshot()
    return {k: int(v) for k, v in snap.label_totals("daft_compiled_chain_rows_total",
                                                    "kind").items() if v}


@pytest.mark.parametrize("where", [
    lambda p: p.col("s").is_in(["x", "Hello World"]),
    lambda p: p.col("s").str.contains("o") & (p.col("f32") > 0),
    lambda p: (p.col("i32").is_in([1, 2, 3]) | ((p.col("i32") >= 10) & (p.col("i32") <= 500)))
    & (p.col("f32") < p.lit(5.0, p.DataType.float32())),
    lambda p: p.col("i32") > 0,
], ids=["isin", "str_and_numeric", "q19_like", "numeric_only"])
def test_filter_routes_equal_the_jax_package(where):
    """A filter with a string kernel or ``is_in`` anywhere in it is refused
    whole by the device chain in both packages and runs on the host; a
    numeric one runs in the chain. Rows and chain counters are equal."""
    cols = _columns()
    jframe, pframe = (_frame(pkg, cols) for pkg in PKGS)
    tde.device_eval_counters.reset()
    port = pframe.where(where(daft_tpu_torch)).select("i", "s").to_pydict()
    before = _jax_chain_kinds()
    jax = jframe.where(where(daft_tpu)).select("i", "s").to_pydict()
    after = _jax_chain_kinds()
    _assert_same(jax, port)
    jax_kinds = {k: after.get(k, 0) - before.get(k, 0) for k in after}
    snap = tde.device_eval_counters.snapshot()
    assert snap["chain_rows"] == {k: v for k, v in jax_kinds.items() if v}
    numeric = "filter_project" in snap["chain_rows"]
    assert numeric == (snap["host_rows"].get("chain_not_fusable", 0) == 0)


def test_concat_ws_over_an_all_null_row_raises_in_both_packages():
    """ROADMAP C.34, the reference's own behaviour: Arrow's
    ``binary_join_element_wise`` with ``null_handling="skip"`` drops a row
    whose inputs are all null, so the result is short and both packages
    raise building the batch."""
    for pkg in PKGS:
        df = pkg.from_pydict({"a": ["x", None, "y"], "b": ["1", None, None]})
        with pytest.raises(Exception, match="has length 2, expected 3"):
            df.select(_F(pkg).concat_ws("-", pkg.col("a"), pkg.col("b")).alias("o")).to_pydict()


def test_python_re_and_re2_decide_different_rows_where_the_reference_says():
    """``str_extract`` keeps Python ``re`` and ``str_match`` / ``str_like``
    keep RE2, as in the JAX package: on ``"abc\\n"`` Python's ``$`` matches
    before the final newline and RE2's does not."""
    dt = daft_tpu_torch
    df = dt.from_pydict({"s": ["abc\n", "abc"]})
    out = df.select(dt.col("s").str.match("^abc$").alias("m"),
                    dt.col("s").str.like("abc").alias("l"),
                    dt.col("s").str.extract("^(abc)$", 1).alias("e")).to_pydict()
    assert out == {"m": [False, True], "l": [False, True], "e": ["abc", "abc"]}
    jax = daft_tpu.from_pydict({"s": ["abc\n", "abc"]}).select(
        daft_tpu.col("s").str.match("^abc$").alias("m"),
        daft_tpu.col("s").str.like("abc").alias("l"),
        daft_tpu.col("s").str.extract("^(abc)$", 1).alias("e")).to_pydict()
    assert jax == out


def test_tz_database_and_arrow_functions_are_present():
    """No fallback: the temporal kernels need the system's tz database and
    Arrow's time-zone functions, which must exist."""
    import zoneinfo

    import pyarrow.compute as pc

    zoneinfo.ZoneInfo("America/New_York")
    for fn in ("assume_timezone", "local_timestamp", "strptime", "strftime", "floor_temporal",
               "utf8_slice_codeunits", "match_substring_regex", "binary_join_element_wise"):
        assert hasattr(pc, fn), fn
    a = pa.array([datetime.datetime(2021, 3, 14, 2, 30)], pa.timestamp("us"))
    with pytest.raises(pa.ArrowInvalid):  # a wall-clock time that does not exist there
        pc.assume_timezone(a, "America/New_York")
