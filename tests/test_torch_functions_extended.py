"""The port's free-function library (``daft_tpu_torch.functions``) and the
flat ``Expression`` aliases against the JAX package, on the CPU.

Mirrors tests/test_functions_extended.py, leaving out its ``.list`` and
new-aggregation cases (tests/test_torch_nested.py). Each check runs the same inputs
through the JAX package's ``daft_tpu.functions`` and the port's
(``device="cpu"``): the results must be equal, floats bit for bit, and the
reference's expected values must hold in the port. Then the functions the
port leaves out raise ``DaftNotImplementedError`` naming their ROADMAP item
(the window, list, struct, map and aggregation functions that A.3.5 brought
run as in the JAX package), and every public function of the JAX package's library has a namesake in
the port's.
"""

import datetime
import inspect
import math
import os

import numpy as np
import pytest

import daft_tpu
import daft_tpu.functions as JF
import daft_tpu_torch
import daft_tpu_torch.functions as PF
from daft_tpu_torch.errors import DaftNotImplementedError

PAIRS = ((daft_tpu, JF), (daft_tpu_torch, PF))


@pytest.fixture(autouse=True)
def _configs():
    with daft_tpu.execution_config_ctx(result_cache_enabled=False), \
            daft_tpu_torch.execution_config_ctx(device="cpu", result_cache_enabled=False):
        yield


def _data():
    return {
        "x": [1.0, 4.0, 9.0],
        "i": [1, 5, 12],
        "s": ["hello world", "FooBar baz", "a-b-c"],
        "d": [datetime.date(2020, 1, 31), datetime.date(2021, 6, 15),
              datetime.date(2022, 12, 1)],
    }


def both(build, data=None):
    """``build(pkg, F, df)`` -> Expression, selected as ``o`` in both
    packages; returns the port's column after holding it equal to the JAX
    package's."""
    outs = []
    for pkg, F in PAIRS:
        df = pkg.from_pydict(_data() if data is None else data)
        outs.append(df.select(build(pkg, F, df).alias("o")).to_pydict()["o"])
    jax, port = outs
    assert len(jax) == len(port)
    for a, b in zip(jax, port):
        if isinstance(a, float) and math.isnan(a):
            assert isinstance(b, float) and math.isnan(b)
        else:
            assert a == b and type(a) is type(b), (a, b)
    return port


def test_numeric_long_tail():
    c = lambda p: p.col  # noqa: E731
    assert both(lambda p, F, df: F.negate(c(p)("x"))) == [-1.0, -4.0, -9.0]
    np.testing.assert_allclose(both(lambda p, F, df: F.radians(c(p)("x"))),
                               np.radians([1.0, 4.0, 9.0]))
    np.testing.assert_allclose(both(lambda p, F, df: F.degrees(c(p)("x"))),
                               np.degrees([1.0, 4.0, 9.0]))
    np.testing.assert_allclose(both(lambda p, F, df: F.hypot(c(p)("x"), c(p)("x"))),
                               np.hypot([1, 4, 9], [1, 4, 9]))
    assert both(lambda p, F, df: F.factorial(c(p)("i"))) == [1, 120, 479001600]
    assert both(lambda p, F, df: F.pmod(c(p)("i"), p.lit(3))) == [1, 2, 0]
    assert both(lambda p, F, df: F.bin(c(p)("i"))) == ["1", "101", "1100"]
    assert both(lambda p, F, df: F.conv(c(p)("i"), 10, 2)) == ["1", "101", "1100"]
    np.testing.assert_allclose(both(lambda p, F, df: F.csc(c(p)("x"))),
                               1 / np.sin([1.0, 4.0, 9.0]))
    np.testing.assert_allclose(both(lambda p, F, df: F.arcsinh(c(p)("x"))),
                               np.arcsinh([1.0, 4.0, 9.0]))


def test_bitwise():
    assert both(lambda p, F, df: F.bitwise_and(p.col("i"), p.lit(4))) == [0, 4, 4]
    assert both(lambda p, F, df: F.bitwise_or(p.col("i"), p.lit(2))) == [3, 7, 14]
    assert both(lambda p, F, df: F.bitwise_xor(p.col("i"), p.lit(1))) == [0, 4, 13]
    assert both(lambda p, F, df: F.shift_left(p.col("i"), p.lit(1))) == [2, 10, 24]
    assert both(lambda p, F, df: F.shift_right(p.col("i"), p.lit(1))) == [0, 2, 6]
    # The BinaryOp form (Expression.shift_left / shift_right).
    assert both(lambda p, F, df: p.col("i").shift_left(2)) == [4, 20, 48]
    assert both(lambda p, F, df: p.col("i").shift_right(p.col("i") - p.col("i") + 2)) == [0, 1, 3]


def test_string_cases():
    s = lambda p: p.col("s")  # noqa: E731
    assert both(lambda p, F, df: s(p).str.to_snake_case()) == [
        "hello_world", "foo_bar_baz", "a_b_c"]
    assert both(lambda p, F, df: s(p).str.to_camel_case()) == ["helloWorld", "fooBarBaz", "aBC"]
    assert both(lambda p, F, df: s(p).str.to_kebab_case()) == [
        "hello-world", "foo-bar-baz", "a-b-c"]
    assert both(lambda p, F, df: s(p).str.to_title_case()) == [
        "Hello World", "Foo Bar Baz", "A B C"]
    assert both(lambda p, F, df: F.to_upper_snake_case(s(p))) == [
        "HELLO_WORLD", "FOO_BAR_BAZ", "A_B_C"]


def test_string_distances():
    d = {"a": ["kitten", "abc"], "b": ["sitting", "abc"]}
    assert both(lambda p, F, df: p.col("a").str.levenshtein_distance(p.col("b")), d) == [3, 0]
    assert both(lambda p, F, df: F.damerau_levenshtein_distance(p.col("a"), p.col("b")),
                d) == [3, 0]
    sim = both(lambda p, F, df: p.col("a").str.jaro_winkler_similarity(p.col("b")), d)
    assert sim[1] == 1.0 and 0.5 < sim[0] < 1.0
    d2 = {"a": ["karolin"], "b": ["kathrin"]}
    assert both(lambda p, F, df: p.col("a").str.hamming_distance(p.col("b")), d2) == [3]


def test_string_misc():
    assert both(lambda p, F, df: F.translate(p.col("s"), "lo", "LO"))[0] == "heLLO wOrLd"
    d = {"s": ["a.b.c.d"]}
    assert both(lambda p, F, df: F.substring_index(p.col("s"), ".", 2), d) == ["a.b"]
    assert both(lambda p, F, df: F.substring_index(p.col("s"), ".", -1), d) == ["d"]
    assert both(lambda p, F, df: F.soundex(p.col("s")), {"s": ["Robert"]}) == ["R163"]
    assert both(lambda p, F, df: F.ascii_func(p.col("s")), {"s": ["Abc"]}) == [65]
    assert both(lambda p, F, df: F.chr_func(p.col("i")), {"i": [65]}) == ["A"]
    assert both(lambda p, F, df: F.space(p.col("i")), {"i": [3]}) == ["   "]
    assert both(lambda p, F, df: F.format("%d-%s", p.col("a"), p.col("b")),
                {"a": [1], "b": ["x"]}) == ["1-x"]


def test_json():
    d = {"j": ['{"a": {"b": [1, 2, 3]}}', '[1,2]', 'nope']}
    assert both(lambda p, F, df: p.col("j").str.json_query(".a.b[1]"), d) == ["2", None, None]
    assert both(lambda p, F, df: F.json_array_length(p.col("j")), d) == [None, 2, None]
    assert both(lambda p, F, df: F.json_object_keys(p.col("j")), d) == [["a"], None, None]
    ser = both(lambda p, F, df: F.try_deserialize(p.col("j")).serialize(), d)
    assert ser[1] == "[1, 2]"
    cols = [pkg.from_pydict(d).select(*F.json_tuple(pkg.col("j"), "a", ".a.b")).to_pydict()
            for pkg, F in PAIRS]
    assert cols[0] == cols[1] == {"c0": ['{"b": [1, 2, 3]}', None, None],
                                  "c1": ["[1, 2, 3]", None, None]}


def test_binary_codecs():
    d = {"s": ["hello", "world"]}
    back = both(lambda p, F, df: p.col("s").encode("base64").decode("base64"), d)
    assert [bytes(b).decode() for b in back] == ["hello", "world"]
    out = both(lambda p, F, df: F.decompress(F.compress(p.col("s"), "zstd"), "zstd"), d)
    assert [bytes(b).decode() for b in out] == ["hello", "world"]
    out = both(lambda p, F, df: F.decompress(F.compress(p.col("s"), "zlib"), "zlib"), d)
    assert [bytes(b).decode() for b in out] == ["hello", "world"]
    # gzip carries its compression time: a round trip only.
    for pkg, F in PAIRS:
        out = pkg.from_pydict(d).select(
            F.decompress(F.compress(pkg.col("s"), "gzip"), "gzip").alias("o")).to_pydict()["o"]
        assert [bytes(b).decode() for b in out] == ["hello", "world"]
    bad = {"s": ["!!!not-base64!!!"]}
    assert both(lambda p, F, df: F.try_decode(p.col("s"), "base64"), bad) in ([None], [b""])
    assert both(lambda p, F, df: p.col("s").binary.length(), {"s": [b"ab", b"", None]}) == [
        2, 0, None]


def test_datetime_long_tail():
    d = lambda p: p.col("d")  # noqa: E731
    assert both(lambda p, F, df: d(p).dt.last_day()) == [
        datetime.date(2020, 1, 31), datetime.date(2021, 6, 30), datetime.date(2022, 12, 31)]
    assert both(lambda p, F, df: F.date_add(d(p), 1))[0] == datetime.date(2020, 2, 1)
    assert both(lambda p, F, df: F.date_sub(d(p), 31))[0] == datetime.date(2019, 12, 31)
    assert both(lambda p, F, df: d(p).dt.add_months(1))[0] == datetime.date(2020, 2, 29)
    assert both(lambda p, F, df: F.date_diff(d(p), d(p))) == [0, 0, 0]
    assert both(lambda p, F, df: F.make_date(p.lit(2024), p.lit(2), p.lit(29))) == [
        datetime.date(2024, 2, 29)] * 3
    assert both(lambda p, F, df: F.next_day(d(p), "mon"))[0].weekday() == 0
    assert both(lambda p, F, df: F.unix_date(d(p)))[0] == (
        datetime.date(2020, 1, 31) - datetime.date(1970, 1, 1)).days
    assert both(lambda p, F, df: F.date_from_unix_date(F.unix_date(d(p)))) == _data()["d"]
    assert both(lambda p, F, df: F.months_between(d(p), d(p))) == [0.0, 0.0, 0.0]
    ts = both(lambda p, F, df: F.timestamp_seconds(p.col("t")), {"t": [0, 86400]})
    assert ts[1] - ts[0] == datetime.timedelta(days=1)
    assert both(lambda p, F, df: F.datepart("quarter", d(p))) == [1, 2, 4]
    assert both(lambda p, F, df: F.date_trunc("month", p.col("t").cast(
        p.DataType.timestamp("us"))), {"t": [datetime.datetime(2020, 2, 29, 13, 5)]}) == [
        datetime.datetime(2020, 2, 1)]


def test_partitioning():
    t = {"t": [datetime.datetime(1970, 1, 2, 3, 0, 0)]}
    assert both(lambda p, F, df: p.col("t").partitioning.days(), t) == [1]
    assert both(lambda p, F, df: p.col("t").partitioning.hours(), t) == [27]
    assert both(lambda p, F, df: p.col("d").partitioning.years()) == [50, 51, 52]
    assert both(lambda p, F, df: p.col("d").partitioning.months()) == [600, 617, 635]
    assert both(lambda p, F, df: p.col("i").partitioning.iceberg_truncate(10)) == [0, 0, 10]
    buckets = both(lambda p, F, df: p.col("i").partitioning.iceberg_bucket(4))
    assert all(0 <= b < 4 for b in buckets)


def test_similarity():
    data = {"a": [[1.0, 0.0], [1.0, 1.0]], "b": [[1.0, 0.0], [1.0, 0.0]],
            "la": [["x", "y"], ["x"]], "lb": [["x"], ["z"]]}

    def emb(p, name):
        return p.col(name).cast(p.DataType.embedding(p.DataType.float32(), 2))

    np.testing.assert_allclose(
        both(lambda p, F, df: F.cosine_similarity(emb(p, "a"), emb(p, "b")), data),
        [1.0, math.sqrt(0.5)], rtol=1e-6)
    assert both(lambda p, F, df: F.hamming_distance(emb(p, "a"), emb(p, "b")), data) == [0, 1]
    assert both(lambda p, F, df: F.jaccard_similarity(p.col("la"), p.col("lb")), data) == [
        0.5, 0.0]
    np.testing.assert_allclose(
        both(lambda p, F, df: F.pearson_correlation(emb(p, "a"), emb(p, "b")), data),
        [1.0, 0.0], atol=1e-12)


def test_misc():
    for pkg, F in PAIRS:
        u = pkg.from_pydict(_data()).select(F.uuid(pkg.col("i")).alias("o")).to_pydict()["o"]
        assert len(set(u)) == 3 and all(len(x) == 36 for x in u)
    r = both(lambda p, F, df: F.random_int(p.col("i"), 0, 10, seed=42))
    assert all(0 <= v < 10 for v in r)
    d = {"a": [1, None, 2], "b": [1, None, 3]}
    assert both(lambda p, F, df: F.eq_null_safe(p.col("a"), p.col("b")), d) == [True, True, False]
    assert both(lambda p, F, df: p.col("a").eq_null_safe(p.col("b")), d) == [True, True, False]
    assert len(set(both(lambda p, F, df: F.simhash(p.col("s"))))) == 3
    assert both(lambda p, F, df: p.col("s").str.zfill(12))[2] == "0000000a-b-c"
    assert both(lambda p, F, df: F.is_in(p.col("i"), [5, 12])) == [False, True, True]
    assert both(lambda p, F, df: F.try_cast(p.col("s"), p.DataType.int64())) == [None] * 3
    assert both(lambda p, F, df: F.fill_null(p.col("a"), 0), d) == [1, 0, 2]


def test_file_helpers(tmp_path):
    p = tmp_path / "x.json"
    p.write_text("{}")
    d = {"p": [str(p), str(tmp_path / "missing.png")]}
    assert both(lambda p_, F, df: F.file_exists(p_.col("p")), d) == [True, False]
    assert both(lambda p_, F, df: F.file_size(p_.col("p")), d) == [2, None]
    assert both(lambda p_, F, df: F.guess_mime_type(p_.col("p")), d) == [
        "application/json", "image/png"]


def test_audio_wav_roundtrip(tmp_path):
    import wave

    path = str(tmp_path / "t.wav")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(8000)
        w.writeframes((np.sin(np.linspace(0, 100, 800)) * 10000).astype(np.int16).tobytes())
    d = {"p": [path]}
    meta = both(lambda p_, F, df: F.audio_metadata(p_.col("p")), d)[0]
    assert meta["sample_rate"] == 8000 and meta["channels"] == 1 and meta["frames"] == 800
    assert len(both(lambda p_, F, df: F.resample(p_.col("p"), target_rate=4000), d)[0]) == 400


@pytest.mark.parametrize("flat, ns", [
    ("upper", lambda e: e.str.upper()), ("contains", lambda e: e.str.contains("o")),
    ("regexp_replace", lambda e: e.str.regexp_replace("o+", "0")),
    ("year", lambda e: e.dt.year()), ("date_trunc", lambda e: e.dt.truncate("1 day")),
    ("parse_url", lambda e: e.url.parse()), ("partition_days", lambda e: e.partitioning.days()),
    ("try_compress", lambda e: e.binary.try_compress("zlib")),
], ids=lambda v: v if isinstance(v, str) else "")
def test_flat_aliases_build_the_namespace_expression(flat, ns):
    """The reference's flat aliases (``Expression.upper`` for
    ``.str.upper``...) build the same expression as the namespace method."""
    e = daft_tpu_torch.col("a")
    args = {"contains": ("o",), "regexp_replace": ("o+", "0"), "date_trunc": ("1 day",),
            "try_compress": ("zlib",)}.get(flat, ())
    assert repr(getattr(e, flat)(*args)) == repr(ns(e))
    je = daft_tpu.col("a")
    assert repr(getattr(je, flat)(*args)) == repr(ns(je))


def test_every_public_function_of_the_reference_has_a_namesake():
    """Every public function the JAX package's library exports has one of
    the same name in the port's, working or raising with its ROADMAP item."""
    names = [n for n, v in vars(JF).items() if not n.startswith("_") and callable(v)
             and getattr(v, "__module__", "").startswith("daft_tpu.functions")
             and not inspect.isclass(v)]
    assert len(names) > 250
    missing = [n for n in names if not callable(getattr(PF, n, None))]
    assert not missing


#: ``None``: ROADMAP A.3.5 brought it, and it builds the JAX package's expression
#: (the media functions a row-wise UDF over the column, ``udf[name](...)``).
@pytest.mark.parametrize("call, item", [
    (lambda F, c: F.row_number(), None),
    (lambda F, c: F.rank(), None),
    (lambda F, c: F.lag(c("i")), None),
    (lambda F, c: F.over(c("i").sum(), F.Window().partition_by("g") if hasattr(F, "Window")
                         else None), None),
    (lambda F, c: F.median(c("i")), None),
    (lambda F, c: F.string_agg(c("s")), None),
    (lambda F, c: F.approx_percentiles(c("i"), 0.5), None),
    (lambda F, c: F.video_frames(c("s")), None),
    (lambda F, c: F.run_process(c("s")), None),
    (lambda F, c: F.hdf5_keys(c("s")), None),
], ids=["row_number", "rank", "lag", "over", "median", "string_agg", "approx_percentiles",
        "video_frames", "run_process", "hdf5_keys"])
def test_left_out_functions_raise_when_called(call, item):
    if item is not None:
        with pytest.raises(DaftNotImplementedError, match=item):
            call(PF, daft_tpu_torch.col)
        return
    window = {JF: daft_tpu.Window(), PF: daft_tpu_torch.Window()}

    class _F:  # the library, with its package's Window for ``over``
        def __init__(self, F):
            self._F, self.Window = F, lambda: window[F]

        def __getattr__(self, n):
            return getattr(self._F, n)

    jax_expr = call(_F(JF), daft_tpu.col)._expr
    port_expr = call(_F(PF), daft_tpu_torch.col)._expr
    assert type(port_expr).__name__ == type(jax_expr).__name__
    assert repr(port_expr) == repr(jax_expr)


#: Each case's frame (the same data for both packages) and, where the JAX
#: package's own function cannot build the call (ROADMAP C.35), its builder.
def _wav() -> bytes:
    import io
    import wave

    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(11025)
        w.writeframes(np.random.default_rng(3).integers(-999, 999, 300, np.int16).tobytes())
    return buf.getvalue()


_PLAN_DATA = {"l": [[1, 2], None, [3]], "s": ["a", "b", None],
              "st": [{"x": 1}, None, {"x": 3}], "w": [_wav(), None, _wav()[:44]]}


@pytest.mark.parametrize("call, item", [
    (lambda F, c: F.list_sum(c("l")), None),
    (lambda F, c: (c("st").struct.get("x") if F is JF else F.struct_get(c("st"), "x")), None),
    (lambda F, c: F.map_keys(c("m")), None),
    (lambda F, c: F.download(c("f")), "files"),
    (lambda F, c: F.upload(c("b"), "up"), "files"),
    (lambda F, c: F.audio_metadata(c("w")), None),
    (lambda F, c: F.monotonically_increasing_id(), None),
], ids=["list_sum", "struct_get", "map_keys", "download", "upload", "audio_metadata",
        "monotonically_increasing_id"])
def test_left_out_functions_raise_when_a_plan_resolves_them(call, item, tmp_path, monkeypatch):
    """Every function here runs through a plan as in the JAX package; none is
    left out since ROADMAP A.8.2 brought ``download`` / ``upload``. Those
    read and write files: ``upload``'s names are random, so the bytes read
    back are compared. The JAX package's ``upload`` passes its location as a
    column that the kernel ignores and writes under the working directory
    (ROADMAP C.53), so both run in ``tmp_path``; the port's writes under its
    location."""
    import pyarrow as pa

    maps = pa.array([[("k", 1), ("j", 2)], None, []], pa.map_(pa.string(), pa.int64()))
    if item == "files":  # they read and write files: under tmp_path
        monkeypatch.chdir(tmp_path)
        (tmp_path / "a.bin").write_bytes(b"payload")
        data = {"f": ["a.bin", None], "b": [b"xyz", None]}
        outs = []
        for pkg, F in PAIRS:
            got = pkg.from_pydict(data).select(call(F, pkg.col).alias("o")).to_pydict()["o"]
            if isinstance(got[0], str):  # upload's random names: the bytes read back
                got = [None if p is None else open(p, "rb").read() for p in got]
            outs.append(got)
        assert outs[0] == outs[1] and outs[1] in ([b"payload", None], [b"xyz", None])
        if outs[1][0] == b"xyz":  # the port's object lies under its location
            assert len(os.listdir(tmp_path / "up")) == 1
        return
    outs = []
    for pkg, F in PAIRS:
        df = pkg.from_pydict({**_PLAN_DATA, "m": maps})
        outs.append(df.select(pkg.col("s"), call(F, pkg.col).alias("o")).to_pydict())
    assert outs[0] == outs[1]


def test_struct_get_builds_its_expression_where_the_jax_package_raises():
    """ROADMAP C.35: the JAX package's ``functions.struct_get`` passes
    ``name=`` to its ``_fn(name, ...)`` and raises TypeError; the port's
    builds the call (``test_left_out_functions_raise_when_a_plan_resolves_them``
    runs it)."""
    with pytest.raises(TypeError, match="multiple values for argument 'name'"):
        JF.struct_get(daft_tpu.col("st"), "x")
    e = PF.struct_get(daft_tpu_torch.col("st"), "x")
    assert e._expr.fn_name == "struct_get" and e._expr.kwargs == {"name": "x"}
