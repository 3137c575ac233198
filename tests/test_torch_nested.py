"""The port's nested kernels (``kernels/list_ops.py``,
``kernels/struct_map_ops.py``), the sketches (``kernels/sketches.py``) and
the aggregations with list or sketch partials against the JAX package, on
the CPU.

Every kernel that the JAX package's ``list_ops`` and ``struct_map_ops``
register has a case here (a coverage test holds the two modules to the
cases): the same seeded columns (null lists, empty lists, null elements,
strings, booleans, nested lists, structs, maps) go through the ``.list`` /
``.struct`` / ``.map`` namespaces and ``daft_tpu_torch.functions`` in both
packages (``device="cpu"`` for the port), and the results must be equal,
floats bit for bit. The HyperLogLog registers of the port's numpy path must
equal the JAX package's (its native path, where built, is bit-equal to its
numpy path) and the DDSketch's buckets and quantiles must be the JAX
package's. Then the aggregations ``median``, ``string_agg``, ``list``,
``concat``, ``count_distinct``, ``approx_count_distinct``,
``approx_percentile``, ``skew`` and ``agg_set``, global and grouped (at 1 and
4 workers, and with the high-cardinality route forced): equal rows, floats
bit for bit but ``skew`` within ``SKEW_RTOL`` (its moments are sums of
partials, whose association follows the chunks).
"""

import warnings

import numpy as np
import pyarrow as pa
import pytest

import daft_tpu
import daft_tpu_torch

PKGS = (daft_tpu, daft_tpu_torch)
N = 60
SKEW_RTOL = 1e-12


@pytest.fixture(autouse=True)
def _cpu():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        with daft_tpu.execution_config_ctx(result_cache_enabled=False), \
                daft_tpu_torch.execution_config_ctx(device="cpu", result_cache_enabled=False):
            yield


def _F(pkg):
    return __import__(f"{pkg.__name__}.functions", fromlist=["x"])


def _columns(seed: int = 3) -> dict:
    rng = np.random.default_rng(seed)

    def ilist(i):
        if i % 9 == 4:
            return None
        return [None if (i + j) % 7 == 3 else int(x)
                for j, x in enumerate(rng.integers(-20, 20, i % 6))]

    maps = pa.array([None if i % 8 == 1 else [(f"k{j}", int(v)) for j, v in
                                               enumerate(rng.integers(0, 99, i % 4))]
                     for i in range(N)], pa.map_(pa.string(), pa.int64()))
    return {
        "li": [ilist(i) for i in range(N)],
        "lf": [None if i % 10 == 6 else [float(x) for x in rng.standard_normal(i % 5)]
               for i in range(N)],
        "ls": [None if i % 8 == 2 else [None if j == 1 else str(x) for j, x in enumerate(
            rng.choice(["a", "bb", "ü", ""], i % 4))] for i in range(N)],
        "lb": [None if i % 7 == 0 else [bool(x) for x in rng.integers(0, 2, i % 3)]
               for i in range(N)],
        "ll": [None if i % 11 == 5 else [[int(x)] * (j % 3) for j, x in
                                        enumerate(rng.integers(0, 5, i % 3))] for i in range(N)],
        "st": [None if i % 6 == 1 else {"x": int(x), "y": str(x)} for i, x in
               enumerate(rng.integers(0, 50, N))],
        "m": maps,
        "i": [None if i % 5 == 2 else int(x) for i, x in enumerate(rng.integers(-3, 9, N))],
        "n": [None if i % 7 == 3 else int(x) for i, x in enumerate(rng.integers(0, 6, N))],
        "s": [None if i % 4 == 1 else str(x) for i, x in enumerate(rng.choice(["p", "q"], N))],
    }


CASES = {
    "list_length": [lambda p, c, F: c("li").list.length()],
    "list_count": [lambda p, c, F: c("li").list.count(),
                   lambda p, c, F: c("li").list.count("all")],
    "list_get": [lambda p, c, F: c("li").list.get(1),
                 lambda p, c, F: c("li").list.get(-1, default=99)],
    "list_slice": [lambda p, c, F: c("li").list.slice(1, 3),
                   lambda p, c, F: c("ls").list.slice(1)],
    "list_chunk": [lambda p, c, F: c("li").list.chunk(2)],
    "list_join": [lambda p, c, F: c("ls").list.join("-")],
    "list_sum": [lambda p, c, F: c("li").list.sum(), lambda p, c, F: c("lf").list.sum()],
    "list_mean": [lambda p, c, F: c("li").list.mean(), lambda p, c, F: c("lf").list.mean()],
    "list_min": [lambda p, c, F: c("li").list.min(), lambda p, c, F: c("ls").list.min()],
    "list_max": [lambda p, c, F: c("lf").list.max(), lambda p, c, F: c("ls").list.max()],
    "list_sort": [lambda p, c, F: c("li").list.sort(),
                  lambda p, c, F: c("ls").list.sort(desc=True)],
    "list_distinct": [lambda p, c, F: c("li").list.distinct()],
    "list_contains": [lambda p, c, F: c("li").list.contains(3),
                      lambda p, c, F: c("ls").list.contains("a")],
    "list_value_counts": [lambda p, c, F: c("ls").list.value_counts()],
    "list_flatten": [lambda p, c, F: c("ll").list.flatten()],
    "list_bool_and": [lambda p, c, F: c("lb").list.bool_and()],
    "list_bool_or": [lambda p, c, F: c("lb").list.bool_or()],
    "list_append": [lambda p, c, F: c("li").list.append(c("i"))],
    "list_map": [lambda p, c, F: c("li").list.map(F.element() * 2 + 1)],
    "list_filter": [lambda p, c, F: c("li").list.filter(F.element() > 0)],
    "list_compact": [lambda p, c, F: _call(p, "list_compact", c("li"))],
    "list_seq": [lambda p, c, F: F.seq(c("n"))],
    "list_pack": [lambda p, c, F: F.to_list(c("i"), c("n"))],
    "struct_get": [lambda p, c, F: c("st").struct.get("x"), lambda p, c, F: c("st")["y"]],
    "map_get": [lambda p, c, F: c("m").map.get("k1")],
    "map_keys": [lambda p, c, F: F.map_keys(c("m"))],
    "map_values": [lambda p, c, F: F.map_values(c("m"))],
    "pack_struct": [lambda p, c, F: F.to_struct(c("i"), c("s")),
                    lambda p, c, F: F.to_struct(a=c("i"), b=c("li"))],
    "list_count_distinct": [lambda p, c, F: c("ls").list.count_distinct()],
    "list_quantile": [lambda p, c, F: c("lf").list.quantile(0.25)],
}
#: The select-only markers, which expand in a projection (checked below).
MARKERS = {"unnest", "explode"}
_PARAMS = [pytest.param(name, build, id=f"{name}-{i}") for name, builds in CASES.items()
           for i, build in enumerate(builds)]


def _call(pkg, name, *args, **kwargs):
    call = __import__(f"{pkg.__name__}.expressions.expr", fromlist=["x"]).FunctionCall
    return pkg.Expression(call(name, [a._expr for a in args], kwargs))


def _rows(pkg, select, cols=None) -> dict:
    df = pkg.from_pydict(cols if cols is not None else _columns())
    return df.select(*select(pkg, pkg.col, _F(pkg))).to_pydict()


def _assert_same(a, b, path=""):
    if isinstance(a, float) and isinstance(b, float):
        assert (a != a and b != b) or a == b, (path, a, b)
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), (path, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), (path, a, b)
        for k in a:
            _assert_same(a[k], b[k], f"{path}.{k}")
    else:
        assert a == b, (path, a, b)


@pytest.mark.parametrize("name, build", _PARAMS)
def test_nested_kernel_parity(name, build):
    jax, port = (_rows(pkg, lambda p, c, F: [build(p, c, F).alias("o")]) for pkg in PKGS)
    _assert_same(jax, port)
    assert any(v is not None for v in port["o"]), "every row is null: the case tests nothing"


def test_every_nested_kernel_has_a_case():
    from daft_tpu.kernels import registry as jreg
    from daft_tpu_torch.kernels import registry as preg

    modules = {"daft_tpu.kernels.list_ops", "daft_tpu.kernels.struct_map_ops"}
    names = {n for n, k in jreg.all_kernels().items() if k.fn.__module__ in modules}
    assert len(names) == 30
    assert names - MARKERS <= set(CASES)
    assert names <= set(preg.all_kernels()) and not names & set(preg.LEFT_OUT)


def test_unnest_and_explode_markers_expand_in_a_projection():
    """``unnest`` expands a struct into its fields and ``explode`` appends an
    Explode node, in both packages alike; elsewhere the markers raise."""
    def run(p, c, F):
        return [c("i"), F.unnest(c("st"))]

    _assert_same(_rows(daft_tpu, run), _rows(daft_tpu_torch, run))

    def exploded(p, c, F):
        return [c("i"), F.explode(c("li")).alias("e")]

    _assert_same(_rows(daft_tpu, exploded), _rows(daft_tpu_torch, exploded))
    with pytest.raises(Exception, match="only valid as a top-level"):
        daft_tpu_torch.from_pydict(_columns()).where(
            daft_tpu_torch.functions.explode(daft_tpu_torch.col("li")).list.length() > 0)


# -- the sketches --------------------------------------------------------------
@pytest.mark.parametrize("n", [0, 7, 5000, 200_000])
def test_hll_registers_and_estimate_equal_the_jax_package(n):
    from daft_tpu.kernels import sketches as js
    from daft_tpu_torch.kernels import sketches as ps

    rng = np.random.default_rng(n)
    vals = rng.integers(0, max(n // 3, 1), n)
    jreg = js.hll_sketch(daft_tpu.Series.from_numpy(vals))
    preg_ = ps.hll_sketch(daft_tpu_torch.Series.from_numpy(vals))
    assert np.array_equal(jreg, preg_)
    assert js.hll_estimate(jreg) == ps.hll_estimate(preg_)
    if n:
        true = len(np.unique(vals))
        assert abs(ps.hll_estimate(preg_) - true) <= 0.05 * true + 2


def test_ddsketch_equals_the_jax_package():
    from daft_tpu.kernels.sketches import DDSketch as JD
    from daft_tpu_torch.kernels.sketches import DDSketch as PD

    rng = np.random.default_rng(9)
    a = np.concatenate([rng.lognormal(0, 2, 4000), -rng.lognormal(1, 1, 500), np.zeros(30),
                        [np.nan, np.inf]])
    b = rng.standard_normal(3000) * 50
    js, ps = JD().add_array(a).merge(JD().add_array(b)), PD().add_array(a).merge(PD().add_array(b))
    assert (js.pos, js.neg, js.zeros, js.count) == (ps.pos, ps.neg, ps.zeros, ps.count)
    for q in (0.0, 0.01, 0.25, 0.5, 0.9, 0.999, 1.0):
        assert js.quantile(q) == ps.quantile(q)
    back = PD.from_bytes(ps.to_bytes())
    assert back.pos == ps.pos and back.quantile(0.5) == ps.quantile(0.5)
    truth = np.quantile(np.concatenate([a[np.isfinite(a)], b]), 0.9)
    assert abs(ps.quantile(0.9) - truth) <= 0.011 * abs(truth)


# -- the aggregations ----------------------------------------------------------
def _agg_table(seed: int, n: int = 3000) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "k": [None if i % 97 == 3 else int(x) for i, x in enumerate(rng.integers(0, 40, n))],
        "v": [None if i % 13 == 5 else float(x) for i, x in enumerate(rng.standard_normal(n))],
        "w": [None if i % 11 == 2 else int(x) for i, x in enumerate(rng.integers(0, 300, n))],
        "t": [None if i % 7 == 1 else str(x) for i, x in enumerate(rng.choice(
            ["ab", "c", "", "dé", "xyz"], n))],
        "l": [None if i % 17 == 0 else rng.integers(0, 9, i % 4).tolist() for i in range(n)],
    }


def _aggs(p):
    c = p.col
    return [c("v").median().alias("median"), c("t").string_agg("|").alias("string_agg"),
            c("w").agg_list().alias("list"), c("l").agg_concat().alias("concat"),
            c("w").count_distinct().alias("count_distinct"),
            c("t").count_distinct().alias("count_distinct_str"),
            c("w").approx_count_distinct().alias("approx_count_distinct"),
            c("v").approx_percentiles(0.5).alias("p50"),
            c("w").approx_percentiles([0.1, 0.9]).alias("p10_p90"),
            c("v").skew().alias("skew"), c("w").agg_set().alias("agg_set")]


def _assert_aggs(jax: dict, port: dict):
    assert list(port) == list(jax)
    for name in jax:
        if name == "skew":
            for x, y in zip(jax[name], port[name]):
                assert (x is None and y is None) or (x != x and y != y) or \
                    abs(x - y) <= SKEW_RTOL * abs(x), (name, x, y)
        else:
            _assert_same(jax[name], port[name], name)


@pytest.mark.parametrize("seed", [0, 1])
def test_global_aggregations_equal_the_jax_package(seed):
    data = _agg_table(seed)
    jax, port = (pkg.from_pydict(data).agg(*_aggs(pkg)).to_pydict() for pkg in PKGS)
    _assert_aggs(jax, port)
    assert port["count_distinct"][0] == len({x for x in data["w"] if x is not None})


@pytest.mark.parametrize("threads, high_card", [(1, False), (4, False), (4, True)])
def test_grouped_aggregations_equal_the_jax_package(threads, high_card):
    data = _agg_table(2)
    extra = {"high_cardinality_aggregation_threshold": 0.0} if high_card else {}
    jax = daft_tpu.from_pydict(data).groupby("k").agg(*_aggs(daft_tpu)).sort("k").to_pydict()
    with daft_tpu_torch.execution_config_ctx(num_compute_threads=threads, **extra):
        port = daft_tpu_torch.from_pydict(data).groupby("k").agg(
            *_aggs(daft_tpu_torch)).sort("k").to_pydict()
    _assert_aggs(jax, port)


def test_grouped_list_aggregations_merge_across_chunks_in_row_order():
    """More rows than one aggregation chunk, so the list partials merge by
    ``concat``: each group's list holds its rows in input order (the JAX
    package's), and ``explode`` of it round-trips to the input's multiset."""
    from daft_tpu_torch.execution.executor import Executor

    rng = np.random.default_rng(4)
    n = Executor.AGG_CHUNK_ROWS + 5000
    data = {"k": rng.integers(0, 50, n), "v": rng.integers(0, 1000, n)}
    jax = daft_tpu.from_pydict(data).groupby("k").agg_list("v").sort("k").to_pydict()
    with daft_tpu_torch.execution_config_ctx(num_compute_threads=4):
        df = daft_tpu_torch.from_pydict(data).groupby("k").agg_list("v")
        port = df.sort("k").to_pydict()
        back = df.explode("v").to_pydict()
    assert port == jax
    for k, vals in zip(port["k"], port["v"]):
        assert vals == data["v"][data["k"] == k].tolist()
    assert sorted(zip(back["k"], back["v"])) == sorted(zip(data["k"].tolist(),
                                                           data["v"].tolist()))
