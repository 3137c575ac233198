"""Property-based tests of the port against the JAX package, on the CPU.

Mirrors ``tests/test_property_based.py``'s ten properties with hypothesis,
under the JAX file's ``_SETTINGS``: every generated example runs through both
packages (``device="cpu"`` for the port) and the port must give the JAX
package's rows and hold the property the JAX test asserts. The out-of-core
properties run each package under its own ``memory_limit`` at the same
limit. The JAX package runs as its own test runs it, with its result cache
on. A grouped aggregation and the sort above it each reserve a whole tiny
limit, so the second waits for its permits and then goes on at best effort,
in both packages; the port waits ``PERMIT_WAIT_S`` = 0.05 s here in place of
5 s, so thirty examples take seconds, on the same path.
"""

import tempfile
import warnings

import hypothesis.strategies as st
import pytest
from hypothesis import HealthCheck, given, settings

import daft_tpu
import daft_tpu_torch
from daft_tpu.execution.resource_manager import memory_limit as jax_memory_limit
from daft_tpu_torch.execution import spill
from daft_tpu_torch.execution.resource_manager import memory_limit as port_memory_limit
from torch_isolation import admission_windows_reset  # noqa: F401

pytestmark = pytest.mark.usefixtures("admission_windows_reset")

PKGS = (daft_tpu, daft_tpu_torch)
LIMITS = {daft_tpu: jax_memory_limit, daft_tpu_torch: port_memory_limit}

_SETTINGS = dict(max_examples=30, deadline=None,
                 suppress_health_check=[HealthCheck.too_slow])

homogeneous_column = st.one_of(
    st.lists(st.one_of(st.integers(min_value=-(2**31), max_value=2**31), st.none()),
             min_size=1, max_size=100),
    st.lists(st.one_of(st.text(max_size=12), st.none()), min_size=1, max_size=100),
    st.lists(st.one_of(st.floats(allow_nan=False, allow_infinity=False,
                                 width=32), st.none()), min_size=1, max_size=100),
)


@pytest.fixture(autouse=True)
def _cpu():
    wait = spill.PERMIT_WAIT_S
    spill.PERMIT_WAIT_S = 0.05
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", FutureWarning)
            with daft_tpu_torch.execution_config_ctx(device="cpu"):
                yield
    finally:
        spill.PERMIT_WAIT_S = wait


def _both(build):
    """``build(pkg)`` in the port, held equal to the JAX package's."""
    jax, port = (build(pkg) for pkg in PKGS)
    assert port == jax
    return port


def _nulls_last(v):
    return (v is None, v)


@given(values=st.lists(st.one_of(st.integers(-1000, 1000), st.none()),
                       min_size=0, max_size=200))
@settings(**_SETTINGS)
def test_sort_is_sorted(values):
    if not values:
        return
    out = _both(lambda p: p.from_pydict({"x": values}).sort("x").to_pydict()["x"])
    non_null = [v for v in out if v is not None]
    assert non_null == sorted(v for v in values if v is not None)
    assert out[len(non_null):] == [None] * (len(out) - len(non_null))


@given(values=st.lists(st.integers(-50, 50), min_size=1, max_size=100),
       pivot=st.integers(-50, 50))
@settings(**_SETTINGS)
def test_filter_partition(values, pivot):
    def run(p):
        df = p.from_pydict({"x": values})
        return (df.where(p.col("x") > pivot).count_rows(),
                df.where(~(p.col("x") > pivot)).count_rows())

    hi, lo = _both(run)
    assert hi + lo == len(values)


@given(values=st.lists(st.text(max_size=8), min_size=1, max_size=80))
@settings(**_SETTINGS)
def test_groupby_count_totals(values):
    out = _both(lambda p: p.from_pydict({"k": values}).groupby("k").count().to_pydict())
    assert sum(out["count"]) == len(values)
    assert len(out["k"]) == len(set(values))


@given(values=st.lists(st.integers(-10**6, 10**6), min_size=1, max_size=120),
       parts=st.integers(1, 5))
@settings(**_SETTINGS)
def test_distributed_sum_matches(values, parts):
    """The aggregation over partitions equals the direct sum."""
    out = _both(lambda p: p.from_pydict({"x": values}).into_partitions(parts)
                .agg(p.col("x").sum().alias("s")).to_pydict()["s"][0])
    assert out == sum(values)


@given(values=homogeneous_column)
@settings(**_SETTINGS)
def test_parquet_roundtrip_any(values):
    def run(p):
        with tempfile.TemporaryDirectory() as d:
            df = p.from_pydict({"v": values})
            if df.schema["v"].dtype.is_null():
                return None  # all-null columns have no parquet type
            df.write_parquet(d)
            return p.read_parquet(d).to_pydict()["v"]

    back = _both(run)
    if back is None:
        return
    first = next((v for v in values if v is not None), None)
    if isinstance(first, float):
        assert back == pytest.approx(values)
    else:
        assert back == values


@given(keys=st.lists(st.one_of(st.integers(-100, 100), st.none()),
                     min_size=1, max_size=400),
       limit_kb=st.integers(1, 64))
@settings(**_SETTINGS)
def test_out_of_core_agg_equals_in_memory(keys, limit_kb):
    """The grace aggregation under any limit equals the unlimited run, null
    group keys and limits far below one morsel included."""
    def run(p):
        df = p.from_pydict({"k": keys, "v": list(range(len(keys)))})

        def q():
            return (df.groupby("k").agg(p.col("v").sum().alias("s"),
                                        p.col("v").count().alias("c")).sort("k").to_pydict())

        expected = q()
        with LIMITS[p](limit_kb * 1024):
            assert q() == expected
        return expected

    _both(run)


@given(vals=st.lists(st.integers(-1000, 1000), min_size=1, max_size=500),
       limit_kb=st.integers(1, 32))
@settings(**_SETTINGS)
def test_out_of_core_sort_equals_in_memory(vals, limit_kb):
    def run(p):
        df = p.from_pydict({"x": vals})
        expected = df.sort("x").to_pydict()
        with LIMITS[p](limit_kb * 1024):
            assert df.sort("x").to_pydict() == expected
        return expected

    _both(run)


@given(lk=st.lists(st.one_of(st.integers(0, 40), st.none()), min_size=1, max_size=300),
       rk=st.lists(st.integers(0, 60), min_size=1, max_size=300),
       how=st.sampled_from(["inner", "left", "outer", "semi", "anti"]),
       limit_kb=st.integers(1, 16))
@settings(**_SETTINGS)
def test_out_of_core_join_equals_in_memory(lk, rk, how, limit_kb):
    """Grace hash joins under any limit, every join type, null keys present,
    match the in-memory join."""
    def run(p):
        left = p.from_pydict({"k": lk, "lv": list(range(len(lk)))})
        right = p.from_pydict({"k": rk, "rv": list(range(len(rk)))})

        def q():
            out = left.join(right, on="k", how=how)
            cols = [c for c in ("k", "lv", "rv") if c in out.column_names]
            return sorted(zip(*[out.to_pydict()[c] for c in cols]),
                          key=lambda r: tuple(_nulls_last(v) for v in r))

        expected = q()
        with LIMITS[p](limit_kb * 1024):
            assert q() == expected
        return expected

    _both(run)


@given(vals=st.lists(st.one_of(st.integers(0, 30), st.none()), min_size=1, max_size=300),
       limit_kb=st.integers(1, 16))
@settings(**_SETTINGS)
def test_out_of_core_distinct_equals_in_memory(vals, limit_kb):
    def run(p):
        df = p.from_pydict({"x": vals})

        def q():
            return sorted(df.distinct().to_pydict()["x"], key=_nulls_last)

        expected = q()
        with LIMITS[p](limit_kb * 1024):
            assert q() == expected
        return expected

    _both(run)


@given(keys=st.lists(st.integers(0, 20), min_size=1, max_size=300),
       limit_kb=st.integers(1, 16))
@settings(**_SETTINGS)
def test_out_of_core_window_equals_in_memory(keys, limit_kb):
    """Partitioned window sums under any limit match the in-memory run (row
    order is unspecified: compared as sorted (k, v, s) triples)."""
    def run(p):
        df = p.from_pydict({"k": keys, "v": list(range(len(keys)))})
        w = p.Window().partition_by("k")

        def q():
            out = df.with_column("s", p.col("v").sum().over(w)).to_pydict()
            return sorted(zip(out["k"], out["v"], out["s"]))

        expected = q()
        with LIMITS[p](limit_kb * 1024):
            assert q() == expected
        return expected

    _both(run)
