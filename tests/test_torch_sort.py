"""The port's sort, TopN and distinct (daft_tpu_torch: logical Sort / TopN /
Distinct, PushDownLimit, the executor's sinks) against the JAX package's, on
the CPU.

The same numpy-seeded columns go through ``daft_tpu`` and through
``daft_tpu_torch`` with ``device="cpu"``. Sorted and TopN outputs are
compared row for row, exactly (NaN equal to NaN): both packages sort with
Arrow's stable ``sort_indices`` on the host, so no tolerance is needed.
"""

import contextlib
import math
import warnings

import numpy as np
import pyarrow as pa
import pytest

import daft_tpu
import daft_tpu_torch

N = 200

pytestmark = pytest.mark.filterwarnings("ignore:Specifying null_placement:FutureWarning")


@contextlib.contextmanager
def _configs(**both):
    with daft_tpu.execution_config_ctx(result_cache_enabled=False, **both), \
            daft_tpu_torch.execution_config_ctx(device="cpu", result_cache_enabled=False, **both):
        yield


def _data(n: int = N, seed: int = 0) -> dict:
    """Keys of every kind with ties and nulls: int32 (i), float32 with NaN
    (f), string (s), date (d), bool (b); ``row`` numbers the rows, so a
    difference in the order of ties shows."""
    rng = np.random.default_rng(seed)

    def valid(p):
        return rng.random(n) >= p

    f = rng.choice(np.array([-2.5, 0.0, 1.0, 3.75, np.nan], np.float32), n)
    return {
        "i": pa.array(rng.integers(-3, 4, n).astype(np.int32), mask=~valid(0.1)),
        "f": pa.array(f, pa.float32(), mask=~valid(0.1)),
        "s": pa.array(rng.choice(np.array(["", "a", "ab", "b", "zz"]), n), pa.large_string(),
                      mask=~valid(0.1)),
        "d": pa.array(rng.integers(8000, 8010, n).astype(np.int32), mask=~valid(0.1)).cast(
            pa.date32()),
        "b": pa.array(rng.random(n) < 0.5, pa.bool_(), mask=~valid(0.1)),
        "row": np.arange(n, dtype=np.int64),
    }


def _same(a: dict, b: dict) -> None:
    assert list(a) == list(b)
    for name in a:
        assert len(a[name]) == len(b[name]), name
        for i, (x, y) in enumerate(zip(a[name], b[name])):
            nan = isinstance(x, float) and isinstance(y, float) and math.isnan(x) and math.isnan(y)
            assert nan or x == y, (name, i, x, y)


def _both(run) -> dict:
    outs = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        for pkg in (daft_tpu, daft_tpu_torch):
            outs.append(run(pkg, pkg.from_pydict(_data())))
    _same(outs[0], outs[1])
    return outs[1]


@pytest.mark.parametrize("nulls_first", [None, True, False])
@pytest.mark.parametrize("desc", [False, True])
@pytest.mark.parametrize("key", ["i", "f", "s", "d", "b"])
def test_sort_one_key_matches_the_jax_package(key, desc, nulls_first):
    with _configs():
        out = _both(lambda pkg, df: df.sort(key, desc=desc, nulls_first=nulls_first).to_pydict())
    assert sorted(out["row"]) == list(range(N))
    # Nulls go first exactly when asked (by default, when descending).
    first = desc if nulls_first is None else nulls_first
    nulls = [v is None for v in out[key]]
    assert nulls == sorted(nulls, reverse=first)


@pytest.mark.parametrize("nulls_first", [None, [True, False], [False, True]])
@pytest.mark.parametrize("keys,desc", [(["i", "s"], [False, True]), (["b", "f"], [True, False]),
                                       (["d", "i", "b"], [True, True, False])])
def test_sort_several_keys_matches_the_jax_package(keys, desc, nulls_first):
    nf = None if nulls_first is None else (nulls_first + [False])[:len(keys)]
    with _configs():
        _both(lambda pkg, df: df.sort(keys, desc=desc, nulls_first=nf).to_pydict())


def test_sort_is_stable_on_ties():
    """Equal keys keep their input order: ``row`` rises within each key."""
    with _configs():
        out = _both(lambda pkg, df: df.sort("b", desc=True).to_pydict())
    for v in (True, False, None):
        rows = [r for r, b in zip(out["row"], out["b"]) if b is v]
        assert rows == sorted(rows)


def test_sort_by_expression_and_empty_input():
    with _configs():
        _both(lambda pkg, df: df.sort(pkg.col("i") * -2, desc=False).to_pydict())
        _both(lambda pkg, df: df.where(pkg.col("row") < 0).sort("s").to_pydict())


def _plan_nodes(df) -> list:
    return [type(n).__name__ for n in df._builder.optimize().plan.walk()]


@pytest.mark.parametrize("morsel", [None, 16])
@pytest.mark.parametrize("k,offset", [(0, 0), (1, 0), (7, 0), (7, 3), (50, 190), (1000, 0)])
def test_topn_matches_the_jax_package(k, offset, morsel):
    """``sort().limit(k, offset)`` plans as a TopN in both packages and gives
    the sort's rows [offset, offset + k): over one morsel, and over many
    morsels of 16 rows (a filter stage cuts them) with the 4×k trims."""
    cfg = {} if morsel is None else {"default_morsel_size": morsel}

    def run(pkg, df):
        if morsel:
            df = df.where(pkg.col("row") >= 0)
        q = df.sort(["f", "s"], desc=[True, False]).limit(k, offset=offset)
        assert "TopN" in _plan_nodes(q) and "Sort" not in _plan_nodes(q)
        return q.to_pydict()

    with _configs(**cfg):
        out = _both(run)
        full = _both(lambda pkg, df: df.sort(["f", "s"], desc=[True, False]).to_pydict())
    assert out["row"] == full["row"][offset:offset + k]


def test_limits_compose_and_pass_below_a_projection():
    def run(pkg, df):
        q = df.sort("i").select("i", "row").limit(20, offset=2).limit(5, offset=4)
        nodes = _plan_nodes(q)
        assert "TopN" in nodes and "Sort" not in nodes
        return q.to_pydict()

    with _configs():
        _both(run)


@pytest.mark.parametrize("on", [None, ("i",), ("s", "b"), ("f",)])
def test_distinct_matches_the_jax_package(on, morsel=16):
    def run(pkg, df):
        df = df.select("i", "f", "s", "b").where(pkg.col("i") > -10)
        return (df.distinct(*on) if on else df.distinct()).to_pydict()

    with _configs(default_morsel_size=morsel):
        out = _both(run)
    keys = list(zip(*[out[c] for c in (on or ("i", "f", "s", "b"))]))
    # NaN != NaN, so compare the keys by their repr.
    assert len({repr(t) for t in keys}) == len(keys)


def test_unique_and_drop_duplicates_are_distinct():
    df = daft_tpu_torch.from_pydict(_data())
    with _configs():
        want = df.distinct("i").to_pydict()
        _same(df.unique("i").to_pydict(), want)
        _same(df.drop_duplicates("i").to_pydict(), want)
