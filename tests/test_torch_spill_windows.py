"""The grace window and the grace hash repartition in the port (the
executor's ``_run_Window`` / ``_run_Repartition`` under a memory limit), on
the CPU, held against the JAX package under the same limit.

Mirrors ``tests/test_spill.py``'s window and repartition cases: each query
runs in the port without a limit and under ``LIMIT`` (a sink budget of 64 KiB
against about 1 MB of data) and in the JAX package under ``LIMIT``. The
limited rows must equal the unlimited ones and the JAX package's (ranks,
keys and row placement exactly; a whole-partition float sum within
``WHOLE_PARTITION_RTOL``, which is 0, as ``tests/test_torch_window.py``
states), with the
JAX package's spill events, files and bytes, and every limited run leaves the
byte ledger at zero, every permit back and no spill directory.
"""

import os

import numpy as np
import pytest

import daft_tpu
import daft_tpu_torch
from daft_tpu.execution.resource_manager import memory_limit as jlimit
from daft_tpu.execution.spill import spill_metrics as jspill
from daft_tpu_torch.execution.memledger import get_ledger
from daft_tpu_torch.execution.resource_manager import memory_limit
from daft_tpu_torch.execution.spill import spill_metrics
from torch_isolation import admission_windows_reset  # noqa: F401

pytestmark = [pytest.mark.filterwarnings("ignore:Specifying null_placement:FutureWarning"),
              pytest.mark.usefixtures("admission_windows_reset")]

N = 50_000
LIMIT = 256 * 1024
SPILL_KEYS = ("spills", "files", "bytes_spilled")
WHOLE_PARTITION_RTOL = 0.0


@pytest.fixture(autouse=True)
def _configs():
    with daft_tpu.execution_config_ctx(result_cache_enabled=False), \
            daft_tpu_torch.execution_config_ctx(device="cpu", result_cache_enabled=False):
        yield


def run_both(query, limit=LIMIT):
    """``query(pkg)`` (a function of the package returning rows) in the port
    without a limit and under ``limit``, and in the JAX package under
    ``limit``: (unlimited, limited, jax limited, the port's spill counters,
    the JAX package's)."""
    expected = query(daft_tpu_torch)
    spill_metrics.reset()
    with memory_limit(limit) as mm:
        actual = query(daft_tpu_torch)
        assert mm.available_permits() == limit
    sp = spill_metrics.snapshot()
    assert get_ledger().total_held() == 0
    assert not [d for d in spill_metrics.dirs() if os.path.exists(d)]
    jspill.reset()
    with jlimit(limit):
        jax = query(daft_tpu)
    return expected, actual, jax, sp, jspill.snapshot()


def _window_data():
    rng = np.random.default_rng(23)
    n = 60_000
    return {"k": rng.integers(0, 3_000, n).tolist(), "v": rng.standard_normal(n).tolist()}


def test_grace_window_spills():
    """Partitioned window functions bucket by their partition keys under a
    memory limit and equal the in-memory answer."""
    data = _window_data()

    def q(p):
        F = __import__(f"{p.__name__}.functions", fromlist=["x"])
        w = p.Window().partition_by("k").order_by("v")
        return (p.from_pydict(data).with_column("rn", F.rank().over(w))
                .with_column("s", p.col("v").sum().over(p.Window().partition_by("k")))
                .sort(["k", "v"]).to_pydict())

    expected, actual, jax, sp, jsp = run_both(q)
    assert actual["k"] == expected["k"] == jax["k"]
    assert actual["v"] == expected["v"] == jax["v"]
    assert actual["rn"] == expected["rn"] == jax["rn"]
    assert actual["s"] == expected["s"]  # bucketed rows keep their order
    np.testing.assert_allclose(actual["s"], jax["s"], rtol=WHOLE_PARTITION_RTOL)
    assert sp["spills"] > 0 and {k: sp[k] for k in SPILL_KEYS} == jsp


def test_unpartitioned_window_under_a_limit_stays_in_memory():
    """A window without partition keys cannot bucket: it collects, as in the
    JAX package, and spills nothing."""
    data = _window_data()

    def q(p):
        F = __import__(f"{p.__name__}.functions", fromlist=["x"])
        return p.from_pydict(data).with_column("rn", F.row_number().over(
            p.Window().order_by("v"))).to_pydict()

    expected, actual, jax, sp, jsp = run_both(q)
    assert actual == expected == jax
    assert sp["spills"] == 0 == jsp["spills"]


def test_grace_hash_repartition_spills():
    """``repartition`` under a memory limit streams into disk buckets and
    yields exactly n partitions with the in-memory row placement."""
    rng = np.random.default_rng(29)
    data = {"k": rng.integers(0, 4_000, N).tolist(), "v": list(range(N))}

    def q(p):
        return [sorted(mp.to_pydict()["v"])
                for mp in p.from_pydict(data).repartition(7, "k").iter_partitions()]

    expected, actual, jax, sp, jsp = run_both(q)
    assert len(actual) == 7 and actual == expected == jax
    assert sp["spills"] > 0 and {k: sp[k] for k in SPILL_KEYS} == jsp


def test_small_repartition_under_limit_stays_in_memory():
    """A repartition far below the budget does not pay a disk round trip."""
    def q(p):
        return [mp.to_pydict() for mp in p.from_pydict(
            {"k": [1, 2, 3, 4], "v": [10, 20, 30, 40]}).repartition(3, "k").iter_partitions()]

    expected, actual, jax, sp, jsp = run_both(q, limit=64 * 1024 * 1024)
    assert actual == expected == jax and sum(len(p["v"]) for p in actual) == 4
    assert sp["spills"] == 0 == jsp["spills"]


@pytest.mark.parametrize("query", ["window", "repartition"])
def test_a_cancelled_query_leaves_nothing_held(query):
    """A window or repartition under a limit whose deadline has passed raises
    at its first morsel and leaves the ledger, the permits and the spill
    directory at zero, as every query of the port does."""
    from daft_tpu_torch.errors import DaftTimeoutError

    data = _window_data()
    df = daft_tpu_torch.from_pydict(data)
    if query == "window":
        df = df.with_column("s", daft_tpu_torch.col("v").sum().over(
            daft_tpu_torch.Window().partition_by("k")))
    else:
        df = df.repartition(7, "k")
    with memory_limit(LIMIT) as mm:
        with pytest.raises(DaftTimeoutError):
            df.collect(timeout=1e-9)
        assert mm.available_permits() == LIMIT
    assert get_ledger().total_held() == 0
    assert not [d for d in spill_metrics.dirs() if os.path.exists(d)]


def test_list_and_sketch_aggregations_through_the_grace_aggregation():
    """The aggregations with list or sketch partials under a limit: the
    grouped state spills by key, each bucket merges its list partials and
    sketches, and the rows equal the unlimited ones and the JAX package's
    under the same limit, with its spill events, files and bytes."""
    rng = np.random.default_rng(41)
    data = {"k": rng.integers(0, 4_000, N).tolist(),
            "w": rng.integers(0, 50, N).tolist(),
            "v": rng.standard_normal(N).tolist()}

    def q(p):
        c = p.col
        return (p.from_pydict(data).groupby("k")
                .agg(c("w").count_distinct().alias("cd"), c("w").agg_list().alias("ws"),
                     c("v").median().alias("med"), c("v").approx_percentiles(0.9).alias("p90"),
                     c("w").approx_count_distinct().alias("acd"))
                .sort("k").to_pydict())

    expected, actual, jax, sp, jsp = run_both(q)
    assert actual == expected == jax
    assert sp["spills"] > 0 and {k: sp[k] for k in SPILL_KEYS} == jsp
