"""TPC-H q01, q18 and q21 in SQL under memory pressure, in the port and in the
JAX package, on the CPU (the port's twin of
``tests/benchmarks/test_tpch_out_of_core.py``).

The JAX package's dbgen tables (``tests/benchmarks/tpch_dbgen.py`` at SF 0.05,
the reference test's CI scale) are turned into Arrow and loaded into both
packages, and each query (``daft_tpu_torch/tools/tpch_sql.py``) runs under a
memory limit of 1/8 of the tables' in-memory bytes
(``tools/out_of_core.limit_for``). q18 and q21 must spill in both packages;
the port's limited rows must equal its unlimited run (keys and counts
exactly, floats within ``RTOL``: the budget path sums in another order) and
the JAX package's limited run exactly (the same algorithm on the same Arrow
calls), with the same spill events, files and bytes and the same device
routes (``device_eval_counters``' chain and fused rows). After each query,
and after a deadline cuts q21, the ledger holds nothing, every permit is
back and no spill directory remains.

Both packages wait up to 5 s for a permit before a sink goes on at best
effort (their shared subtrees pin the tables under permits), so the JAX
package's limited run goes on a thread beside the port's: the waits overlap.
"""

import math
import threading
import time

import pytest

import daft_tpu
import daft_tpu_torch
from daft_tpu.execution.resource_manager import memory_limit as jlimit
from daft_tpu.execution.spill import spill_metrics as jspill
from daft_tpu.ops import device_eval as jde
from daft_tpu_torch.errors import DaftTimeoutError
from daft_tpu_torch.execution.memledger import get_ledger
from daft_tpu_torch.execution.resource_manager import get_memory_manager
from daft_tpu_torch.tools import out_of_core, tpch_sql

from benchmarks.tpch_dbgen import generate_tpch_dbgen
from torch_isolation import admission_windows_reset  # noqa: F401

pytestmark = [pytest.mark.filterwarnings("ignore:Specifying null_placement:FutureWarning"),
              pytest.mark.usefixtures("admission_windows_reset")]

SF = 0.05
RTOL = 1e-6
QUERIES = list(out_of_core.QUERIES)
SPILL_KEYS = ("spills", "files", "bytes_spilled")


def _frames(pkg, arrow):
    return {k: pkg.from_pydict({c: t.column(c).combine_chunks() for c in t.column_names})
            for k, t in arrow.items()}


def _jax_chain_kinds() -> dict:
    from daft_tpu import metrics

    snap = metrics.get_registry().snapshot()
    return {k: int(v) for k, v in snap.label_totals("daft_compiled_chain_rows_total",
                                                    "kind").items() if v}


def _jax_limited(frames, name, limit, out):
    with daft_tpu.execution_config_ctx(result_cache_enabled=False):
        before = _jax_chain_kinds()
        jde.device_eval_metrics.reset()
        jspill.reset()
        with jlimit(limit):
            out["rows"] = daft_tpu.sql(tpch_sql.sql_text(name, SF), **frames).to_pydict()
        out["spill"] = jspill.snapshot()
        after = _jax_chain_kinds()
        out["chain_rows"] = {k: after[k] - before.get(k, 0) for k in after
                             if after[k] - before.get(k, 0)}
        out["fused_rows"] = jde.device_eval_metrics.snapshot()["fused_rows"]


@pytest.fixture(scope="module")
def runs():
    """Every query once: the port limited (beside the JAX package limited,
    on a thread) and the port unlimited."""
    arrow = {k: v.to_arrow() for k, v in generate_tpch_dbgen(SF).items()}
    jframes = _frames(daft_tpu, arrow)
    out = {}
    with daft_tpu_torch.execution_config_ctx(device="cpu"):
        tframes = _frames(daft_tpu_torch, arrow)
        limit = out_of_core.limit_for(tframes)
        for name in QUERIES:
            jax: dict = {}
            th = threading.Thread(target=_jax_limited, args=(jframes, name, limit, jax))
            th.start()
            held = out_of_core.run_sql(daft_tpu_torch, tframes, name, SF, limit)
            th.join(timeout=300)
            assert not th.is_alive() and "rows" in jax, f"{name}: the JAX package's run failed"
            free = out_of_core.run_sql(daft_tpu_torch, tframes, name, SF, None)
            out[name] = {"held": held, "free": free, "jax": jax}
        out["limit"] = limit
        out["frames"] = tframes
    return out


def _close(a: dict, b: dict) -> list:
    """Columns that differ: keys, strings and counts exactly, floats within
    ``RTOL``."""
    bad = []
    assert list(a) == list(b)
    for c in a:
        if len(a[c]) != len(b[c]):
            bad.append(c)
        elif any(isinstance(x, float) for x in a[c]):
            if not all(math.isclose(x, y, rel_tol=RTOL) for x, y in zip(a[c], b[c])):
                bad.append(c)
        elif a[c] != b[c]:
            bad.append(c)
    return bad


def test_the_limit_is_an_eighth_of_the_tables(runs):
    assert runs["limit"] == max(out_of_core.tables_bytes(runs["frames"]) // 8, 1 << 20)


@pytest.mark.parametrize("name", QUERIES)
def test_limited_rows_equal_the_unlimited_run_and_the_jax_package(runs, name):
    r = runs[name]
    rows = r["held"]["rows"]
    assert all(len(v) for v in rows.values()), "an empty result tests nothing"
    assert _close(rows, r["free"]["rows"]) == []
    assert rows == r["jax"]["rows"]


@pytest.mark.parametrize("name", QUERIES)
def test_spills_equal_the_jax_package(runs, name):
    r = runs[name]
    sp = r["held"]["spill"]
    assert {k: sp[k] for k in SPILL_KEYS} == r["jax"]["spill"]
    if name != "q01":  # q01 compresses to four groups as it streams
        assert sp["spills"] > 0, f"{name}: no spill at limit {runs['limit']}"
    assert r["free"]["spill"]["spills"] == 0
    mem = r["held"]["mem"]
    assert mem["spilled_bytes"] == sp["bytes_spilled"]


@pytest.mark.parametrize("name", QUERIES)
def test_device_routes_equal_the_jax_package(runs, name):
    r = runs[name]
    counters = r["held"]["counters"]
    assert counters["chain_rows"] == r["jax"]["chain_rows"]
    assert counters["fused_rows"] == r["jax"]["fused_rows"]


@pytest.mark.parametrize("name", QUERIES)
def test_every_query_leaves_nothing_held(runs, name):
    for run in ("held", "free"):
        assert runs[name][run]["audit"] == {"held": 0, "permits_out": 0, "spill_dirs": []}
    mem = runs[name]["held"]["mem"]
    assert mem["residual_bytes"] == 0 and mem["peak_held_bytes"] > 0
    assert get_ledger().total_held() == 0


@pytest.mark.parametrize("name,spilling_ops", [("q18", {"Aggregate"}),
                                                ("q21", {"Aggregate", "HashJoin"})])
def test_the_sinks_that_spill(runs, name, spilling_ops):
    """Which sinks spilled, by the ledger's spill charges: q18's 75,000-group
    aggregation of lineitem, and q21's joins (counted under the ``grace``
    route) and aggregations. Without the limit no join takes the grace
    route."""
    mem = runs[name]["held"]["mem"]
    spilled = {op for op, row in mem["by_operator"].items() if "spill" in row["kinds"]}
    assert spilled == spilling_ops
    graced = [j for j in runs[name]["held"]["joins"] if "grace" in j["routes"]]
    assert bool(graced) == ("HashJoin" in spilling_ops)
    assert not [j for j in runs[name]["free"]["joins"] if "grace" in j["routes"]]


def test_a_deadline_under_the_limit_leaves_nothing_held(runs):
    """q21 cut by a deadline mid-run (inside its permit waits) raises
    ``DaftTimeoutError`` and leaves the ledger, the permits and the spill
    directory at zero (side threads release as they observe the cancel, so
    the end state is exact and its instant is not: waited for up to 10 s)."""
    mm = get_memory_manager()
    with daft_tpu_torch.execution_config_ctx(device="cpu"):
        t0 = time.monotonic()
        with pytest.raises(DaftTimeoutError):
            out_of_core.run_sql(daft_tpu_torch, runs["frames"], "q21", SF, runs["limit"],
                                timeout=0.5)
        assert time.monotonic() - t0 < 5.0  # the deadline, not a 5 s permit wait
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and (mm.used() or get_ledger().total_held()):
        time.sleep(0.05)
    assert mm.used() == 0
    assert out_of_core.audit(None, None) == {"held": 0, "permits_out": 0, "spill_dirs": []}
