"""TPC-H q05, q07-q10, q12-q14 and q19 in DataFrame form
(``daft_tpu_torch/tools/tpch.py``) through the port and the JAX package, on
the CPU.

The seeded tables at SF 0.01 (60,044 lineitem rows) go through the port
(``device="cpu"``) at 1 and at 4 compute workers and through the JAX
package. The port's two runs must be the same bytes, with the same device
counters. Against the JAX package, keys and counts must be exact; each sum
must be within ``SUM_RTOL`` (1e-6): the two packages sum f32 products in
another order, and where their routes differ (the JAX package reorders
joins, its device programs contract multiply-adds) the last f32 bit can
differ, as q09's does. The chain kinds the device layer ran must equal the
JAX package's. Every query must also agree with its numpy reference within
``SUM_RTOL``, and q19 and q12 give the same rows with ``device_eval`` off.
"""

import numpy as np
import pytest

import daft_tpu
import daft_tpu_torch
from daft_tpu_torch.ops import device_eval as tde
from daft_tpu_torch.tools import tpch

SF = 0.01
SUM_RTOL = 1e-6
NAMES = list(tpch.EXPR_QUERIES)


@pytest.fixture(scope="module")
def tables():
    return tpch.tpch_tables(SF, seed=0, expressions=True)


@pytest.fixture(autouse=True)
def _configs():
    with daft_tpu.execution_config_ctx(result_cache_enabled=False), \
            daft_tpu_torch.execution_config_ctx(device="cpu", result_cache_enabled=False, default_morsel_size=8192):
        tde.device_eval_counters.reset()
        yield


def _run(pkg, tables, name, **cfg):
    with pkg.execution_config_ctx(**cfg):
        return tpch.EXPR_QUERIES[name](pkg, tpch.expr_frames(pkg, tables, name)).to_pydict()


def _jax_chain_kinds() -> dict:
    from daft_tpu import metrics

    snap = metrics.get_registry().snapshot()
    return {k: int(v) for k, v in snap.label_totals("daft_compiled_chain_rows_total",
                                                    "kind").items() if v}


@pytest.mark.parametrize("name", NAMES)
def test_query_equals_the_jax_package_at_1_and_4_workers(name, tables):
    outs, snaps = {}, {}
    for threads in (1, 4):
        tde.device_eval_counters.reset()
        outs[threads] = _run(daft_tpu_torch, tables, name, num_compute_threads=threads)
        snaps[threads] = tde.device_eval_counters.snapshot()
    assert outs[1] == outs[4]  # the same bytes at any worker count
    assert snaps[1]["chain_rows"] == snaps[4]["chain_rows"]
    assert snaps[1]["host_rows"] == snaps[4]["host_rows"]
    before = _jax_chain_kinds()
    jax = _run(daft_tpu, tables, name, default_morsel_size=8192)
    after = _jax_chain_kinds()
    assert tpch.expr_compare(name, outs[4], jax, SUM_RTOL) == []
    jax_kinds = {k: after.get(k, 0) - before.get(k, 0) for k in after}
    assert snaps[4]["chain_rows"] == {k: v for k, v in jax_kinds.items() if v}
    ref = tpch.EXPR_REFERENCES[name](tables)
    assert tpch.expr_compare(name, outs[4], ref, SUM_RTOL) == []
    assert tpch.expr_compare(name, jax, ref, SUM_RTOL) == []
    assert all(len(v) for v in outs[4].values()), "an empty result tests nothing"


@pytest.mark.parametrize("name", ["q19", "q12"])
def test_device_eval_off_gives_the_same_rows(name, tables):
    on = _run(daft_tpu_torch, tables, name)
    off = _run(daft_tpu_torch, tables, name, device_eval=False)
    assert tpch.expr_compare(name, off, on, SUM_RTOL) == []
    keys = [k for k, v in on.items() if v and not isinstance(v[0], float)]
    assert {k: on[k] for k in keys} == {k: off[k] for k in keys}


def test_q19_filter_is_refused_whole_and_runs_on_the_host(tables):
    """q19's OR of string compares, ``is_in`` and numeric bounds is refused
    whole by the device chain, in both packages: no filter chain runs on the
    device, and every joined row takes the host route."""
    tde.device_eval_counters.reset()
    before = _jax_chain_kinds()
    _run(daft_tpu, tables, "q19")
    after = _jax_chain_kinds()
    _run(daft_tpu_torch, tables, "q19")
    snap = tde.device_eval_counters.snapshot()
    assert snap["chain_rows"] == {} and after == before
    li = tables["lineitem"]
    assert snap["host_rows"]["chain_not_fusable"] > len(li["l_orderkey"])


def test_new_columns_leave_the_q03_q04_columns_byte_identical():
    plain = tpch.tpch_tables(SF, seed=3)
    full = tpch.tpch_tables(SF, seed=3, expressions=True)
    for table, cols in plain.items():
        for col, values in cols.items():
            other = full[table][col]
            if isinstance(values, np.ndarray):
                assert values.dtype == other.dtype and np.array_equal(values, other), col
            else:
                assert values.equals(other), col
    assert set(full) == {"customer", "orders", "lineitem", "part", "supplier", "partsupp",
                         "nation", "region"}


def test_generator_follows_the_spec(tables):
    """Every (l_partkey, l_suppkey) is in partsupp, four suppliers per part;
    the fixed nations and regions; the dictionary columns' domains; keys and
    dates int32."""
    ps, li, p = tables["partsupp"], tables["lineitem"], tables["part"]
    n_part, n_supp = len(p["p_partkey"]), len(tables["supplier"]["s_suppkey"])
    assert n_part == int(SF * 200_000) and n_supp == int(SF * 10_000)
    assert len(ps["ps_partkey"]) == 4 * n_part
    pairs = set(zip(ps["ps_partkey"].tolist(), ps["ps_suppkey"].tolist()))
    assert len(pairs) == 4 * n_part
    assert set(zip(li["l_partkey"].tolist(), li["l_suppkey"].tolist())) <= pairs
    assert len(tables["nation"]["n_nationkey"]) == 25 and len(tables["region"]["r_name"]) == 5
    assert set(li["l_shipmode"].to_pylist()) == set(tpch.SHIPMODES)
    assert set(li["l_returnflag"].to_pylist()) == {"A", "N", "R"}
    names = p["p_name"].to_pylist()
    assert all(len(set(n.split())) == 5 for n in names)
    for col in ("l_orderkey", "l_partkey", "l_suppkey", "l_shipdate"):
        assert li[col].dtype == np.int32, col
    assert ps["ps_supplycost"].dtype == np.float32
