"""Out-of-core execution in the port: the blocking sinks spill under a memory
limit (``daft_tpu_torch/execution/spill.py`` and the executor's budget
paths), on the CPU, held against the JAX package under the same limit.

Mirrors ``tests/test_spill.py`` less the grace window and grace repartition
(``tests/test_torch_spill_windows.py`` holds those): each query runs in the port without a
limit and under ``LIMIT`` (a sink budget of 64 KiB against about 1 MB of
data) and in the JAX package under ``LIMIT``; the limited rows must equal the
unlimited ones and the JAX package's, bit for bit (both packages compute on
the host with the same Arrow calls), with the same spill events, files and
bytes. Then what a spill must never do: go on in memory after a failed write
or read, or read bytes whose digest does not match.
"""

import os
import tempfile

import numpy as np
import pyarrow as pa
import pytest

import daft_tpu
import daft_tpu_torch
from daft_tpu.execution.resource_manager import memory_limit as jlimit
from daft_tpu.execution.spill import spill_metrics as jspill
from daft_tpu_torch.errors import DaftCorruptionError, DaftExecutionError
from daft_tpu_torch.execution.join_index import join_counters
from daft_tpu_torch.execution.memledger import get_ledger
from daft_tpu_torch.execution.resource_manager import memory_limit
from daft_tpu_torch.execution.spill import (
    SpillDir,
    budget_reservation,
    sink_budget,
    spill_metrics,
)
from daft_tpu_torch.micropartition import MicroPartition
from daft_tpu_torch.ops import device_eval as tde
from torch_isolation import admission_windows_reset  # noqa: F401

pytestmark = [pytest.mark.filterwarnings("ignore:Specifying null_placement:FutureWarning"),
              pytest.mark.usefixtures("admission_windows_reset")]

N = 50_000
LIMIT = 256 * 1024  # sink budget = LIMIT / 4 = 64 KiB, far below the data (~1 MB)
SPILL_KEYS = ("spills", "files", "bytes_spilled")


@pytest.fixture(autouse=True)
def _configs():
    with daft_tpu.execution_config_ctx(result_cache_enabled=False), \
            daft_tpu_torch.execution_config_ctx(device="cpu", result_cache_enabled=False):
        yield


def big_data():
    rng = np.random.default_rng(7)
    return {"k": rng.integers(0, 5_000, N).tolist(), "v": rng.standard_normal(N).tolist(),
            "s": [f"row-{i % 997}" for i in range(N)]}


def run_both(query, limit=LIMIT):
    """``query(pkg)`` in the port without a limit and under ``limit``, and in
    the JAX package under ``limit``: (unlimited, limited, jax limited, the
    port's spill counters, the JAX package's). Every limited run must leave
    the ledger at zero, every permit back and no spill directory."""
    expected = query(daft_tpu_torch).to_pydict()
    spill_metrics.reset()
    join_counters.reset()
    with memory_limit(limit) as mm:
        actual = query(daft_tpu_torch).to_pydict()
        assert mm.available_permits() == limit
    sp = spill_metrics.snapshot()
    assert get_ledger().total_held() == 0
    assert not [d for d in spill_metrics.dirs() if os.path.exists(d)]
    jspill.reset()
    with jlimit(limit):
        jax = query(daft_tpu).to_pydict()
    jsp = jspill.snapshot()
    assert actual == expected
    assert actual == jax
    assert {k: sp[k] for k in SPILL_KEYS} == jsp
    return actual, sp


def test_external_sort_spills():
    data = big_data()
    _, sp = run_both(lambda pkg: pkg.from_pydict(data).sort("v"))
    assert sp["spills"] > 0 and sp["bytes_spilled"] > 0


def test_external_sort_multi_key_desc_over_many_runs():
    data = big_data()
    with daft_tpu.execution_config_ctx(default_morsel_size=4096), \
            daft_tpu_torch.execution_config_ctx(default_morsel_size=4096):
        _, sp = run_both(lambda pkg: pkg.from_pydict(data).where(pkg.col("v") > -5.0)
                         .sort(["k", "v"], desc=[True, False]))
    assert sp["spills"] > 1  # several sorted runs, merged


def test_grace_grouped_agg_spills():
    data = big_data()

    def q(pkg):
        return (pkg.from_pydict(data).groupby("k")
                .agg(pkg.col("v").sum().alias("sv"), pkg.col("v").count().alias("cv"),
                     pkg.col("v").mean().alias("mv"))
                .sort("k"))

    out, sp = run_both(q)
    assert sp["spills"] > 0
    assert len(out["k"]) == len(set(big_data()["k"]))


def test_grace_distinct_spills():
    # About 40k distinct (a, pad) pairs: the per-morsel dedupe cannot shrink
    # below the 64 KiB budget, so the grace buckets take it.
    data = {"a": [i % 40_000 for i in range(N)],
            "pad": [f"padding-string-{i % 40_000}" for i in range(N)]}
    out, sp = run_both(lambda pkg: pkg.from_pydict(data).distinct().sort(["a", "pad"]))
    assert sp["spills"] > 0
    assert len(out["a"]) == 40_000


@pytest.mark.parametrize("how", ["inner", "left", "outer", "right", "semi", "anti"])
def test_grace_hash_join_spills(how):
    # BOTH sides exceed the 64 KiB budget, so every join type takes the grace
    # buckets (a build side inside the budget keeps the streaming probe).
    rng = np.random.default_rng(11)
    left = {"k": rng.integers(0, 30_000, N).tolist(), "lv": list(range(N))}
    nr = 30_000
    # Even keys, each twice: a quarter of the left rows match (two rows each).
    right = {"k": [(i * 2) % 15_000 for i in range(nr)],
             "rv": [f"right-side-payload-{i}" for i in range(nr)]}

    def q(pkg):
        out = pkg.from_pydict(left).join(pkg.from_pydict(right), on="k", how=how)
        # Every output column as a sort key: the rows' order is then fixed
        # whatever order the join gave them in.
        return out.sort(["k", "lv"] if how in ("semi", "anti") else ["k", "lv", "rv"])

    _, sp = run_both(q)
    assert sp["spills"] > 0
    (join,) = join_counters.snapshot()
    assert join["build_rows"] == nr
    assert list(join["routes"]) == ["grace"]
    assert join["routes"]["grace"]["rows_in"] == N


def test_grace_join_spills_before_downstream():
    """The join itself spills (no sort after it): count only rows."""
    rng = np.random.default_rng(17)
    left = {"k": rng.integers(0, 1_000, N).tolist()}
    right = {"k": [i % 2_000 for i in range(N)]}

    def q(pkg):
        return pkg.from_pydict(left).join(pkg.from_pydict(right), on="k", how="inner") \
            .count("k")

    out, sp = run_both(q)
    assert sp["spills"] > 0 and out["k"][0] > 0


def test_grace_join_mixed_key_dtypes():
    """int32 against int64 keys land equal values in the same grace bucket:
    the row hash depends on the byte width, so both sides hash the unified
    dtype."""
    rng = np.random.default_rng(19)
    left = {"k": np.asarray(rng.integers(0, 1_500, N), dtype=np.int32), "lv": list(range(N))}
    nr = 30_000
    right = {"k": np.asarray([i % 3_000 for i in range(nr)], dtype=np.int64),
             "rv": [f"payload-{i}" for i in range(nr)]}
    out, sp = run_both(lambda pkg: pkg.from_pydict(left).join(pkg.from_pydict(right), on="k",
                                                              how="semi").sort("lv"))
    assert sp["spills"] > 0
    assert out["lv"] == list(range(N))  # every left key < 1,500 matches


def test_grace_agg_many_spill_events_few_keys():
    """Many spills over few group keys: a bucket's batch coalesces partial
    fragments with repeated keys, and the merge still collapses them."""
    n = 100_000
    data = {"k": [i % 8 for i in range(n)], "v": [1] * n}
    with daft_tpu.execution_config_ctx(default_morsel_size=4096), \
            daft_tpu_torch.execution_config_ctx(default_morsel_size=4096):
        out, sp = run_both(lambda pkg: pkg.from_pydict(data).groupby("k").agg(
            pkg.col("v").sum().alias("s"), pkg.col("v").count().alias("c")).sort("k"))
    assert sp["spills"] > 1
    assert out == {"k": list(range(8)), "s": [12500] * 8, "c": [12500] * 8}


def test_global_agg_under_a_budget_compresses_in_place():
    """A global aggregation keeps one row of state: it never spills, and
    under a budget it leaves the absorbed-chain route, as in the JAX
    package."""
    data = big_data()
    tde.device_eval_counters.reset()
    out, sp = run_both(lambda pkg: pkg.from_pydict(data).where(pkg.col("k") > 10)
                       .agg(pkg.col("v").sum().alias("s"), pkg.col("k").count().alias("c")))
    assert sp["spills"] == 0
    assert out["c"] == [sum(1 for k in data["k"] if k > 10)]


def test_no_spill_without_limit():
    spill_metrics.reset()
    df = daft_tpu_torch.from_pydict(big_data()).sort("v")
    df.to_pydict()
    assert spill_metrics.snapshot()["spills"] == 0
    assert "spill" not in get_ledger().profile_for(df.query_id)["by_operator"].get(
        "Sort", {"kinds": {}})["kinds"]


def _jax_chain_kinds() -> dict:
    from daft_tpu import metrics

    snap = metrics.get_registry().snapshot()
    return {k: int(v) for k, v in snap.label_totals("daft_compiled_chain_rows_total",
                                                    "kind").items() if v}


def test_tpch_style_query_under_memory_pressure():
    """q01-shaped: filter, grouped sum / mean / count, sort, with the limit
    at 1/8 of the data; the device layer's routes equal the JAX package's
    under the same limit."""
    rng = np.random.default_rng(3)
    n = 60_000
    data = {"flag": rng.integers(0, 3, n).tolist(), "status": rng.integers(0, 2, n).tolist(),
            "qty": rng.integers(1, 50, n).tolist(), "price": (rng.random(n) * 1000).tolist(),
            "disc": (rng.random(n) * 0.1).tolist()}

    def q(pkg):
        return (pkg.from_pydict(data).where(pkg.col("qty") > 5)
                .with_column("rev", pkg.col("price") * (1 - pkg.col("disc")))
                .groupby("flag", "status")
                .agg(pkg.col("qty").sum().alias("sum_qty"), pkg.col("rev").sum().alias("sum_rev"),
                     pkg.col("price").mean().alias("avg_price"),
                     pkg.col("qty").count().alias("cnt"))
                .sort(["flag", "status"]))

    limit = n * 5 * 8 // 8
    with daft_tpu.execution_config_ctx(device_eval_min_rows=1), \
            daft_tpu_torch.execution_config_ctx(device_eval_min_rows=1):
        tde.device_eval_counters.reset()
        before = _jax_chain_kinds()
        out, sp = run_both(q, limit=limit)
        after = _jax_chain_kinds()
    assert sp["spills"] > 0
    assert len(out["flag"]) == 6
    # The port ran the chain twice (without and with the limit), the JAX
    # package once: the same kinds, the port's rows twice the JAX package's.
    jax_kinds = {k: after.get(k, 0) - before.get(k, 0) for k in after}
    port_kinds = tde.device_eval_counters.snapshot()["chain_rows"]
    assert port_kinds == {k: 2 * v for k, v in jax_kinds.items() if v}


# -- what a spill must never do -------------------------------------------------
def _part(n=1000):
    return MicroPartition.from_pydict({"a": list(range(n)), "b": [f"s{i}" for i in range(n)]})


class _Payload:
    """An object Arrow cannot hold: the column is a Python-object column."""

    def __init__(self, x):
        self.x = x

    def __eq__(self, other):
        return isinstance(other, _Payload) and other.x == self.x


def test_a_python_object_column_survives_the_disk(tmp_path):
    d = SpillDir(root=str(tmp_path), query_id="")
    objs = [_Payload(i) if i % 3 else None for i in range(100)]
    mp = MicroPartition.from_pydict({"o": objs, "i": list(range(100))})
    assert mp.schema["o"].dtype.is_python()
    sf = d.write(mp, chunk_rows=17)
    back = d.read_all([sf])
    assert back.to_pydict() == mp.to_pydict()
    d.cleanup()
    assert not os.path.exists(d.root)


def test_a_digest_mismatch_raises_and_quarantines(tmp_path):
    d = SpillDir(root=str(tmp_path))
    sf = d.write(_part())
    with open(sf.path, "r+b") as f:  # flip one byte of the payload
        f.seek(os.path.getsize(sf.path) // 2)
        byte = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([byte[0] ^ 0xFF]))
    with pytest.raises(DaftCorruptionError, match="spill"):
        list(d.stream(sf))
    assert not os.path.exists(sf.path) and os.path.exists(sf.path + ".quarantined")
    d.cleanup()
    assert not os.path.exists(d.root)


def test_verify_on_write_and_the_check_off(tmp_path):
    d = SpillDir(root=str(tmp_path))
    with daft_tpu_torch.execution_config_ctx(integrity_verify_on_write=True):
        sf = d.write(_part())
    assert sf.digest.startswith("c1-")
    with open(sf.path, "ab") as f:
        f.write(b"\0")  # a changed file
    with daft_tpu_torch.execution_config_ctx(integrity_enabled=False):
        assert sum(len(rb) for rb in d.stream(sf)) == 1000  # no check: the stream decodes
    with pytest.raises(DaftCorruptionError):
        list(d.stream(sf))
    d.cleanup()


def test_a_failed_read_raises(tmp_path):
    d = SpillDir(root=str(tmp_path))
    sf = d.write(_part())
    os.remove(sf.path)
    with pytest.raises(DaftExecutionError, match="spill read failed") as ei:
        list(d.stream(sf))
    assert isinstance(ei.value.__cause__, OSError)
    d.cleanup()


def test_a_failed_write_fails_the_query(tmp_path, monkeypatch):
    """A spill that cannot be written fails the query from its cause: it
    never goes on in memory, and it leaves nothing held."""
    blocker = tmp_path / "not-a-directory"
    blocker.write_text("")
    monkeypatch.setattr(tempfile, "tempdir", str(blocker))
    with memory_limit(LIMIT) as mm:
        with pytest.raises(DaftExecutionError, match="spill write failed") as ei:
            daft_tpu_torch.from_pydict(big_data()).sort("v").to_pydict()
        assert isinstance(ei.value.__cause__, OSError)
        assert mm.available_permits() == LIMIT
    assert get_ledger().total_held() == 0


def test_budget_reservation_best_effort_is_counted():
    """A reservation the gate cannot grant (here: every permit taken and the
    query cancelled) goes on at best effort, counted, charging nothing."""
    from daft_tpu_torch.cancellation import CancelToken

    spill_metrics.reset()
    with memory_limit(1 << 20) as mm:
        assert mm.acquire(1 << 20)
        token = CancelToken(query_id="best-effort")
        token.cancel()
        with budget_reservation(mm, sink_budget(mm.limit), token=token, op="Sort"):
            assert mm.available_permits() == 0
        mm.release(1 << 20)
        assert mm.available_permits() == 1 << 20
    assert spill_metrics.snapshot()["best_effort_reservations"] == 1
    assert get_ledger().audit().get("best-effort") is None
    assert sink_budget(None) is None and sink_budget(1024) == 1 << 16


def test_the_grace_distinct_folds_a_bucket_in_linear_work():
    """C.37: a bucket's batches fold into its distinct rows in bounded work
    per row (the JAX package re-deduplicates everything kept so far for each
    batch, quadratic in the batches), with the rows in the same first-seen
    order as the JAX package's batch-by-batch fold."""
    from daft_tpu_torch.execution.executor import Executor
    from daft_tpu_torch.recordbatch import RecordBatch

    rng = np.random.default_rng(5)
    batches = [RecordBatch.from_pydict({"a": rng.integers(0, 40_000, 4096).tolist(),
                                        "b": rng.integers(0, 2, 4096).tolist()})
               for _ in range(60)]
    folded = {"rows": 0}
    real = RecordBatch.distinct

    def counting(self, on=None):
        folded["rows"] += len(self)
        return real(self, on)

    reference = None
    for rb in batches:  # the JAX package's fold, batch by batch
        d = real(rb)
        reference = d if reference is None else real(RecordBatch.concat([reference, d]))
    RecordBatch.distinct = counting
    try:
        out = Executor._fold_distinct(iter(batches), None)
    finally:
        RecordBatch.distinct = real
    assert out.to_pydict() == reference.to_pydict()
    n = sum(len(rb) for rb in batches)
    # Each row is folded a few times (2.2 times the input in all here); the
    # batch-by-batch fold dedupes 15.3 times the input, and more the more
    # batches a bucket has.
    assert folded["rows"] <= 5 * n


@pytest.mark.parametrize("groups", [5, 20_000])
def test_the_grouped_state_merges_in_linear_work(monkeypatch, groups):
    """C.38: past the merge threshold the port merges the partial state when
    the rows added since the last merge outnumber its output; the JAX package
    merges on every flush, so a state that barely shrinks (many groups) is
    re-merged whole each time, quadratic in the input. Few groups merge
    where the JAX package merges; either way the state finalizes to the JAX
    package's rows, in its order and to its bits."""
    from daft_tpu.execution import aggregation as jagg
    from daft_tpu_torch.execution import aggregation as tagg

    rng = np.random.default_rng(11)
    batches = [{"k": rng.integers(0, groups, 500).astype(np.int64),
                "v": rng.standard_normal(500)} for _ in range(80)]
    n = sum(len(b["k"]) for b in batches)
    results = []
    for mod, pkg in ((jagg, daft_tpu), (tagg, daft_tpu_torch)):
        monkeypatch.setattr(mod.AggState, "MERGE_THRESHOLD_ROWS", 1000)
        merged = {"rows": 0}
        real = mod.AggState._merge

        def counting(self, real=real, merged=merged):
            if len(self._buffers) > 1:
                merged["rows"] += self._buffer_rows + self._raw_rows
            return real(self)

        monkeypatch.setattr(mod.AggState, "_merge", counting)
        df = pkg.from_pydict(batches[0])
        node = df.groupby("k").agg(pkg.col("v").sum().alias("s"),
                                   pkg.col("v").mean().alias("m"))._builder.plan
        st = mod.AggState(node.agg_exprs, node.group_by, node.schema,
                          input_schema=df._builder.schema)
        for b in batches:
            st.accumulate(pkg.MicroPartition.from_pydict(b))
        results.append((st.finalize().to_pydict(), merged["rows"]))
    (jrows, jmerged), (trows, tmerged) = results
    assert trows == jrows
    if groups == 5:
        assert tmerged == jmerged
    else:
        assert tmerged <= 3 * n < jmerged


@pytest.mark.parametrize("dtypes", [("int32", "int32"), ("int8", "uint16"), ("int64", "int32"),
                                    ("int16", "int16", "int8")])
def test_integer_keys_pack_into_one_hash_pass(monkeypatch, dtypes):
    """Null-free integer keys of at most 64 bits together are packed into one
    int64 a row and hashed once (the grace distinct's dedupe over two int32
    keys spends most of its time here). The group ids and first occurrences
    equal the per-column codes' bit for bit, and a distinct over them equals
    the JAX package's; wider or nullable keys keep the per-column codes."""
    from daft_tpu_torch import recordbatch as trb
    from daft_tpu_torch.series import Series

    rng = np.random.default_rng(13)
    cols = {f"k{i}": pa.array(rng.integers(0 if d.startswith("u") else -40, 40, 5000).astype(d))
            for i, d in enumerate(dtypes)}
    keys = [Series.from_arrow(a, n) for n, a in cols.items()]
    packs = sum(np.dtype(d).itemsize for d in dtypes) <= 8
    assert (trb._packed_int_keys(keys) is not None) == packs
    packed = trb._group_codes(keys)
    monkeypatch.setattr(trb, "_packed_int_keys", lambda keys: None)
    general = trb._group_codes(keys)
    monkeypatch.undo()
    assert all(np.array_equal(p, g) and p.dtype == g.dtype for p, g in zip(packed, general))
    table = pa.table(cols)
    ours = trb.RecordBatch.from_arrow_table(table).distinct().to_pydict()
    theirs = daft_tpu.RecordBatch.from_arrow_table(table).distinct().to_pydict()
    assert ours == theirs
    with_null = [Series.from_arrow(pa.array([1, None, 2], pa.int32()), "a"),
                 Series.from_arrow(pa.array([1, 2, 3], pa.int32()), "b")]
    assert trb._packed_int_keys(with_null) is None
