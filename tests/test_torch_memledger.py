"""The byte ledger in the port (``daft_tpu_torch/execution/memledger.py`` and
its charge sites: the executor's permits, the stages' queues, the spill
files), on the CPU, beside the JAX package's.

Mirrors ``tests/test_memledger.py`` less its dashboard, ``EXPLAIN ANALYZE``
and distributed cases (ROADMAP A.8.5 / A.8.6): the bookkeeping, the
reservation's reconciliation (``over_bytes`` / ``under_bytes`` against the
JAX ledger's for the same charges, and a query's admission reservation
through the runner with its counters),
the disabled ledger, the query's ``mem`` block, drains to zero after a
cancelled or early-closed query, poison mid-acquire, a late ``_add_held``
after the unwind, charged bytes per (operator, kind) the same at 1 and 4
workers and equal to the JAX package's, concurrent queries never
cross-attributed, the stages' queue charges and stalls, an abandoned stage's
drain and the RSS sampler. Waits are bounded (``wait_until``): an aborted
query's side threads release as they observe the cancel, so the end state is
exact and the instant is not.
"""

import threading
import time

import pytest

import daft_tpu
import daft_tpu_torch
from daft_tpu.execution import memledger as jml
from daft_tpu.execution.resource_manager import memory_limit as jlimit
from daft_tpu_torch import col
from daft_tpu_torch.cancellation import CancelToken
from daft_tpu_torch.errors import DaftExecutionError, DaftTimeoutError
from daft_tpu_torch.execution.executor import Executor
from daft_tpu_torch.execution.memledger import MemoryLedger, RssSampler, get_ledger, read_rss_bytes
from daft_tpu_torch.execution.resource_manager import memory_limit
from daft_tpu_torch.physical.translate import translate
from daft_tpu_torch.udf import Udf
from torch_isolation import admission_windows_reset  # noqa: F401

pytestmark = pytest.mark.usefixtures("admission_windows_reset")


@pytest.fixture(autouse=True)
def _fresh_ledger():
    led = get_ledger()
    led.enabled = True
    led.reset()
    with daft_tpu.execution_config_ctx(result_cache_enabled=False), \
            daft_tpu_torch.execution_config_ctx(device="cpu", result_cache_enabled=False):
        yield
    led.reset()
    led.enabled = True


def make_data(rows, seed=0):
    return {"k": [(i * 7 + seed) % 97 for i in range(rows)],
            "v": [float((i + seed) % 1013) for i in range(rows)]}


def wait_until(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.05)
    return cond()


def charged_by_op(mem):
    return {(op, kind): k["charged"] for op, row in mem["by_operator"].items()
            for kind, k in row["kinds"].items()}


def port_mem(df):
    df.collect()
    return get_ledger().profile_for(df.query_id)


def jax_mem(df):
    df.collect()
    return daft_tpu.recent_queries(1)[0]["mem"]


# -- bookkeeping ---------------------------------------------------------------
def _bookkeeping(led):
    led.charge("q1", "Sort", 100, kind="permit")
    led.charge("q1", "Sort", 50, kind="permit")
    led.charge("q1", "Project", 30, kind="queue")
    totals = [led.total_held()]
    led.release("q1", "Sort", 60, kind="permit")
    totals.append(led.total_held())
    # An over-release clamps; unknown keys are no-ops (never negative).
    led.release("q1", "Sort", 10_000, kind="permit")
    led.release("q1", "Nope", 10, kind="queue")
    led.release("zzz", "Sort", 10, kind="permit")
    totals.append(led.total_held())
    return totals, led.audit(), led.finish_query("q1"), led.total_held(), led.audit()


def test_charge_release_peak_and_audit():
    totals, audit, block, after, audit_after = _bookkeeping(MemoryLedger(enabled=True))
    assert totals == [180, 120, 30]
    assert audit == {"q1": 30}
    assert block["residual_bytes"] == 30  # the queue charge never released
    assert block["peak_held_bytes"] == 180 and block["charged_bytes"] == 180
    assert after == 0 and audit_after == {}
    assert block["by_operator"]["Sort"]["kinds"]["permit"]["peak"] == 150
    assert block["by_operator"]["Project"]["kinds"]["queue"]["charged"] == 30
    # The JAX package's ledger, the same steps: the same numbers.
    jtotals, jaudit, jblock, jafter, _ = _bookkeeping(jml.MemoryLedger(enabled=True))
    assert (jtotals, jaudit, jafter) == (totals, audit, after)
    for key in ("residual_bytes", "peak_held_bytes", "charged_bytes", "spilled_bytes",
                "by_operator"):
        assert jblock[key] == block[key], key


@pytest.mark.parametrize("reserved", [0, 100, 180, 500])
def test_reservation_over_under_equal_the_jax_ledgers(reserved):
    """The peak (180) reconciled against a reservation: the same block in
    both packages, over by the excess and under by the slack."""
    blocks = []
    for led in (MemoryLedger(enabled=True), jml.MemoryLedger(enabled=True)):
        led.charge("q1", "Sort", 150, kind="permit")
        led.charge("q1", "Project", 30, kind="queue")
        led.release("q1", "Sort", 150, kind="permit")
        blocks.append(led.finish_query("q1", reserved_bytes=reserved, tenant="t"))
    ours, theirs = blocks
    for key in ("reserved_bytes", "peak_held_bytes", "over_bytes", "under_bytes",
                "residual_bytes", "charged_bytes"):
        assert ours[key] == theirs[key], key
    assert ours["over_bytes"] == (max(180 - reserved, 0) if reserved else 0)
    assert ours["under_bytes"] == (max(reserved - 180, 0) if reserved else 0)


def test_reservation_reconciliation_metrics_and_block():
    """With an admission memory quota the ticket carries a reservation (one
    sink share); the query's mem block reconciles it, the over / under
    counters move by the block's numbers, and the reservation is the JAX
    package's for the same query."""
    from daft_tpu import metrics as jmetrics
    from daft_tpu.execution.admission import get_controller as jctl
    from daft_tpu_torch import metrics
    from daft_tpu_torch.execution.admission import get_controller
    from daft_tpu_torch.execution.spill import sink_budget

    reserved = []
    for pkg, reg, ctl, limit in ((daft_tpu_torch, metrics.get_registry(), get_controller,
                                  memory_limit),
                                 (daft_tpu, jmetrics.get_registry(), jctl, jlimit)):
        s0o = reg.snapshot().counter_total("daft_memory_reservation_over_bytes")
        s0u = reg.snapshot().counter_total("daft_memory_reservation_under_bytes")
        ctl().reset()
        pkg.set_tenant_policy("memobs", max_memory_fraction=0.5)
        try:
            pkg.set_tenant("memobs")
            with limit(8 << 20) as mm:
                df = pkg.from_pydict(make_data(50_000)).where(pkg.col("k") > 3)
                df.to_pydict()
                share = sink_budget(mm.limit)
        finally:
            pkg.set_tenant(None)
            ctl().reset()
        mem = pkg.recent_queries(1)[0]["mem"]
        assert mem["reserved_bytes"] == share
        assert mem["over_bytes"] == max(mem["peak_held_bytes"] - share, 0)
        assert mem["under_bytes"] == max(share - mem["peak_held_bytes"], 0)
        assert reg.snapshot().counter_total("daft_memory_reservation_over_bytes") - s0o \
            == mem["over_bytes"]
        assert reg.snapshot().counter_total("daft_memory_reservation_under_bytes") - s0u \
            == mem["under_bytes"]
        reserved.append(mem["reserved_bytes"])
    assert reserved[0] == reserved[1] == (8 << 20) // 4


def test_disabled_ledger_is_a_noop():
    led = MemoryLedger(enabled=False)
    led.charge("q", "Sort", 100)
    led.note_stall("q", "Sort", 1.0)
    assert led.total_held() == 0
    assert led.finish_query("q") == {}


def test_config_turns_the_ledger_off():
    with daft_tpu_torch.execution_config_ctx(memory_ledger_enabled=False):
        df = daft_tpu_torch.from_pydict(make_data(1000)).sort("v")
        df.collect()
    assert not get_ledger().enabled
    assert get_ledger().profile_for(df.query_id) is None


# -- end to end: the mem block, drains to zero ------------------------------------
def test_query_mem_block_and_zero_drain():
    with memory_limit(1 << 20):
        mem = port_mem(daft_tpu_torch.from_pydict(make_data(200_000)).sort("v"))
    with jlimit(1 << 20):
        jmem = jax_mem(daft_tpu.from_pydict(make_data(200_000)).sort("v"))
    led = get_ledger()
    assert led.total_held() == 0 and led.audit() == {}
    assert mem["residual_bytes"] == 0
    assert mem["peak_held_bytes"] > 0
    assert mem["spilled_bytes"] > 0  # 200k rows against a 1 MiB limit
    sort_row = mem["by_operator"]["Sort"]
    assert sort_row["kinds"]["spill"]["charged"] == mem["spilled_bytes"]
    assert sort_row["kinds"]["permit"]["peak"] > 0
    assert mem["spilled_bytes"] == jmem["spilled_bytes"]
    assert sort_row["kinds"] == jmem["by_operator"]["Sort"]["kinds"]


def test_cancelled_query_drains_to_zero():
    def slow(v):
        time.sleep(0.01)
        return v

    udf = Udf(slow, daft_tpu_torch.DataType.float64(), batch=True)
    # 50 morsels of 10,000 rows, 0.01 s each, against a 0.2 s deadline.
    with memory_limit(1 << 20) as mm, daft_tpu_torch.execution_config_ctx(
            udf_dynamic_batching=False, default_morsel_size=10_000):
        baseline = mm.available_permits()
        df = daft_tpu_torch.from_pydict(make_data(500_000)).with_column(
            "s", udf(col("v"))).sort("s")
        with pytest.raises(DaftTimeoutError):
            df.collect(timeout=0.2)
        assert wait_until(lambda: mm.available_permits() == baseline)
    led = get_ledger()
    assert wait_until(lambda: led.total_held() == 0), led.audit()
    assert led.profile_for(df.query_id)["residual_bytes"] == 0


def test_early_close_limit_drains_to_zero():
    df = daft_tpu_torch.from_pydict(make_data(300_000)).where(col("k") > 1).limit(3)
    assert len(df.to_pydict()["k"]) == 3
    assert get_ledger().total_held() == 0
    assert get_ledger().profile_for(df.query_id)["residual_bytes"] == 0


def test_abandoned_iteration_drains_to_zero():
    with memory_limit(1 << 20) as mm:
        df = daft_tpu_torch.from_pydict(make_data(200_000)).sort("v")
        it = df.iter_partitions()
        next(it)
        it.close()  # abandon mid-stream: the executor tears down now
        assert mm.available_permits() == 1 << 20
    assert get_ledger().total_held() == 0
    assert get_ledger().profile_for(df.query_id)["residual_bytes"] == 0


# -- poison / late acquire through the ledger ------------------------------------
def test_poison_mid_acquire_leaves_ledger_zero():
    led = get_ledger()
    with memory_limit(1 << 16) as mm:
        baseline = mm.available_permits()
        assert mm.acquire(1 << 15)
        token = CancelToken(None, query_id="poisoned")
        result = {}

        def blocked():
            try:
                ok = mm.acquire(3 << 14, token=token)
                if ok:  # only a GRANTED acquire charges
                    led.charge("poisoned", "Sort", 3 << 14, kind="permit")
                result["ok"] = ok
            except BaseException as e:  # noqa: BLE001 — recorded for the asserts
                result["err"] = e

        th = threading.Thread(target=blocked)
        th.start()
        time.sleep(0.1)
        mm.poison(RuntimeError("query died"), query_id="poisoned")
        th.join(timeout=10)
        assert isinstance(result.get("err"), RuntimeError)
        mm.release(1 << 15)
        assert mm.available_permits() == baseline
    assert led.audit().get("poisoned") is None
    assert led.total_held() == 0


def test_late_add_held_after_unwind_charges_nothing():
    led = get_ledger()
    with memory_limit(1 << 16) as mm:
        baseline = mm.available_permits()
        cfg = daft_tpu_torch.context.get_context().execution_config
        ex = Executor(cfg, cancel_token=CancelToken(query_id="late"))
        plan = translate(daft_tpu_torch.from_pydict({"a": [1, 2, 3]})._builder.optimize().plan)
        list(ex.run(plan))
        assert mm.acquire(1 << 10)
        ex._add_held(1 << 10, op="Sort")
        assert mm.available_permits() == baseline
    assert led.total_held() == 0, led.audit()


def test_failed_query_poisons_and_drains():
    """A failure inside the plan (a UDF raising) unwinds with the ledger at
    zero and every permit back."""
    def boom(v):
        raise ValueError("boom")

    udf = Udf(boom, daft_tpu_torch.DataType.float64(), batch=True)
    with memory_limit(1 << 20) as mm:
        df = daft_tpu_torch.from_pydict(make_data(50_000)).sort("v").with_column(
            "b", udf(col("v")))
        with pytest.raises(DaftExecutionError, match="boom") as info:
            df.collect()
        assert type(info.value.__cause__) is ValueError
        assert mm.available_permits() == 1 << 20
    assert get_ledger().total_held() == 0


# -- determinism and attribution ---------------------------------------------------
def _grouped(pkg, threads):
    cfg = {"num_compute_threads": threads, "default_morsel_size": 32 * 1024}
    with pkg.execution_config_ctx(**cfg):
        df = pkg.from_pydict(make_data(200_000)).where(pkg.col("k") > 7) \
            .groupby("k").agg(pkg.col("v").sum().alias("s"))
        return charged_by_op(port_mem(df) if pkg is daft_tpu_torch else jax_mem(df))


@pytest.mark.parametrize("threads", [1, 4])
def test_charged_bytes_thread_count_invariant_and_equal_to_the_jax_package(threads):
    """Cumulative charged bytes per (operator, kind) are a pure function of
    the morsel stream: the same at 1 and 4 workers, and the JAX package's."""
    port = _grouped(daft_tpu_torch, threads)
    assert port, "the run attributed nothing"
    assert port == _grouped(daft_tpu_torch, 1)
    assert port == _grouped(daft_tpu, threads)
    assert get_ledger().total_held() == 0


def test_concurrent_queries_never_cross_attribute():
    def run_one(rows, seed, out, key):
        df = daft_tpu_torch.from_pydict(make_data(rows, seed)).where(col("k") > 7).select(
            (col("v") * 2).alias("w"))
        out[key] = charged_by_op(port_mem(df))

    serial, both = {}, {}
    run_one(400_000, 1, serial, "big")
    run_one(20_000, 2, serial, "small")
    threads = [threading.Thread(target=run_one, args=(400_000, 1, both, "big")),
               threading.Thread(target=run_one, args=(20_000, 2, both, "small"))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
        assert not t.is_alive()
    assert serial["big"] != serial["small"]
    assert both == serial
    assert get_ledger().total_held() == 0


def test_shared_subtree_pins_are_charged_until_the_query_ends():
    """A subtree two parents share is cached once under permits
    (``SharedSubtree``), charged as in the JAX package, and released at the
    end."""
    text = ("SELECT a FROM t WHERE a IN (SELECT a FROM t WHERE b > 3) "
            "AND EXISTS (SELECT 1 FROM t t2 WHERE t2.a = t.a AND t2.b <> t.b)")
    data = {"a": [i % 50 for i in range(5000)], "b": [i % 7 for i in range(5000)]}
    with memory_limit(1 << 30):
        df = daft_tpu_torch.sql(text, t=daft_tpu_torch.from_pydict(data))
        mem = port_mem(df)
        port = df.to_pydict()
    with jlimit(1 << 30):
        jdf = daft_tpu.sql(text, t=daft_tpu.from_pydict(data))
        jmem = jax_mem(jdf)
        jax = jdf.to_pydict()
    assert sorted(port["a"]) == sorted(jax["a"])
    assert charged_by_op(mem) == charged_by_op(jmem)
    assert mem["residual_bytes"] == 0 and get_ledger().total_held() == 0


# -- the stages' queues -------------------------------------------------------------
class _FakeMorsel:
    def __init__(self, n):
        self.n = n

    def size_bytes(self):
        return self.n


def test_stage_queue_charges_and_stall():
    from concurrent.futures import ThreadPoolExecutor

    from daft_tpu_torch.execution.pipeline import run_stage

    led = get_ledger()
    pool = ThreadPoolExecutor(max_workers=2)
    items = [_FakeMorsel(1000) for _ in range(24)]
    seen = []
    try:
        stream = run_stage(iter(items), lambda m: m, pool=pool, workers=2,
                           name="StallStage", ledger=("qstall", "StallStage"))
        for i, m in enumerate(stream):
            if i == 0:
                # A slow consumer: the feeder fills the bounded queue and
                # blocks (the stall being measured).
                time.sleep(0.6)
                assert led.total_held() > 0, "completed, unconsumed morsels are charged"
            seen.append(m)
    finally:
        pool.shutdown(wait=False)
    assert len(seen) == 24
    assert led.total_held() == 0
    prof = led.finish_query("qstall")
    assert prof["by_operator"]["StallStage"]["kinds"]["queue"]["charged"] == 24_000
    assert prof["stall_s"] > 0
    assert led.process_stats()["stall_s_by_op"]["StallStage"] > 0


def test_serial_stage_charges_the_same_bytes():
    from daft_tpu_torch.execution.pipeline import map_stage

    led = get_ledger()
    items = [_FakeMorsel(1000) for _ in range(24)]
    assert len(list(map_stage(iter(items), lambda m: m, pool=None, workers=1, name="Serial",
                              ledger=("qserial", "Serial")))) == 24
    assert led.total_held() == 0
    prof = led.finish_query("qserial")
    assert prof["by_operator"]["Serial"]["kinds"]["queue"]["charged"] == 24_000
    assert prof["by_operator"]["Serial"]["kinds"]["queue"]["peak"] == 1000


def test_abandoned_stage_drains_queue_charges():
    from concurrent.futures import ThreadPoolExecutor

    from daft_tpu_torch.execution.pipeline import run_stage

    led = get_ledger()
    pool = ThreadPoolExecutor(max_workers=2)
    items = [_FakeMorsel(500) for _ in range(50)]
    try:
        stream = run_stage(iter(items), lambda m: m, pool=pool, workers=2, name="Abandoned",
                           ledger=("qab", "Abandoned"))
        next(stream)
        stream.close()  # abandon mid-flight
    finally:
        pool.shutdown(wait=True)
    # Whatever the workers completed after the close released itself.
    assert wait_until(lambda: led.total_held() == 0), led.audit()


def test_stage_account_sizes_extension_types_like_the_jax_package():
    """The template takes the exact walk where a column's Arrow type has no
    bit width (strings, lists, tensors) in both packages: the same bytes."""
    import numpy as np

    from daft_tpu.execution.pipeline import _StageAccount as JAccount
    from daft_tpu_torch.execution.pipeline import _StageAccount as TAccount

    rng = np.random.default_rng(0)
    data = {"e": [rng.standard_normal(8).astype(np.float32) for _ in range(64)],
            "s": [f"row-{i}" for i in range(64)], "i": list(range(64)),
            "b": [i % 2 == 0 for i in range(64)]}
    jmp = daft_tpu.from_pydict(data).collect()._result[0]
    tmp = daft_tpu_torch.from_pydict(data).collect()._result[0]
    assert str(tmp.schema["e"].dtype).startswith("FixedShapeTensor")
    assert JAccount("q", "op").measure(jmp) == TAccount("q", "op").measure(tmp) > 0


# -- the RSS sampler ------------------------------------------------------------------
def test_rss_sampler_ticks_and_parks():
    assert read_rss_bytes() > 0
    led = MemoryLedger(enabled=True)
    sampler = RssSampler(led, interval_s=0.02)
    sampler.start()
    try:
        led.charge("qs", "Sort", 10)
        sampler.wake()
        assert wait_until(lambda: sampler.samples > 0, timeout=5)
        prof = led.finish_query("qs")
        assert prof["rss_peak_bytes"] > 0
        assert led.process_stats()["rss_bytes"] > 0
        # No query in flight: the sampler parks and stops counting.
        time.sleep(0.1)
        parked = sampler.samples
        time.sleep(0.2)
        assert sampler.samples <= parked + 1
    finally:
        sampler.stop()
