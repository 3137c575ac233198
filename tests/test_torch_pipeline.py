"""The port's pipelined engine (daft_tpu_torch: execution/pipeline.py, the
executor's compute pool, UDF ``max_concurrency`` and dynamic batching) and the
thread safety of its device staging, on the CPU.

The primitives are held to the JAX package's contract (its
tests/test_pipeline_parallel.py and tests/test_parallel_engine.py): ordered
and unordered stages, errors reaching the consumer unwrapped, abandoned
consumers and closed prefetches releasing their threads. The queries run in
the port at 1 and at 4 threads and in the JAX package at 4 threads over the
same numpy-seeded tables, with several morsels and chunks: ordered outputs are
compared bit for bit (tolerance 0), unordered ones (grouped output, or
``default_maintain_order=False``) as multisets of rows, also bit for bit.
"""

import contextlib
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import daft_tpu
import daft_tpu_torch
from daft_tpu.execution.executor import Executor as JExecutor
from daft_tpu_torch.ai import cuda_provider
from daft_tpu_torch.cancellation import CancelToken, cancel_scope
from daft_tpu_torch.errors import DaftCancelledError, DaftExecutionError
from daft_tpu_torch.execution import pipeline
from daft_tpu_torch.execution.executor import Executor as TExecutor
from daft_tpu_torch.execution.join_index import join_counters
from daft_tpu_torch.functions.ai import embed_image as torch_embed_image
from daft_tpu_torch.kernels import image_ops
from daft_tpu_torch.ops import device_eval as tde
from daft_tpu_torch.tools import lineitem, tpch
from daft_tpu_torch.udf import Udf

pytestmark = pytest.mark.filterwarnings("ignore:Specifying null_placement:FutureWarning")

#: Thread names of a query's stage threads: the pool, the feeders, a UDF's
#: own pool and the join's probe-side prefetch.
STAGE_THREADS = ("daft-compute", "daft-feed", "daft-udf", "daft-probe-side")


def _stage_threads(before):
    return [t for t in threading.enumerate()
            if t.ident not in before and t.is_alive() and t.name.startswith(STAGE_THREADS)]


def _wait_no_stage_threads(before, seconds: float = 10.0):
    deadline = time.monotonic() + seconds
    while time.monotonic() < deadline:
        left = _stage_threads(before)
        if not left:
            return []
        time.sleep(0.02)
    return [t.name for t in _stage_threads(before)]


# --------------------------------------------------------------------- #
# The primitives                                                         #
# --------------------------------------------------------------------- #
def test_run_stage_ordered_and_unordered():
    pool = ThreadPoolExecutor(max_workers=4)
    try:
        items = list(range(64))
        out = list(pipeline.run_stage(iter(items), lambda x: x * 2, pool=pool, workers=4))
        assert out == [x * 2 for x in items]  # order restored
        un = list(pipeline.run_stage(iter(items), lambda x: x * 2, pool=pool, workers=4,
                                     ordered=False))
        assert sorted(un) == out  # the same multiset, any order
    finally:
        pool.shutdown(wait=False)


@pytest.mark.parametrize("ordered", [True, False])
def test_run_stage_propagates_worker_error_unwrapped(ordered):
    class Boom(RuntimeError):
        pass

    def fn(x):
        if x == 13:
            raise Boom("morsel 13")
        return x

    pool = ThreadPoolExecutor(max_workers=4)
    try:
        with pytest.raises(Boom, match="morsel 13"):
            list(pipeline.run_stage(iter(range(64)), fn, pool=pool, workers=4, ordered=ordered))
    finally:
        pool.shutdown(wait=False)


def test_run_stage_child_error_reaches_consumer():
    def child():
        yield 1
        raise ValueError("child died")

    pool = ThreadPoolExecutor(max_workers=2)
    try:
        with pytest.raises(ValueError, match="child died"):
            list(pipeline.run_stage(child(), lambda x: x, pool=pool, workers=2))
    finally:
        pool.shutdown(wait=False)


def test_run_stage_abandoned_consumer_releases_feeder():
    pool = ThreadPoolExecutor(max_workers=2)
    try:
        gen = pipeline.run_stage(iter(range(10_000)), lambda x: x, pool=pool, workers=2,
                                 name="abandon-me")
        assert next(gen) == 0
        gen.close()  # a limit's shape: the upstream abandoned mid-stream
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            if not any("abandon-me" in t.name for t in threading.enumerate()):
                break
            time.sleep(0.05)
        assert not any("abandon-me" in t.name for t in threading.enumerate())
    finally:
        pool.shutdown(wait=False)


def test_prefetch_close_releases_thread():
    def slow():
        yield from range(10_000)

    p = pipeline.Prefetch(slow(), capacity=2, name="prefetch-close-test")
    p.close()  # never consumed: e.g. the join's build failed first
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline:
        if not any("prefetch-close-test" in t.name for t in threading.enumerate()):
            break
        time.sleep(0.05)
    assert not any("prefetch-close-test" in t.name for t in threading.enumerate())


def test_prefetch_yields_in_order_and_raises_at_the_failing_item():
    def src():
        yield from range(5)
        raise KeyError("upstream")

    got = []
    with pytest.raises(KeyError, match="upstream"):
        for x in pipeline.Prefetch(src(), capacity=2):
            got.append(x)
    assert got == [0, 1, 2, 3, 4]


def test_collect_parallel_keeps_item_order_and_raises_the_first_error():
    pool = ThreadPoolExecutor(max_workers=4)
    try:
        def slow_square(x):
            time.sleep(0.001 * (10 - x))  # later items finish first
            return x * x

        assert pipeline.collect_parallel(list(range(10)), slow_square, pool=pool,
                                         workers=4) == [x * x for x in range(10)]
        done = []

        def fail_on_odd(x):
            if x % 2:
                raise ValueError(f"item {x}")
            done.append(x)
            return x

        with pytest.raises(ValueError, match="item 1"):  # the first in item order
            pipeline.collect_parallel(list(range(8)), fail_on_odd, pool=pool, workers=4)
        assert sorted(done) == [0, 2, 4, 6]  # every item ran before the raise
        assert pipeline.collect_parallel([3], slow_square, pool=None, workers=4) == [9]
    finally:
        pool.shutdown(wait=False)


def test_map_stage_with_one_worker_runs_inline():
    callers = []
    out = list(pipeline.map_stage(iter(range(5)),
                                  lambda x: callers.append(threading.get_ident()) or x + 1,
                                  pool=None, workers=1))
    assert out == [1, 2, 3, 4, 5] and set(callers) == {threading.get_ident()}


def test_ordered_prefetch_map_keeps_item_order():
    def jitter(x):
        time.sleep(0.0005 * (x % 7))
        return -x

    assert list(pipeline.ordered_prefetch_map(iter(range(40)), jitter, depth=4)) == \
        [-x for x in range(40)]
    assert list(pipeline.ordered_prefetch_map(iter(range(3)), jitter, depth=1)) == [0, -1, -2]


def test_workers_inherit_the_token_and_check_it_before_a_morsel():
    seen = []
    token = CancelToken(query_id="q-inherit")
    pool = ThreadPoolExecutor(max_workers=3)
    try:
        with cancel_scope(token):
            gen = pipeline.run_stage(iter(range(6)), lambda x: seen.append(x) or x, pool=pool,
                                     workers=3)
            assert list(gen) == list(range(6))
        token.cancel("test")
        with cancel_scope(token):
            with pytest.raises(DaftCancelledError, match="q-inherit"):
                list(pipeline.run_stage(iter(range(6)), lambda x: x, pool=pool, workers=3))
    finally:
        pool.shutdown(wait=False)


# --------------------------------------------------------------------- #
# The engine on the pool                                                 #
# --------------------------------------------------------------------- #
@pytest.fixture
def big_df():
    n = 20_000
    rng = np.random.default_rng(7)
    return daft_tpu_torch.from_pydict({"k": rng.integers(0, 50, n), "v": rng.random(n),
                                       "s": [f"row{i}" for i in range(n)]})


def _chain(df):
    c = daft_tpu_torch.col
    return df.where(c("v") > 0.25).with_column("w", c("v") * 2 + 1).select("k", "w", "s")


def test_parallel_project_filter_matches_serial(big_df):
    with daft_tpu_torch.execution_config_ctx(device="cpu", num_compute_threads=1,
                                             default_morsel_size=1000):
        serial = _chain(big_df).to_pydict()
    with daft_tpu_torch.execution_config_ctx(device="cpu", num_compute_threads=4,
                                             default_morsel_size=1000):
        par = _chain(big_df).to_pydict()
    assert serial == par  # the same values in the same (input) order


def test_parallel_map_propagates_errors():
    class WorkerExploded(RuntimeError):
        pass

    def boom(x):
        raise WorkerExploded("worker exploded")

    df = daft_tpu_torch.from_pydict({"a": [1, 2, 0, 4] * 500})
    for conc in (1, 3):
        udf = Udf(boom, daft_tpu_torch.DataType.int64(), batch=True, max_concurrency=conc)
        with daft_tpu_torch.execution_config_ctx(device="cpu", num_compute_threads=4,
                                                 default_morsel_size=100,
                                                 udf_dynamic_batching=False):
            # The UDF's own error after its attempts, as in the JAX package,
            # never wrapped again by the stage: its cause is the worker's.
            with pytest.raises(DaftExecutionError, match="'boom' failed after 1 attempts: "
                               "worker exploded") as info:
                df.with_column("b", udf(daft_tpu_torch.col("a"))).collect()
            assert type(info.value.__cause__) is WorkerExploded


def test_parallel_map_early_close_releases_feeder(big_df):
    before = {t.ident for t in threading.enumerate()}
    with daft_tpu_torch.execution_config_ctx(device="cpu", num_compute_threads=4,
                                             default_morsel_size=500):
        out = _chain(big_df).limit(5).to_pydict()
    assert len(out["k"]) == 5
    assert _wait_no_stage_threads(before) == []


def test_maintain_order_false_gives_the_same_multiset(big_df):
    with daft_tpu_torch.execution_config_ctx(device="cpu", num_compute_threads=1,
                                             default_morsel_size=1000):
        serial = _chain(big_df).to_pydict()
    with daft_tpu_torch.execution_config_ctx(device="cpu", num_compute_threads=4,
                                             default_morsel_size=1000,
                                             default_maintain_order=False):
        par = _chain(big_df).to_pydict()
    assert sorted(zip(*serial.values())) == sorted(zip(*par.values()))


def test_stages_run_on_the_pool(big_df, monkeypatch):
    """At 4 threads the chain's morsels run on the compute pool's threads;
    at 1 thread on the consumer's."""
    names = set()
    real = TExecutor._node_kernel

    def spy(nd):
        kern = real(nd)

        def run(mp):
            names.add(threading.current_thread().name.split("_")[0])
            return kern(mp)

        return run

    monkeypatch.setattr(TExecutor, "_node_kernel", staticmethod(spy))
    for threads, want in ((4, {"daft-compute"}), (1, {threading.current_thread().name})):
        names.clear()
        with daft_tpu_torch.execution_config_ctx(device="cpu", num_compute_threads=threads,
                                                 default_morsel_size=1000, device_eval=False,
                                                 compiled_eval_enabled=False):
            _chain(big_df).to_pydict()
        assert names == want


# --------------------------------------------------------------------- #
# Determinism: the port at 1 and 4 threads, the JAX package at 4         #
# --------------------------------------------------------------------- #
@contextlib.contextmanager
def _small_chunks(monkeypatch, threads: int, **cfg):
    """Morsels of 4096 rows and chunks of 8192+ in both packages: several
    morsels and chunks on small tables."""
    for cls in (JExecutor, TExecutor):
        monkeypatch.setattr(cls, "AGG_CHUNK_ROWS", 8192)
    with daft_tpu.execution_config_ctx(result_cache_enabled=False, num_compute_threads=4,
                                       default_morsel_size=4096, min_morsel_size=4096), \
            daft_tpu_torch.execution_config_ctx(device="cpu", num_compute_threads=threads,
                                                default_morsel_size=4096, **cfg):
        yield


@pytest.fixture(scope="module")
def li_cols():
    return lineitem.lineitem_columns(40_000, seed=3)


@pytest.fixture(scope="module")
def tables():
    return tpch.tpch_tables(0.004, seed=1)


def _q01(pkg, cols):
    return lineitem.sorted_groups(lineitem.q01(pkg, pkg.from_pydict(cols)).to_pydict())


def _q06(pkg, cols):
    return lineitem.q06(pkg, pkg.from_pydict(cols)).to_pydict()


def _q03(pkg, t):
    f = {n: pkg.from_pydict({c: t[n][c] for c in cs}) for n, cs in tpch.Q03_COLUMNS.items()}
    return tpch.q03(pkg, f["customer"], f["orders"], f["lineitem"]).to_pydict()


def _partitioned(pkg, cols):
    c = pkg.col
    out = (pkg.from_pydict({k: cols[k] for k in ("l_shipdate", "l_partkey", "l_quantity")})
           .where(c("l_shipdate") <= lineitem.Q01_SHIPDATE_MAX).groupby("l_partkey")
           .agg(c("l_quantity").sum().alias("sum_qty"), c("l_quantity").count().alias("n"))
           .to_pydict())
    return sorted(zip(*out.values()))  # grouped output order is unspecified


def _probe(pkg, t):
    """An inner join whose index probe streams lineitem's morsels (the larger
    side written on the left, so both packages build on orders)."""
    c = pkg.col
    li = pkg.from_pydict({k: t["lineitem"][k] for k in ("l_orderkey", "l_extendedprice")})
    o = pkg.from_pydict({k: t["orders"][k] for k in ("o_orderkey", "o_orderdate")})
    return (li.join(o, left_on="l_orderkey", right_on="o_orderkey")
            .with_column("x", c("l_extendedprice") * 2).to_pydict())


def _concurrent_udf(pkg, cols):
    def triple(s):
        return s.to_numpy().astype(np.int64) * 3 + 1

    if pkg is daft_tpu:
        udf = daft_tpu.udf.Udf(triple, daft_tpu.DataType.int64(), batch=True, max_concurrency=3)
    else:
        udf = Udf(triple, daft_tpu_torch.DataType.int64(), batch=True, max_concurrency=3)
    df = pkg.from_pydict({"k": cols["l_partkey"]})
    return df.with_column("t", udf(pkg.col("k"))).to_pydict()


QUERIES = {"q01": (_q01, "li"), "q06": (_q06, "li"), "q03": (_q03, "tpch"),
           "partitioned": (_partitioned, "li"), "join_probe": (_probe, "tpch"),
           "udf_max_concurrency_3": (_concurrent_udf, "li")}


@pytest.mark.parametrize("name", list(QUERIES))
def test_port_at_1_and_4_threads_equals_the_jax_package_at_4(name, monkeypatch, li_cols, tables):
    run, data = QUERIES[name]
    arg = li_cols if data == "li" else tables
    outs = {}
    for threads in (1, 4):
        with _small_chunks(monkeypatch, threads):
            outs[threads] = run(daft_tpu_torch, arg)
            if threads == 4:
                outs["jax"] = run(daft_tpu, arg)
    assert outs[1] == outs[4]  # bit for bit, in order
    assert outs[4] == outs["jax"]


def test_partitioned_query_takes_the_pool_and_counts_its_buckets(monkeypatch, li_cols):
    calls = []
    real = TExecutor._partitioned_agg

    def spy(self, *args, **kwargs):
        calls.append(self.compute_threads)
        return real(self, *args, **kwargs)

    monkeypatch.setattr(TExecutor, "_partitioned_agg", spy)
    for threads in (1, 4):
        with _small_chunks(monkeypatch, threads):
            _partitioned(daft_tpu_torch, li_cols)
    assert calls == [1, 4]


def test_join_probe_counters_match_across_thread_counts(monkeypatch, tables):
    snaps = []
    for threads in (1, 4):
        join_counters.reset()
        with _small_chunks(monkeypatch, threads):
            _q03(daft_tpu_torch, tables)
        snaps.append(join_counters.snapshot())
    assert snaps[0] == snaps[1]
    assert [list(j["routes"]) for j in snaps[0]] == [["dense"], ["dense"]]
    assert snaps[0][1]["routes"]["dense"]["morsels"] > 1  # the probe spread over morsels


def test_embed_image_with_max_concurrency_2_equals_one_at_a_time():
    """The tiny CLIP tower on the CPU: three UDF morsels of 16 rows, two at a
    time on the UDF's own pool sharing one instance, equal one at a time bit
    for bit; each call's stats stay whole."""
    imgs = np.random.default_rng(0).integers(0, 256, (45, 32 * 32 * 3), dtype=np.uint8)
    series = daft_tpu_torch.Series.from_numpy(imgs, "img",
                                              daft_tpu_torch.DataType.image("RGB", 32, 32))
    df = daft_tpu_torch.from_pydict({"img": series})
    outs = []
    for conc in (1, 2):
        expr = torch_embed_image(daft_tpu_torch.col("img"), provider="cuda_random", model="tiny",
                                 batch_size=4, device="cpu", max_concurrency=conc)
        assert expr._expr.udf.max_concurrency == conc
        with daft_tpu_torch.execution_config_ctx(device="cpu", default_morsel_size=16):
            outs.append(np.asarray(df.with_column("e", expr).to_pydict()["e"], np.float32))
        stats = expr._expr.udf._get_instance().last_forward_stats
        assert (stats["rows"], stats["chunks"]) in ((16, 4), (13, 4))
    np.testing.assert_array_equal(outs[0], outs[1])


def test_udf_concurrency_options():
    udf = Udf(lambda s: s, daft_tpu_torch.DataType.int64(), batch=True, batch_size=8)
    two = udf.with_concurrency(2)
    assert (udf.max_concurrency, two.max_concurrency, two.batch_size) == (None, 2, 8)
    other = two.override_options(batch_size=None, max_concurrency=4)
    assert (other.batch_size, other.max_concurrency, two.batch_size) == (None, 4, 8)


# --------------------------------------------------------------------- #
# Thread safety of the staging                                           #
# --------------------------------------------------------------------- #
def test_pinned_sets_are_per_morsel_in_flight(monkeypatch):
    """Two threads staging at once get distinct buffers; a set given back
    after the fetch is reused, so the bytes held stay at the sets in flight
    at once times the largest morsel."""
    pinned = tde._Pinned(pin_memory=False)
    monkeypatch.setattr(tde, "_PINNED", pinned)
    f32 = np.dtype(np.float32)
    got, barrier = {}, threading.Barrier(2)

    def stage(name, rows):
        got[name] = pinned.get("a", (rows,), f32)
        barrier.wait(timeout=5)  # both hold a set at once
        assert pinned.holding()
        barrier.wait(timeout=5)
        pinned.release()
        assert not pinned.holding()

    threads = [threading.Thread(target=stage, args=(n, r)) for n, r in (("x", 1024), ("y", 512))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()
    assert got["x"].data_ptr() != got["y"].data_ptr()
    assert tde.pinned_bytes() == 1024 * 4 + 512 * 4
    pinned.get("a", (256,), f32)  # a later morsel takes a free set
    pinned.release()
    assert tde.pinned_bytes() == 1024 * 4 + 512 * 4
    tde.reset_programs()
    assert tde.pinned_bytes() == 0


def test_pinned_sets_under_contention(monkeypatch):
    """Stress: 16 threads (more than the cores) stage and release 200 times
    each with a short switch interval; no two threads ever hold one buffer."""
    pinned = tde._Pinned(pin_memory=False)
    monkeypatch.setattr(tde, "_PINNED", pinned)
    f32 = np.dtype(np.float32)
    owners, lock, errors = {}, threading.Lock(), []

    def worker(i):
        for _ in range(200):
            buf = pinned.get("a", (64,), f32)
            with lock:
                if owners.get(buf.data_ptr()) is not None:
                    errors.append(buf.data_ptr())
                owners[buf.data_ptr()] = i
            buf.fill_(i)
            time.sleep(0)
            if not bool((buf == i).all()):
                errors.append(i)
            with lock:
                owners[buf.data_ptr()] = None
            pinned.release()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert errors == []
    assert tde.pinned_bytes() <= 16 * 64 * 4


class _FakeEvent:
    def __init__(self, t):
        self.t = t

    def elapsed_time(self, other):
        return other.t - self.t


def test_phase_timer_keeps_each_threads_events():
    """Morsels interleaved across threads: each thread settles its own four
    events (a shared list would hand one thread's events to another and drop
    both morsels)."""
    timer = tde.PhaseTimer()
    timer.enabled = True
    a_started, b_done = threading.Event(), threading.Event()

    def thread_a():
        timer._events().extend([_FakeEvent(0.0), _FakeEvent(1.0)])
        a_started.set()
        assert b_done.wait(timeout=5)
        timer._events().extend([_FakeEvent(3.0), _FakeEvent(6.0)])
        timer.settle()

    def thread_b():
        assert a_started.wait(timeout=5)
        timer._events().extend([_FakeEvent(t) for t in (0.0, 10.0, 30.0, 60.0)])
        timer.settle()
        b_done.set()

    threads = [threading.Thread(target=thread_a), threading.Thread(target=thread_b)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()
    assert timer.totals["h2d_ms"] == 1.0 + 10.0
    assert timer.totals["device_ms"] == 2.0 + 20.0
    assert timer.totals["d2h_ms"] == 3.0 + 30.0


def test_stager_state_is_per_thread():
    stager = cuda_provider._Stager(torch.device("cpu"))
    mine = stager._thread_state()
    assert stager._thread_state() is mine
    other = []
    t = threading.Thread(target=lambda: other.append(stager._thread_state()))
    t.start()
    t.join(timeout=5)
    assert len(other) == 1 and other[0] is not mine


def test_tf32_guard_holds_while_any_resize_is_inside():
    """Two interleaved holders: the flag stays off until the last one
    leaves, then the caller's True comes back."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        a_in, b_in, a_out = threading.Event(), threading.Event(), threading.Event()
        seen = []

        def holder_a():
            with image_ops._tf32_off():
                a_in.set()
                assert b_in.wait(timeout=5)
            a_out.set()

        def holder_b():
            assert a_in.wait(timeout=5)
            with image_ops._tf32_off():
                b_in.set()
                assert a_out.wait(timeout=5)
                seen.append(torch.backends.cuda.matmul.allow_tf32)  # A has left
            seen.append(torch.backends.cuda.matmul.allow_tf32)  # both have left

        threads = [threading.Thread(target=holder_a), threading.Thread(target=holder_b)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
            assert not t.is_alive()
        assert seen == [False, True]
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def test_overlapping_resizes_equal_the_serial_one():
    """The fixed-shape resize from four threads at once equals one call,
    bit for bit, with the caller's TF32 flag back on after."""
    batch = np.random.default_rng(5).integers(0, 256, (8, 48, 40, 3), dtype=np.uint8)
    prev = torch.backends.cuda.matmul.allow_tf32
    try:
        with daft_tpu_torch.execution_config_ctx(device="cpu"):
            want = image_ops._batch_resize(batch, 32, 24).numpy()
            torch.backends.cuda.matmul.allow_tf32 = True
            pool = ThreadPoolExecutor(max_workers=4)
            try:
                outs = pipeline.collect_parallel(
                    [batch] * 8, lambda b: image_ops._batch_resize(b, 32, 24).numpy(), pool=pool,
                    workers=4)
            finally:
                pool.shutdown(wait=True)
        assert all(np.array_equal(o, want) for o in outs)
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


# --------------------------------------------------------------------- #
# Dynamic batching (ported from tests/test_dynamic_batching.py)          #
# --------------------------------------------------------------------- #
from daft_tpu_torch.execution.dynamic_batching import (  # noqa: E402
    LatencyConstrainedBatching,
    StaticBatching,
    dynamic_remorsel,
)
from daft_tpu_torch.micropartition import MicroPartition  # noqa: E402


def test_contracts_when_too_slow():
    st = LatencyConstrainedBatching(target_latency_s=0.1, tolerance_s=0.01, alpha=64,
                                    delta=8).make_state()
    start = st.next_batch_size()
    for _ in range(20):
        st.record(st.next_batch_size(), 0.5)  # 5x over target
    assert st.next_batch_size() < max(start, 128)
    assert st.b_low >= 1


def test_expands_when_fast():
    st = LatencyConstrainedBatching(target_latency_s=0.1, tolerance_s=0.01, alpha=64, delta=8,
                                    b_max=10_000).make_state()
    sizes = []
    for _ in range(30):
        b = st.next_batch_size()
        sizes.append(b)
        st.record(b, 0.001)  # far below target
    assert sizes[-1] > sizes[0]


def test_converges_within_band():
    """Latency proportional to the batch size: converges near the size whose
    latency meets the target (about 100 rows), then stays."""
    st = LatencyConstrainedBatching(target_latency_s=0.1, tolerance_s=0.01, alpha=32, delta=4,
                                    b_max=100_000).make_state()
    for _ in range(200):
        b = st.next_batch_size()
        st.record(b, b * 0.001)
    final = st.next_batch_size()
    assert 50 <= final <= 200, f"converged to {final}, expected ~100"


def test_static_strategy_fixed():
    st = StaticBatching(42).make_state()
    st.record(42, 99.0)
    assert st.next_batch_size() == 42


def test_converges_below_alpha_for_slow_udfs():
    """A per-row cost far above target/alpha: the batch falls below alpha/2."""
    st = LatencyConstrainedBatching(target_latency_s=0.2, tolerance_s=0.02, alpha=64,
                                    delta=8).make_state()
    for _ in range(100):
        b = st.next_batch_size()
        st.record(b, b * 0.05)  # ideal batch = 4
    final = st.next_batch_size()
    assert final <= 8, f"stuck at {final}; latency would be {final * 0.05:.2f}s"


def test_dynamic_remorsel_respects_state():
    class FixedState:
        def __init__(self, n):
            self.n = n

        def next_batch_size(self):
            return self.n

        def record(self, *a):
            pass

    parts = [MicroPartition.from_pydict({"x": list(range(i * 10, i * 10 + 10))})
             for i in range(5)]
    out = list(dynamic_remorsel(iter(parts), FixedState(7)))
    assert [len(m) for m in out] == [7, 7, 7, 7, 7, 7, 7, 1]
    assert [v for m in out for v in m.to_pydict()["x"]] == list(range(50))  # order kept


def test_host_udf_runs_under_dynamic_batching():
    """A host batch UDF without a batch_size sees several (varying) batch
    sizes and gives exact results."""
    seen = []

    def f(x):
        seen.append(len(x))
        time.sleep(0.001)
        return daft_tpu_torch.Series.from_numpy(x.to_numpy() * 2, "y")

    udf = Udf(f, daft_tpu_torch.DataType.int64(), batch=True)
    df = daft_tpu_torch.from_pydict({"x": list(range(2000))})
    with daft_tpu_torch.execution_config_ctx(device="cpu", udf_dynamic_batching=True,
                                             udf_target_batch_latency_s=0.005):
        out = df.with_column("y", udf(daft_tpu_torch.col("x"))).to_pydict()
    assert out["y"] == [v * 2 for v in range(2000)]
    assert len(seen) > 1, "expected several dynamic batches"


def test_dynamic_batching_can_be_disabled():
    sizes = []

    def g(x):
        sizes.append(len(x))
        return x

    udf = Udf(g, daft_tpu_torch.DataType.int64(), batch=True)
    df = daft_tpu_torch.from_pydict({"x": list(range(500))})
    with daft_tpu_torch.execution_config_ctx(device="cpu", udf_dynamic_batching=False,
                                             default_morsel_size=100):
        df.with_column("y", udf(daft_tpu_torch.col("x"))).collect()
    assert sizes == [100] * 5


def test_a_batch_size_keeps_fixed_morsels_of_16_batches():
    sizes = []

    def g(x):
        sizes.append(len(x))
        return x

    udf = Udf(g, daft_tpu_torch.DataType.int64(), batch=True, batch_size=8)
    df = daft_tpu_torch.from_pydict({"x": list(range(300))})
    with daft_tpu_torch.execution_config_ctx(device="cpu", udf_dynamic_batching=True):
        df.with_column("y", udf(daft_tpu_torch.col("x"))).collect()
    assert sizes == [128, 128, 44]
