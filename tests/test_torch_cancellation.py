"""Deadlines and cooperative cancellation in the port
(daft_tpu_torch/cancellation.py and its use by the executor and the
DataFrame), on the CPU; ported from the in-process parts of
tests/test_cancellation.py and tests/test_pipeline_parallel.py.

Timing bounds are loose upper bounds on the CPU (a query cut at a morsel
boundary must end within seconds, not run to its end); each is stated where
it is asserted.
"""

import threading
import time

import numpy as np
import pytest

import daft_tpu_torch
from daft_tpu_torch.cancellation import (
    CancelToken,
    Deadline,
    active_query_token,
    cancel_query,
    cancel_scope,
    check_current,
    current_token,
    iter_with_cancel_scope,
)
from daft_tpu_torch.errors import DaftCancelledError, DaftTimeoutError
from daft_tpu_torch.udf import Udf

STAGE_THREADS = ("daft-compute", "daft-feed", "daft-udf", "daft-probe-side")


def _leaked(before, seconds: float = 10.0):
    deadline = time.monotonic() + seconds
    while True:
        left = [t.name for t in threading.enumerate()
                if t.ident not in before and t.is_alive() and t.name.startswith(STAGE_THREADS)]
        if not left or time.monotonic() > deadline:
            return left
        time.sleep(0.02)


def test_deadline_is_monotonic():
    d = Deadline.after(10.0)
    assert 9.0 < d.remaining() <= 10.0
    assert not d.expired()
    assert Deadline.after(-1.0).expired()


def test_cancel_token_cancel_and_deadline_errors():
    tok = CancelToken(query_id="q1")
    assert tok.error() is None
    tok.check()  # live: no-op
    tok.cancel("user-cancel")
    assert tok.cancelled() and tok.reason == "user-cancel"
    with pytest.raises(DaftCancelledError, match="user-cancel"):
        tok.check("unit test")
    tok2 = CancelToken(Deadline.after(-0.1), query_id="q2")
    with pytest.raises(DaftTimeoutError, match="deadline"):
        tok2.check()
    assert tok2.remaining() == 0.0


def test_cancel_token_listeners_and_interruptible_wait():
    tok = CancelToken()
    fired = []
    tok.add_listener(lambda: fired.append(1))
    t = threading.Timer(0.1, tok.cancel)
    t.start()
    t0 = time.monotonic()
    assert tok.wait(5.0)  # woken early by the cancel, not the timeout
    assert time.monotonic() - t0 < 2.0
    assert fired == [1]
    tok.add_listener(lambda: fired.append(2))  # a late listener fires at once
    assert fired == [1, 2]


def test_cancel_scope_is_ambient():
    assert current_token() is None
    tok = CancelToken()
    with cancel_scope(tok):
        assert current_token() is tok
        check_current()
    assert current_token() is None


def test_iter_with_cancel_scope_sets_the_token_per_resumption():
    tok = CancelToken(query_id="a")
    seen = []

    def gen():
        for i in range(3):
            seen.append(current_token())
            yield i

    it = iter_with_cancel_scope(gen(), tok)
    assert next(it) == 0
    assert current_token() is None  # not leaked between pulls
    assert list(it) == [1, 2]
    assert seen == [tok, tok, tok]
    tok.cancel()
    with pytest.raises(DaftCancelledError):
        next(iter_with_cancel_scope(gen(), tok))


def test_collect_timeout_raises_at_a_morsel_boundary():
    def slow(s):
        time.sleep(0.4)
        return s

    udf = Udf(slow, daft_tpu_torch.DataType.int64())
    parts = [daft_tpu_torch.from_pydict({"x": list(range(i, i + 3))}) for i in (0, 3, 6)]
    df = parts[0].concat(parts[1]).concat(parts[2]).select(udf(daft_tpu_torch.col("x")))
    t0 = time.monotonic()
    with daft_tpu_torch.execution_config_ctx(device="cpu"):
        with pytest.raises(DaftTimeoutError):
            df.collect(timeout=0.5)
    assert time.monotonic() - t0 < 5.0  # 0.5 s and one 0.4 s morsel, with slack


def test_query_timeout_s_applies_without_a_timeout_argument():
    def slow(s):
        time.sleep(0.3)
        return s

    udf = Udf(slow, daft_tpu_torch.DataType.int64())
    df = daft_tpu_torch.from_pydict({"x": list(range(20))}).select(udf(daft_tpu_torch.col("x")))
    with daft_tpu_torch.execution_config_ctx(device="cpu", query_timeout_s=0.2,
                                             udf_dynamic_batching=False, default_morsel_size=2):
        with pytest.raises(DaftTimeoutError):
            list(df.iter_partitions())
    # A generous budget is no limit.
    assert daft_tpu_torch.from_pydict({"x": [1]}).collect(timeout=300.0).to_pydict() == {"x": [1]}


def test_cancel_query_by_id():
    """Another thread cancels a running query by its id: the query fails with
    DaftCancelledError at the next morsel, and its token is unregistered."""
    started = threading.Event()

    def slow(s):
        started.set()
        time.sleep(0.05)
        return s

    udf = Udf(slow, daft_tpu_torch.DataType.int64())
    df = daft_tpu_torch.from_pydict({"x": list(range(400))}).select(udf(daft_tpu_torch.col("x")))

    def cancel_soon():
        assert started.wait(10.0)
        assert cancel_query(df.query_id, reason="operator-abort")

    t = threading.Thread(target=cancel_soon)
    t.start()
    with daft_tpu_torch.execution_config_ctx(device="cpu", udf_dynamic_batching=False,
                                             default_morsel_size=4):
        with pytest.raises(DaftCancelledError, match="operator-abort") as ei:
            df.collect()
    t.join(timeout=10)
    assert not t.is_alive()
    assert not isinstance(ei.value, DaftTimeoutError)
    assert active_query_token(df.query_id) is None
    assert not cancel_query(df.query_id)


@pytest.mark.parametrize("concurrency", [1, 3])
def test_cancel_mid_pipeline_unwinds_stage_workers(concurrency):
    """A deadline while stage workers are mid-morsel: the collect fails with
    the timeout error, every pool, feeder and UDF thread of the query ends,
    and the next query runs cleanly."""
    def slow(s):
        time.sleep(0.0008 * len(s))  # about 0.2 s per 256-row morsel
        return s

    udf = Udf(slow, daft_tpu_torch.DataType.int64(), max_concurrency=concurrency)
    n = 32_000
    c = daft_tpu_torch.col
    df = daft_tpu_torch.from_pydict({"a": np.arange(n, dtype=np.int64)})
    before = {t.ident for t in threading.enumerate()}
    t0 = time.monotonic()
    with daft_tpu_torch.execution_config_ctx(device="cpu", num_compute_threads=4,
                                             default_morsel_size=256,
                                             udf_dynamic_batching=False):
        with pytest.raises(DaftTimeoutError):
            (df.with_column("b", udf(c("a"))).where(c("b") >= 0)
             .groupby("a").agg(c("b").sum().alias("s")).collect(timeout=0.6))
    assert time.monotonic() - t0 < 10.0  # uncancelled it would take about 25 s
    assert _leaked(before) == []
    with daft_tpu_torch.execution_config_ctx(device="cpu", num_compute_threads=4,
                                             default_morsel_size=1024):
        out = df.where(c("a") < 1000).groupby("a").agg(c("a").count().alias("n")).to_pydict()
    assert len(out["a"]) == 1000


def test_join_probe_cancelled_mid_stream_unwinds_the_prefetch():
    def slow(s):
        time.sleep(0.05)
        return s

    c = daft_tpu_torch.col
    udf = Udf(slow, daft_tpu_torch.DataType.int64())
    left = daft_tpu_torch.from_pydict({"k": np.arange(20_000) % 50}).with_column("k2", udf(c("k")))
    right = daft_tpu_torch.from_pydict({"k2": np.arange(50), "w": np.arange(50) * 2})
    before = {t.ident for t in threading.enumerate()}
    with daft_tpu_torch.execution_config_ctx(device="cpu", num_compute_threads=4,
                                             default_morsel_size=64,
                                             udf_dynamic_batching=False):
        with pytest.raises(DaftTimeoutError):
            left.join(right, on="k2").collect(timeout=0.5)
    assert _leaked(before) == []
