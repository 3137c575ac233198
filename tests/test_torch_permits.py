"""The memory manager's byte permits in the port
(``daft_tpu_torch/execution/resource_manager.py`` and the executor's
``_add_held``), on the CPU, beside the JAX package's.

Mirrors the three MemoryManager cases of ``tests/test_admission.py`` (a waiter
poisoned mid-acquire, a late acquire after the executor unwound, a cancelled
query under a limit; without the admission ticket, which the port does not
have) and adds poison scoped by query, the cancel token waking a waiter, and
the clamp of an oversized request. Each unit case runs the same steps on both
packages' managers and asserts the same outcome. Waits are bounded; the
timing bounds are loose and stated where asserted.
"""

import threading
import time

import pytest

import daft_tpu
import daft_tpu_torch
from daft_tpu.cancellation import CancelToken as JCancelToken
from daft_tpu.execution import resource_manager as jrm
from daft_tpu_torch.cancellation import CancelToken
from daft_tpu_torch.errors import DaftCancelledError, DaftTimeoutError
from daft_tpu_torch.execution import resource_manager as trm
from daft_tpu_torch.execution.executor import Executor
from daft_tpu_torch.execution.memledger import get_ledger
from daft_tpu_torch.physical.translate import translate
from daft_tpu_torch.udf import Udf

PACKAGES = {"jax": (jrm, JCancelToken), "port": (trm, CancelToken)}


def _wait_until(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return cond()


def _blocked_acquire(mm, nbytes, token, result, key):
    def run():
        try:
            result[key] = mm.acquire(nbytes, token=token)
        except BaseException as e:  # noqa: BLE001 — recorded for the asserts
            result[key] = e

    th = threading.Thread(target=run)
    th.start()
    return th


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_poison_mid_acquire_returns_to_baseline(pkg):
    rm, Token = PACKAGES[pkg]
    with rm.memory_limit(1 << 16) as mm:
        baseline = mm.available_permits()
        assert baseline == 1 << 16
        assert mm.acquire(1 << 15)  # the holder: half the budget
        result = {}
        th = _blocked_acquire(mm, 3 << 14, Token(None, query_id="poisoned"), result, "w")
        time.sleep(0.1)  # let it enter the wait
        mm.poison(RuntimeError("query died"), query_id="poisoned")
        th.join(timeout=10)
        assert not th.is_alive()
        assert isinstance(result.get("w"), RuntimeError)
        mm.release(1 << 15)
        assert mm.available_permits() == baseline


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_poison_reaches_only_the_failed_querys_waiters(pkg):
    rm, Token = PACKAGES[pkg]
    with rm.memory_limit(1 << 16) as mm:
        assert mm.acquire(1 << 15)
        result = {}
        failed = _blocked_acquire(mm, 3 << 14, Token(None, query_id="a"), result, "a")
        healthy = _blocked_acquire(mm, 3 << 14, Token(None, query_id="b"), result, "b")
        time.sleep(0.1)
        mm.poison(RuntimeError("query a died"), query_id="a")
        failed.join(timeout=10)
        assert isinstance(result.get("a"), RuntimeError)
        time.sleep(0.1)
        assert healthy.is_alive() and "b" not in result  # still waiting, not poisoned
        mm.release(1 << 15)  # the holder lets go: b's request now fits
        healthy.join(timeout=10)
        assert result.get("b") is True
        mm.release(3 << 14)
        assert mm.available_permits() == 1 << 16


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_cancel_wakes_a_waiter_and_oversized_requests_clamp(pkg):
    rm, Token = PACKAGES[pkg]
    with rm.memory_limit(1 << 16) as mm:
        assert mm.acquire(1 << 20)  # larger than the limit: clamped to it
        assert mm.available_permits() == 0
        token = Token(None, query_id="c")
        result = {}
        t0 = time.monotonic()
        th = _blocked_acquire(mm, 1 << 10, token, result, "c")
        time.sleep(0.1)
        token.cancel()
        th.join(timeout=10)
        assert result.get("c") is False
        assert time.monotonic() - t0 < 5.0  # woken by the cancel, not a timeout
        assert mm.acquire(1, timeout=0.05) is False  # a plain timeout
        mm.release(1 << 20)
        assert mm.available_permits() == 1 << 16


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_no_limit_grants_everything_and_the_scope_restores(pkg):
    rm, _ = PACKAGES[pkg]
    mm = rm.get_memory_manager()
    old = mm.limit
    with rm.memory_limit(None) as inner:
        assert inner is mm
        assert mm.acquire(1 << 40) and mm.available_permits() is None
        mm.release(1 << 40)
    with rm.memory_limit(123):
        assert mm.limit == 123
    assert mm.limit == old


def test_late_acquire_after_executor_unwind_self_releases():
    """An acquire that lands after the executor's teardown drained its
    permits hands the permit straight back and charges nothing."""
    led = get_ledger()
    with daft_tpu_torch.execution_config_ctx(device="cpu"):
        with trm.memory_limit(1 << 16) as mm:
            baseline = mm.available_permits()
            cfg = daft_tpu_torch.context.get_context().execution_config
            ex = Executor(cfg, cancel_token=CancelToken(query_id="late"))
            plan = translate(daft_tpu_torch.from_pydict({"a": [1, 2, 3]})._builder.optimize().plan)
            assert list(ex.run(plan))
            assert mm.acquire(1 << 10)
            ex._add_held(1 << 10, op="Sort")  # the racing side thread
            assert mm.available_permits() == baseline
    assert led.audit().get("late") is None


def test_cancelled_collect_under_a_limit_leaves_no_permit_state():
    """A query cut by its deadline mid-execution under a memory limit unwinds
    with every permit back and the ledger at zero."""
    def slow(s):
        time.sleep(0.1)
        return s

    udf = Udf(slow, daft_tpu_torch.DataType.int64(), batch=True)
    df = daft_tpu_torch.from_pydict({"a": list(range(2000))})
    # Morsels of 100 rows, 0.1 s each: 2 s of work against a 0.3 s deadline.
    with daft_tpu_torch.execution_config_ctx(device="cpu", udf_dynamic_batching=False,
                                             default_morsel_size=100):
        with trm.memory_limit(1 << 20) as mm:
            baseline = mm.available_permits()
            with pytest.raises((DaftTimeoutError, DaftCancelledError)):
                df.with_column("b", udf(daft_tpu_torch.col("a"))).sort("a").collect(timeout=0.3)
            assert _wait_until(lambda: mm.available_permits() == baseline)
    assert _wait_until(lambda: get_ledger().total_held() == 0), get_ledger().audit()


@pytest.mark.parametrize("how", ["sort", "cross"])
def test_sinks_under_a_loose_limit_hold_permits_and_return_them(how):
    """Under a limit far above the input, a sort reserves its budget and a
    cross join collects its right side under permits (``_collect``): each
    holds permits while it runs, spills nothing, returns every permit when
    the query ends and gives the JAX package's rows under the same limit."""
    from daft_tpu.execution.spill import spill_metrics as jspill
    from daft_tpu_torch.execution.spill import spill_metrics as tspill

    data = {"k": [(i * 7) % 97 for i in range(3000)], "v": [float(i) for i in range(3000)]}
    other = {"w": [1, 2, 3]}

    def query(pkg):
        df = pkg.from_pydict(data)
        return df.sort("k") if how == "sort" else df.cross_join(pkg.from_pydict(other))

    with daft_tpu.execution_config_ctx(result_cache_enabled=False), \
            jrm.memory_limit(1 << 30):
        jspill.reset()
        jax = query(daft_tpu).to_pydict()
        assert jspill.snapshot()["spills"] == 0
    with daft_tpu_torch.execution_config_ctx(device="cpu"):
        with trm.memory_limit(1 << 30) as mm:
            tspill.reset()
            df = query(daft_tpu_torch)
            port = df.to_pydict()
            assert mm.available_permits() == 1 << 30
            assert tspill.snapshot()["spills"] == 0
    assert port == jax
    mem = get_ledger().profile_for(df.query_id)
    assert mem["residual_bytes"] == 0 and get_ledger().total_held() == 0
    op = "Sort" if how == "sort" else "CrossJoin"
    assert mem["by_operator"][op]["kinds"]["permit"]["peak"] > 0
