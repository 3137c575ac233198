"""The admission front door in the port (``daft_tpu_torch/execution/admission.py``
and ``runners/runner.py::enter_front_door``) beside the JAX package's, on the
CPU with ``device="cpu"``.

Mirrors ``tests/test_admission.py`` case for case, less
``test_enqueue_fault_point_leaks_no_slot``: the fault point
``admission.enqueue`` and the fault machinery are ROADMAP A.8.5. Where a case
drives the controller directly, the same sequence runs through both
packages' controllers and gives the same admits, queue positions, rejection
reasons, shed levels and ``retry_after_s`` (exactly: each estimate is taken
before any ticket's duration moves the controller's average). The rejection
latency case runs on the port alone, with the JAX case's bound (p99 under
0.1 s). The runner cases go through ``collect()`` on the port's native
runner. Beyond the JAX file: a UDF that collects inside a query of a
one-slot tenant finishes (the nested query rides its parent's slot), and the
result cache charges a tenant set on the calling thread at 4 stage workers.
"""

import threading
import time
from types import SimpleNamespace

import pytest

import daft_tpu
import daft_tpu_torch
from daft_tpu import cancellation as jcancel
from daft_tpu import config as jconfig
from daft_tpu import errors as jerrors
from daft_tpu import metrics as jmetrics
from daft_tpu.execution import admission as jadm
from daft_tpu.execution import resource_manager as jrm
from daft_tpu_torch import cancellation as tcancel
from daft_tpu_torch import col
from daft_tpu_torch import config as tconfig
from daft_tpu_torch import errors as terrors
from daft_tpu_torch import metrics as tmetrics
from daft_tpu_torch.context import execution_config_ctx
from daft_tpu_torch.execution import admission as tadm
from daft_tpu_torch.execution import resource_manager as trm
from daft_tpu_torch.execution.admission import get_controller, set_tenant

JAX = SimpleNamespace(adm=jadm, cancel=jcancel, cfg=jconfig.ExecutionConfig, err=jerrors,
                      metrics=jmetrics, rm=jrm, pkg=daft_tpu)
PORT = SimpleNamespace(adm=tadm, cancel=tcancel, cfg=tconfig.ExecutionConfig, err=terrors,
                       metrics=tmetrics, rm=trm, pkg=daft_tpu_torch)
BOTH = (JAX, PORT)


@pytest.fixture(autouse=True)
def _clean_admission():
    """Both packages' process controllers and tenants fresh per test; the
    port's queries on the CPU."""
    for p in BOTH:
        p.adm.get_controller().reset()
        p.adm.set_tenant(None)
    with execution_config_ctx(device="cpu"):
        yield
    for p in BOTH:
        p.adm.get_controller().reset()
        p.adm.set_tenant(None)


def _cfg(p, **kw):
    return p.cfg().with_changes(**kw)


def _token(p, timeout_s=None, query_id="q"):
    return p.cancel.CancelToken(
        p.cancel.Deadline.after(timeout_s) if timeout_s is not None else None,
        query_id=query_id)


def _wait_queued(ctl, tenant, n, seconds=5.0):
    deadline = time.monotonic() + seconds
    while ctl.snapshot().get(tenant, {}).get("queued", 0) < n \
            and time.monotonic() < deadline:
        time.sleep(0.005)
    return ctl.snapshot().get(tenant, {}).get("queued", 0)


def _rejection(p, fn):
    """(reason, queue_depth, retry_after_s, tenant) of the DaftAdmissionError
    ``fn`` raises."""
    with pytest.raises(p.err.DaftAdmissionError) as ei:
        fn()
    e = ei.value
    assert isinstance(e, p.err.DaftTransientError)
    return e.reason, e.queue_depth, e.retry_after_s, e.tenant


def _same(run):
    """Run ``run(p)`` through both packages and hold the port's trace to the
    JAX package's."""
    jax_trace = run(JAX)
    port_trace = run(PORT)
    assert port_trace == jax_trace
    return port_trace


# --------------------------------------------------------------------- #
# Controller unit cases                                                  #
# --------------------------------------------------------------------- #
def test_disabled_is_passthrough():
    def run(p):
        ctl = p.adm.AdmissionController()
        t = ctl.admit("q1", cfg=_cfg(p, admission_enabled=False))
        trace = [t.released(), t.tenant, t.compute_threads_cap, t.mem_reserved]
        t.release()
        return trace + [t.released(), ctl.snapshot()]

    assert _same(run) == [False, "default", None, 0, True, {}]


def test_unlimited_default_fast_path():
    def run(p):
        ctl = p.adm.AdmissionController()
        tickets = [ctl.admit(f"q{i}", cfg=_cfg(p)) for i in range(16)]
        snap = dict(ctl.snapshot()[p.adm.DEFAULT_TENANT])
        for t in tickets:
            t.release()
        return [snap, [t.wait_s for t in tickets], ctl.snapshot(), ctl.totals()]

    trace = _same(run)
    assert trace[0]["running"] == 16 and trace[0]["queued"] == 0
    assert trace[2]["default"]["running"] == 0


def test_release_is_idempotent():
    def run(p):
        ctl = p.adm.AdmissionController()
        t = ctl.admit("q1", cfg=_cfg(p))
        t.release()
        t.release()
        return ctl.snapshot()[p.adm.DEFAULT_TENANT]["running"]

    assert _same(run) == 0


def test_quota_queues_then_admits_fifo():
    def run(p):
        ctl = p.adm.AdmissionController()
        ctl.set_policy(p.adm.TenantPolicy(tenant="t", max_concurrent_queries=1,
                                          queue_depth=8))
        cfg = _cfg(p)
        first = ctl.admit("q0", tenant="t", cfg=cfg)
        order, lock = [], threading.Lock()

        def waiter(qid):
            ticket = ctl.admit(qid, tenant="t", cfg=cfg)
            with lock:
                order.append(qid)
            time.sleep(0.05)
            ticket.release()

        threads, positions = [], []
        for i in range(1, 4):
            th = threading.Thread(target=waiter, args=(f"q{i}",))
            th.start()
            threads.append(th)
            # Staggered starts: each waiter's queue position is deterministic.
            positions.append(_wait_queued(ctl, "t", i))
        first.release()
        for th in threads:
            th.join(timeout=10)
        snap = ctl.snapshot()["t"]
        return [positions, order, snap["running"], snap["queued"]]

    assert _same(run) == [[1, 2, 3], ["q1", "q2", "q3"], 0, 0]


def test_queue_full_fast_rejection_with_details():
    def run(p):
        ctl = p.adm.AdmissionController()
        ctl.set_policy(p.adm.TenantPolicy(tenant="t", max_concurrent_queries=1,
                                          queue_depth=1))
        cfg = _cfg(p)
        held = ctl.admit("q0", tenant="t", cfg=cfg)
        blocked = threading.Thread(target=lambda: ctl.admit("q1", tenant="t", cfg=cfg).release())
        blocked.start()
        queued = _wait_queued(ctl, "t", 1)
        rej = _rejection(p, lambda: ctl.admit("q2", tenant="t", cfg=cfg))
        held.release()
        blocked.join(timeout=10)
        return [queued, rej]

    # One ahead in the queue, one lane, the initial 1 s average: 2 s.
    assert _same(run) == [1, ("queue-full", 1, 2.0, "t")]


def test_rejection_latency_is_fast():
    """Overload rejections are lock-and-raise, never queue waits: the p99
    over 100 rejections under the JAX case's 0.1 s bound."""
    ctl = tadm.AdmissionController()
    ctl.set_policy(tadm.TenantPolicy(tenant="t", max_concurrent_queries=1, queue_depth=1))
    cfg = _cfg(PORT)
    held = ctl.admit("q0", tenant="t", cfg=cfg)
    blocked = threading.Thread(target=lambda: ctl.admit("qq", tenant="t", cfg=cfg).release())
    blocked.start()
    assert _wait_queued(ctl, "t", 1) == 1
    lat = []
    for i in range(100):
        t0 = time.monotonic()
        with pytest.raises(terrors.DaftAdmissionError):
            ctl.admit(f"r{i}", tenant="t", cfg=cfg)
        lat.append(time.monotonic() - t0)
    lat.sort()
    assert lat[98] < 0.1, f"p99 rejection latency {lat[98]:.4f}s"
    held.release()
    blocked.join(timeout=10)


def test_deadline_smaller_than_estimated_wait_rejected_immediately():
    def run(p):
        ctl = p.adm.AdmissionController()
        ctl.set_policy(p.adm.TenantPolicy(tenant="t", max_concurrent_queries=1,
                                          queue_depth=8))
        cfg = _cfg(p)
        ctl._avg_query_s = 10.0  # the wait estimate far over the query's budget
        held = ctl.admit("q0", tenant="t", cfg=cfg)
        t0 = time.monotonic()
        rej = _rejection(p, lambda: ctl.admit("q1", tenant="t", token=_token(p, 0.5), cfg=cfg))
        fast = time.monotonic() - t0 < 0.1  # never enqueued to time out later
        queued = ctl.snapshot()["t"]["queued"]
        held.release()
        return [rej, fast, queued]

    assert _same(run) == [("deadline-too-short", 0, 10.0, "t"), True, 0]


def test_memory_fraction_reservation_gate():
    """Under a memory limit a tenant's running queries reserve one sink
    share each; past its fraction, a new one queues with slots free."""
    def run(p):
        ctl = p.adm.AdmissionController()
        ctl.set_policy(p.adm.TenantPolicy(tenant="t", max_concurrent_queries=0,
                                          max_memory_fraction=0.5, queue_depth=8))
        cfg = _cfg(p)
        with p.rm.memory_limit(1 << 20):
            # share = limit/4 = 256 KiB; quota = 512 KiB: two fit.
            t1 = ctl.admit("q1", tenant="t", cfg=cfg)
            t2 = ctl.admit("q2", tenant="t", cfg=cfg)
            reserved = ctl.snapshot()["t"]["mem_reserved"]
            admitted = threading.Event()

            def third():
                tk = ctl.admit("q3", tenant="t", cfg=cfg)
                admitted.set()
                tk.release()

            th = threading.Thread(target=third)
            th.start()
            queued = _wait_queued(ctl, "t", 1)
            early = admitted.is_set()
            t1.release()  # a reservation freed: q3 admitted
            late = admitted.wait(5)
            th.join(timeout=10)
            t2.release()
        return [reserved, t1.mem_reserved, queued, early, late,
                ctl.snapshot()["t"]["mem_reserved"]]

    assert _same(run) == [2 * (1 << 18), 1 << 18, 1, False, True, 0]


def test_unsatisfiable_memory_quota_rejects_fast():
    """A quota smaller than one query's reservation rejects at once: a queue
    could never admit it."""
    def run(p):
        ctl = p.adm.AdmissionController()
        # share = limit/4 = 256 KiB; quota = 0.1 * 1 MiB < share.
        ctl.set_policy(p.adm.TenantPolicy(tenant="tiny", max_memory_fraction=0.1))
        with p.rm.memory_limit(1 << 20):
            t0 = time.monotonic()
            with pytest.raises(p.err.DaftAdmissionError, match="whole quota") as ei:
                ctl.admit("q1", tenant="tiny", cfg=_cfg(p))
            fast = time.monotonic() - t0 < 0.1
        e = ei.value
        return [(e.reason, e.queue_depth, e.retry_after_s), fast,
                ctl.snapshot()["tiny"]["queued"]]

    assert _same(run) == [("overload", 0, 0.05), True, 0]


def test_already_cancelled_token_raises_cancelled_not_admission():
    def run(p):
        ctl = p.adm.AdmissionController()
        ctl.set_policy(p.adm.TenantPolicy(tenant="t", max_concurrent_queries=1))
        held = ctl.admit("q0", tenant="t", cfg=_cfg(p))
        tok = _token(p, query_id="dead")
        tok.cancel("user-cancel")
        with pytest.raises(p.err.DaftCancelledError) as ei:
            ctl.admit("dead", tenant="t", token=tok, cfg=_cfg(p))
        held.release()
        return [type(ei.value).__name__, isinstance(ei.value, p.err.DaftAdmissionError)]

    assert _same(run) == ["DaftCancelledError", False]


def test_policy_json_change_is_picked_up():
    """Policies re-parse when the ``admission_policies`` string changes."""
    def run(p):
        ctl = p.adm.AdmissionController()
        out = []
        for prio in (-1, 3):
            ctl.admit("q", tenant="t", cfg=_cfg(
                p, admission_policies='{"t": {"priority": %d}}' % prio)).release()
            out.append(ctl.snapshot()["t"]["priority"])
        return out

    assert _same(run) == [-1, 3]


def test_policies_from_config_json():
    def run(p):
        ctl = p.adm.AdmissionController()
        cfg = _cfg(p, admission_policies=(
            '{"hostile": {"max_concurrent_queries": 2, "priority": -1},'
            ' "gold": {"priority": 5}}'))
        ctl.admit("q1", tenant="hostile", cfg=cfg).release()
        ctl.admit("q2", tenant="gold", cfg=cfg).release()
        return ctl.snapshot()

    snap = _same(run)
    assert snap["hostile"]["max_concurrent"] == 2 and snap["hostile"]["priority"] == -1
    assert snap["gold"]["priority"] == 5


@pytest.mark.parametrize("policies", ["{nope", '{"t": {"max_queries": 1}}'])
def test_policies_bad_json_raises(policies):
    def run(p):
        ctl = p.adm.AdmissionController()
        with pytest.raises(p.err.DaftValueError) as ei:
            ctl.admit("q1", cfg=_cfg(p, admission_policies=policies))
        return str(ei.value).split(":")[0]

    _same(run)


def test_tenant_resolution_precedence(monkeypatch):
    for p, cfg_mod in ((JAX, jconfig), (PORT, tconfig)):
        assert p.adm.resolve_tenant("explicit") == "explicit"
        p.adm.set_tenant("ctxvar")
        assert p.adm.resolve_tenant(None) == "ctxvar"
        p.adm.set_tenant(None)
        monkeypatch.setattr(cfg_mod, "daft_env", lambda name, default=None:
                            "envtenant" if name == "DAFT_TENANT" else default)
        assert p.adm.resolve_tenant(None) == "envtenant"
        p.adm.set_tenant("ctxvar2")  # the contextvar wins over the env
        assert p.adm.resolve_tenant(None) == "ctxvar2"
        p.adm.set_tenant(None)


def test_tenant_and_priority_do_not_leak_across_threads():
    """The tenant and the request priority are contextvars: a thread's
    setting is its own."""
    seen = {}
    set_tenant("main")
    tadm.set_request_priority(-1)

    def other():
        seen["tenant"] = tadm.current_tenant()
        seen["priority"] = tadm._request_priority_var.get()

    th = threading.Thread(target=other)
    th.start()
    th.join()
    tadm.set_request_priority(None)
    assert seen == {"tenant": "default", "priority": None}
    assert tadm.current_tenant() == "main"


# --------------------------------------------------------------------- #
# The shed ladder                                                        #
# --------------------------------------------------------------------- #
def _force_level(ctl, level):
    """Pin the ladder at ``level`` (a recent escalation; the signal frozen)."""
    with ctl._cond:
        ctl._shed_level = level
        ctl._shed_changed_at = time.monotonic() + 3600
        ctl._hist_read_at = time.monotonic() + 3600


def test_queue_pressure_escalates_shed_level():
    def run(p):
        ctl = p.adm.AdmissionController()
        ctl.set_policy(p.adm.TenantPolicy(tenant="t", max_concurrent_queries=1,
                                          queue_depth=4))
        cfg = _cfg(p, admission_overload_queue_fraction=0.5)
        held = ctl.admit("q0", tenant="t", cfg=cfg)
        threads, positions = [], []
        for i in range(4):
            th = threading.Thread(target=lambda i=i: ctl.admit(
                f"q{i + 1}", tenant="t", cfg=cfg).release(), daemon=True)
            th.start()
            threads.append(th)
            positions.append(_wait_queued(ctl, "t", i + 1))
        # The queue 4/4 full over a watermark of 0.5: pressure 2.0, level 3.
        with ctl._cond:
            ctl._hist_read_at = 0.0
            ctl._refresh_signals_locked(cfg)
        level = ctl.shed_level()
        held.release()
        for th in threads:
            th.join(timeout=10)
        return [positions, level]

    assert _same(run) == [[1, 2, 3, 4], 3]


def test_shed_level1_rejects_negative_priority_and_over_quota():
    def run(p):
        ctl = p.adm.AdmissionController()
        ctl.set_policy(p.adm.TenantPolicy(tenant="low", priority=-1))
        ctl.set_policy(p.adm.TenantPolicy(tenant="busy", max_concurrent_queries=1))
        cfg = _cfg(p)
        _force_level(ctl, 1)
        low = _rejection(p, lambda: ctl.admit("q1", tenant="low", cfg=cfg))
        held = ctl.admit("q2", tenant="busy", cfg=cfg)
        busy = _rejection(p, lambda: ctl.admit("q3", tenant="busy", cfg=cfg))  # would queue
        # The default tenant with slots free is admitted at level 1.
        t = ctl.admit("q4", cfg=cfg)
        out = [low, busy, t.compute_threads_cap]
        t.release()
        held.release()
        return out

    assert _same(run) == [("shed-low-priority", 0, 1.0, "low"),
                          ("shed-over-quota", 0, 1.0, "busy"), None]


def test_shed_level2_caps_compute_threads():
    def run(p):
        ctl = p.adm.AdmissionController()
        cfg = _cfg(p, num_compute_threads=8)
        _force_level(ctl, 2)
        t = ctl.admit("q1", cfg=cfg)
        t.release()
        _force_level(ctl, 0)
        t2 = ctl.admit("q2", cfg=cfg)
        t2.release()
        return [t.compute_threads_cap, t2.compute_threads_cap]

    assert _same(run) == [4, None]


def test_shed_level3_rejects_default_admits_positive_priority():
    def run(p):
        ctl = p.adm.AdmissionController()
        ctl.set_policy(p.adm.TenantPolicy(tenant="gold", priority=1))
        cfg = _cfg(p, num_compute_threads=8)
        _force_level(ctl, 3)
        rej = _rejection(p, lambda: ctl.admit("q1", cfg=cfg))
        t = ctl.admit("q2", tenant="gold", cfg=cfg)  # positive priority rides it out
        t.release()
        return [rej, t.compute_threads_cap]           # but capped (level >= 2)

    assert _same(run) == [("overload", 0, 1.0, "default"), 4]


def test_shed_level_decays_one_step_per_cooldown():
    def run(p):
        ctl = p.adm.AdmissionController()
        cfg = _cfg(p, admission_shed_cooldown_s=0.05)
        levels = []
        with ctl._cond:
            ctl._shed_level = 2
            for _ in range(2):
                ctl._shed_changed_at = time.monotonic() - 1.0
                ctl._hist_read_at = 0.0
                ctl._refresh_signals_locked(cfg)
                levels.append(ctl._shed_level)
        return levels

    assert _same(run) == [1, 0]  # one step at a time, not straight to 0


def test_permit_wait_p95_watermark_escalates():
    def run(p):
        ctl = p.adm.AdmissionController()
        cfg = _cfg(p, admission_permit_wait_p95_s=0.5)
        with ctl._cond:
            ctl._hist_read_at = 0.0
            ctl._refresh_signals_locked(cfg)  # the histogram's base
        for _ in range(32):
            p.metrics.PERMIT_WAIT.observe(2.0)  # permit waits far past the watermark
        with ctl._cond:
            ctl._hist_read_at = 0.0
            ctl._refresh_signals_locked(cfg)
        return [ctl._permit_p95, ctl.shed_level()]

    p95, level = _same(run)
    assert level >= 1 and p95 >= 2.0


def test_permit_waits_a_file_leaves_unread_shed_the_next_file_until_reset():
    """Permit waits that one test file's queries leave unread (its last
    query's waits, after its last admit) are read by the next file's first
    admit in the same process as overload: the shed ladder goes to level 3
    and rejects the default tenant's query, in both packages. Resetting the
    controllers at a file's end (``torch_isolation.admission_windows_reset``)
    starts a new window, so the next file's query runs."""
    from torch_isolation import reset_admission_windows

    def query(p):
        with p.pkg.execution_config_ctx(result_cache_enabled=False):
            return p.pkg.from_pydict({"a": [1, 2, 3]}).where(p.pkg.col("a") > 1).to_pydict()

    def leave_waits_unread(p):
        ctl = p.adm.get_controller()
        assert query(p) == {"a": [2, 3]}  # the file's last admit reads the window's base
        for _ in range(16):  # then its last query's permit waits, past 1.5 s
            p.metrics.PERMIT_WAIT.observe(5.0)
        time.sleep(ctl._SIGNAL_REFRESH_S)

    for p in BOTH:
        leave_waits_unread(p)
        assert _rejection(p, lambda: query(p))[0] == "overload"
        assert p.adm.get_controller().shed_level() == 3
    reset_admission_windows()
    for p in BOTH:
        leave_waits_unread(p)
    reset_admission_windows()  # the first file's teardown
    for p in BOTH:
        assert query(p) == {"a": [2, 3]}
        assert p.adm.get_controller().shed_level() == 0


# --------------------------------------------------------------------- #
# Metrics and events                                                     #
# --------------------------------------------------------------------- #
class _Capture:
    def __init__(self):
        self.events = []

    def on_event(self, e):
        self.events.append(e)


def test_metrics_and_events_roundtrip():
    def run(p):
        reg = p.metrics.get_registry()
        base = reg.snapshot()
        cap = _Capture()
        ctx = p.pkg.get_context()
        ctx.attach_subscriber(cap)
        try:
            ctl = p.adm.AdmissionController()
            ctl.set_policy(p.adm.TenantPolicy(tenant="t", max_concurrent_queries=1,
                                              queue_depth=1))
            cfg = _cfg(p)
            held = ctl.admit("q0", tenant="t", cfg=cfg)
            done = threading.Event()

            def queued():
                ctl.admit("q1", tenant="t", cfg=cfg).release()
                done.set()

            th = threading.Thread(target=queued)
            th.start()
            _wait_queued(ctl, "t", 1)
            _rejection(p, lambda: ctl.admit("q2", tenant="t", cfg=cfg))
            held.release()
            assert done.wait(5)
            th.join(timeout=10)
        finally:
            ctx.detach_subscriber(cap)
        snap = reg.snapshot()

        def delta(name):
            return {t: v - base.label_totals(name, "tenant").get(t, 0)
                    for t, v in snap.label_totals(name, "tenant").items()
                    if t == "t" and v - base.label_totals(name, "tenant").get(t, 0)}

        mine = [e for e in cap.events if getattr(e, "tenant", None) == "t"]
        waited = next(e for e in mine if type(e).__name__ == "QueryAdmitted"
                      and e.query_id == "q1")
        assert waited.wait_s > 0
        return [delta("daft_admission_admitted_total"), delta("daft_admission_rejected_total"),
                snap.value("daft_admission_queue_depth", tenant="t"),
                sorted((type(e).__name__, e.query_id, getattr(e, "queue_depth", None),
                        getattr(e, "reason", None), getattr(e, "retry_after_s", None))
                       for e in mine)]

    admitted, rejected, depth, events = _same(run)
    assert admitted == {"t": 2} and rejected == {"t": 1} and depth == 0
    assert ("QueryQueued", "q1", 1, None, None) in events
    assert ("QueryShed", "q2", 1, "queue-full", 2.0) in events


def test_prometheus_exposition_includes_admission_series():
    ctl = tadm.AdmissionController()
    ctl.admit("q1", tenant="scrape-t", cfg=_cfg(PORT)).release()
    text = tmetrics.get_registry().to_prometheus()
    assert 'daft_admission_admitted_total{tenant="scrape-t"}' in text
    assert "daft_admission_wait_seconds_bucket" in text
    assert "daft_admission_shed_level" in text


# --------------------------------------------------------------------- #
# The runner (the port's native runner)                                  #
# --------------------------------------------------------------------- #
def test_collect_passes_front_door_and_releases():
    daft_tpu_torch.set_tenant("itest")
    df = daft_tpu_torch.from_pydict({"a": [1, 2, 3]}).with_column("b", col("a") * 2).collect()
    assert df.to_pydict()["b"] == [2, 4, 6]
    snap = get_controller().snapshot().get("itest")
    assert snap is not None and snap["running"] == 0 and snap["queued"] == 0
    assert get_controller().totals()["running"] == 0


def test_failed_query_releases_slot():
    @daft_tpu_torch.udf.func.batch(return_dtype=daft_tpu_torch.DataType.int64())
    def boom(x):
        raise RuntimeError("kaboom")

    daft_tpu_torch.set_tenant("failer")
    with pytest.raises(Exception, match="kaboom"):
        daft_tpu_torch.from_pydict({"a": [1, 2, 3]}).with_column("b", boom(col("a"))).collect()
    snap = get_controller().snapshot()["failer"]
    assert snap["running"] == 0 and snap["queued"] == 0


def test_quota_serializes_collects_across_threads():
    daft_tpu_torch.set_tenant_policy("serial", max_concurrent_queries=1, queue_depth=8)
    peak, active = [0], [0]
    lock = threading.Lock()

    @daft_tpu_torch.udf.func.batch(return_dtype=daft_tpu_torch.DataType.int64())
    def tracked(x):
        with lock:
            active[0] += 1
            peak[0] = max(peak[0], active[0])
        time.sleep(0.05)
        with lock:
            active[0] -= 1
        return x

    def run():
        set_tenant("serial")
        with execution_config_ctx(device="cpu"):
            daft_tpu_torch.from_pydict({"a": [1, 2, 3]}).with_column(
                "b", tracked(col("a"))).collect()

    threads = [threading.Thread(target=run) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert peak[0] == 1, f"quota 1 but {peak[0]} queries ran concurrently"
    snap = get_controller().snapshot()["serial"]
    assert snap["running"] == 0 and snap["queued"] == 0


def test_nested_query_bypasses_parent_tenant_quota():
    """A query issued inside another query's execution scope (an ambient
    cancel token of another query id) rides the parent's slot."""
    def run(p):
        ctl = p.adm.AdmissionController()
        ctl.set_policy(p.adm.TenantPolicy(tenant="t", max_concurrent_queries=1,
                                          queue_depth=1))
        cfg = _cfg(p)
        outer = ctl.admit("outer", tenant="t", cfg=cfg)
        with p.cancel.cancel_scope(_token(p, query_id="outer")):
            inner = ctl.admit("inner", tenant="t", cfg=cfg)  # no deadlock
            out = [inner.released(), inner.mem_reserved]
            inner.release()
        out.append(ctl.snapshot()["t"]["running"])  # only the outer holds a slot
        outer.release()
        return out

    assert _same(run) == [False, 0, 1]


def test_udf_that_collects_inside_a_one_slot_tenant_finishes():
    """The runner's side of the bypass: a UDF whose body collects another
    query runs under its parent's one slot and does not deadlock."""
    daft_tpu_torch.set_tenant_policy("nest", max_concurrent_queries=1, queue_depth=1)
    inner_df = daft_tpu_torch.from_pydict({"x": [10, 20]})

    @daft_tpu_torch.udf.func.batch(return_dtype=daft_tpu_torch.DataType.int64())
    def plus_inner(x):
        total = sum(inner_df.where(col("x") > 0).to_pydict()["x"])
        return [v + total for v in x.to_pylist()]

    set_tenant("nest")
    out = {}

    def run():
        set_tenant("nest")
        with execution_config_ctx(device="cpu", result_cache_enabled=False):
            out["rows"] = daft_tpu_torch.from_pydict({"a": [1, 2]}).with_column(
                "b", plus_inner(col("a"))).to_pydict()["b"]

    th = threading.Thread(target=run)
    th.start()
    th.join(timeout=60)
    assert not th.is_alive(), "the nested query deadlocked against its parent's slot"
    assert out["rows"] == [31, 32]
    assert get_controller().snapshot()["nest"]["running"] == 0


def test_admission_disabled_creates_no_state():
    with execution_config_ctx(admission_enabled=False):
        daft_tpu_torch.set_tenant("ghost")
        daft_tpu_torch.from_pydict({"a": [1]}).collect()
    assert "ghost" not in get_controller().snapshot()


def test_cache_charge_reaches_the_calling_threads_tenant_at_4_workers():
    """The result cache charges the tenant of the thread that collected,
    whatever stage worker commits: the bytes land on that tenant's quota."""
    daft_tpu_torch.set_tenant("pool-t")
    with execution_config_ctx(num_compute_threads=4, default_morsel_size=64):
        daft_tpu_torch.from_pydict({"k": list(range(1000)), "v": [1.0] * 1000}).where(
            col("k") < 500).groupby("k").agg(col("v").sum().alias("s")).collect()
    snap = get_controller().snapshot()
    assert snap["pool-t"]["cache_bytes"] > 0
    assert not snap.get("default", {}).get("cache_bytes")


# --------------------------------------------------------------------- #
# Cancellation and deadlines of queued queries, permits                  #
# --------------------------------------------------------------------- #
def test_cancel_query_dequeues_waiting_query():
    """``cancel_query`` on a query still queued dequeues it (never admits
    it) with ``{queued: True}`` progress."""
    def run(p):
        ctl = p.adm.get_controller()
        ctl.set_policy(p.adm.TenantPolicy(tenant="t", max_concurrent_queries=1,
                                          queue_depth=8))
        cfg = _cfg(p)
        held = ctl.admit("q0", tenant="t", cfg=cfg)
        token = _token(p, query_id="queued-q")
        p.cancel.register_query_token("queued-q", token)
        result = {}

        def waiter():
            try:
                ctl.admit("queued-q", tenant="t", token=token, cfg=cfg).release()
                result["out"] = "admitted"
            except BaseException as e:  # noqa: BLE001 — recorded for the asserts
                result["out"] = e

        th = threading.Thread(target=waiter)
        th.start()
        queued = _wait_queued(ctl, "t", 1)
        cancelled = p.pkg.cancel_query("queued-q")
        th.join(timeout=10)
        p.cancel.unregister_query_token("queued-q")
        err = result["out"]
        snap = ctl.snapshot()["t"]
        held.release()
        return [queued, cancelled, type(err).__name__, err.progress.get("queued"),
                snap["queued"], snap["running"],
                p.metrics.get_registry().snapshot().value("daft_admission_queue_depth",
                                                          tenant="t")]

    assert _same(run) == [1, True, "DaftCancelledError", True, 0, 1, 0]


def test_deadline_expiry_dequeues_waiting_query():
    def run(p):
        ctl = p.adm.get_controller()
        ctl.set_policy(p.adm.TenantPolicy(tenant="t", max_concurrent_queries=1,
                                          queue_depth=8))
        cfg = _cfg(p)
        ctl._avg_query_s = 0.01  # a small estimate, so the query is enqueued
        held = ctl.admit("q0", tenant="t", cfg=cfg)
        t0 = time.monotonic()
        with pytest.raises(p.err.DaftTimeoutError) as ei:
            ctl.admit("q1", tenant="t", token=_token(p, 0.3), cfg=cfg)
        waited = 0.2 < time.monotonic() - t0 < 5.0
        snap = ctl.snapshot()["t"]
        held.release()
        return [waited, ei.value.progress.get("queued"), snap["queued"]]

    assert _same(run) == [True, True, 0]


def test_collect_timeout_while_queued_has_queued_progress():
    """A ``collect(timeout=)`` that expires while its query waits in the
    queue fails with ``{queued: true}`` and leaves no state."""
    daft_tpu_torch.set_tenant_policy("e2e", max_concurrent_queries=1, queue_depth=8)
    ctl = get_controller()
    ctl._avg_query_s = 0.01  # keep the wait estimator from rejecting at once
    release_holder = threading.Event()

    @daft_tpu_torch.udf.func.batch(return_dtype=daft_tpu_torch.DataType.int64())
    def hold(x):
        release_holder.wait(20)
        return x

    holder_done = {}

    def holder():
        set_tenant("e2e")
        try:
            with execution_config_ctx(device="cpu"):
                daft_tpu_torch.from_pydict({"a": [1]}).with_column("b", hold(col("a"))).collect()
            holder_done["out"] = "ok"
        except BaseException as e:  # noqa: BLE001 — recorded for the asserts
            holder_done["out"] = e

    th = threading.Thread(target=holder)
    th.start()
    deadline = time.monotonic() + 10
    while ctl.snapshot().get("e2e", {}).get("running", 0) < 1 and time.monotonic() < deadline:
        time.sleep(0.01)
    try:
        set_tenant("e2e")
        with pytest.raises(terrors.DaftTimeoutError) as ei:
            daft_tpu_torch.from_pydict({"a": [2]}).collect(timeout=0.5)
        assert ei.value.progress.get("queued") is True
    finally:
        set_tenant(None)
        release_holder.set()
        th.join(timeout=30)
    assert holder_done["out"] == "ok"
    snap = ctl.snapshot()["e2e"]
    assert snap["running"] == 0 and snap["queued"] == 0


def test_permit_leak_poison_mid_acquire_returns_to_baseline():
    """A waiter poisoned mid-acquire leaves the permits at their baseline
    once the query unwinds."""
    with trm.memory_limit(1 << 16) as mm:
        baseline = mm.available_permits()
        assert mm.acquire(1 << 15)  # the holder: half the budget
        token = _token(PORT, query_id="poisoned")
        result = {}

        def blocked():
            try:
                result["ok"] = mm.acquire(3 << 14, token=token)
            except BaseException as e:  # noqa: BLE001 — recorded for the asserts
                result["err"] = e

        th = threading.Thread(target=blocked)
        th.start()
        time.sleep(0.1)  # into the wait
        mm.poison(RuntimeError("query died"), query_id="poisoned")
        th.join(timeout=10)
        assert isinstance(result.get("err"), RuntimeError)
        mm.release(1 << 15)
        assert mm.available_permits() == baseline


def test_late_acquire_after_executor_unwind_self_releases():
    """An acquire that lands after the executor's cleanup drained its held
    permits hands the permit straight back."""
    from daft_tpu_torch.execution.executor import Executor
    from daft_tpu_torch.physical.translate import translate

    with trm.memory_limit(1 << 16) as mm:
        baseline = mm.available_permits()
        ex = Executor(daft_tpu_torch.get_context().execution_config)
        builder = daft_tpu_torch.from_pydict({"a": [1, 2, 3]})._builder
        list(ex.run(translate(builder.optimize().plan)))  # done: its permits closed
        assert mm.acquire(1 << 10)
        ex._add_held(1 << 10)
        assert mm.available_permits() == baseline, \
            "a late _add_held after the executor closed leaked a permit"


def test_cancelled_collect_leaves_no_admission_or_permit_state():
    """A query cancelled mid-execution under a memory limit unwinds with no
    permit out and its admission slot free."""
    with trm.memory_limit(1 << 20) as mm:
        baseline = mm.available_permits()
        set_tenant("cancel-t")

        @daft_tpu_torch.udf.func.batch(return_dtype=daft_tpu_torch.DataType.int64())
        def slow(x):
            time.sleep(0.1)
            return x

        df = daft_tpu_torch.from_pydict({"a": list(range(2000))})
        with pytest.raises((terrors.DaftTimeoutError, terrors.DaftCancelledError)):
            df.with_column("b", slow(col("a"))).sort("a").collect(timeout=0.3)
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            snap = get_controller().snapshot().get("cancel-t", {})
            if snap.get("running", 1) == 0 and mm.available_permits() == baseline:
                break
            time.sleep(0.05)
        assert get_controller().snapshot()["cancel-t"]["running"] == 0
        assert mm.available_permits() == baseline
