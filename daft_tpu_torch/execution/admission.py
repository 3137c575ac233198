"""Multi-tenant admission control: the query front door (port of
``daft_tpu/execution/admission.py``).

Every query on the native runner passes :meth:`AdmissionController.admit`
before planning (``runners/runner.py::enter_front_door``), so N concurrent
``collect()`` calls meet a quota, a bounded queue and a fast rejection
instead of racing straight into the stage pool and the MemoryManager.

* **Per-tenant policy** (:class:`TenantPolicy`): max concurrent queries, a
  memory-reservation quota (a fraction of the MemoryManager's byte limit,
  charged as one ``spill.sink_budget`` share per running query), a bounded
  wait-queue depth and a priority for the shed ladder. Policies come from
  the ``admission_*`` config fields, the ``admission_policies`` JSON
  (``DAFT_ADMISSION_POLICIES``) or :func:`set_tenant_policy`.
* **Deadline- and cancel-aware waits**: a queued query waits on the
  controller's condition bounded by its cancel token; a cancel or an
  expired deadline dequeues it with ``{"queued": True}`` progress. A query
  whose remaining deadline is shorter than the estimated queue wait is
  rejected at once.
* **Fast rejection**: queue-full and shed rejections raise
  ``DaftAdmissionError`` (transient: retry after ``retry_after_s``) from
  under one lock acquisition.
* **The shed ladder** (:meth:`AdmissionController.shed_level`): queue
  pressure over ``admission_overload_queue_fraction`` of capacity, or the
  permit-wait p95 read from the metrics registry over
  ``admission_permit_wait_p95_s``, raises the level at once; it steps down
  one level per ``admission_shed_cooldown_s`` without overload. Level 1
  sheds negative-priority and over-quota tenants, level 2 also halves a
  newly admitted query's ``num_compute_threads`` (the stage pool gives
  the same bytes at any count), level 3 also rejects default-priority
  tenants.
* **Exception-safe release**: :class:`AdmissionTicket.release` is
  idempotent and runs in the runner's ``finally`` on every exit.

A query issued inside another query's execution scope (a UDF that
collects) rides its parent's slot. Cached results are charged to their
tenant's memory quota (:meth:`AdmissionController.note_cache_bytes`) and
always yield to live queries (``plancache.ResultCache.shrink_tenant``).

Metrics: ``daft_admission_queue_depth{tenant}``,
``daft_admission_active_queries{tenant}``,
``daft_admission_admitted_total{tenant}``,
``daft_admission_rejected_total{tenant,reason}``,
``daft_admission_wait_seconds`` and ``daft_admission_shed_level``. Events:
``QueryQueued``, ``QueryAdmitted``, ``QueryShed``.
"""

from __future__ import annotations

import contextvars
import json
import os
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Deque, Dict, List, Optional

from daft_tpu_torch.errors import DaftAdmissionError, DaftValueError

#: Tenant used when nothing is configured: ``set_tenant()`` not called and
#: ``DAFT_TENANT`` unset. Default-tenant work is the LAST shed (level 3).
DEFAULT_TENANT = "default"

#: Rejection reasons (the ``reason`` label on daft_admission_rejected_total).
REASON_QUEUE_FULL = "queue-full"
REASON_DEADLINE = "deadline-too-short"
REASON_SHED_PRIORITY = "shed-low-priority"
REASON_SHED_OVER_QUOTA = "shed-over-quota"
REASON_OVERLOAD = "overload"


@dataclass(frozen=True)
class TenantPolicy:
    """Admission quota for one tenant.

    ``max_concurrent_queries``/``queue_depth`` of 0 mean "use the config
    default"; a config default of 0 for max_concurrent means unlimited.
    ``max_memory_fraction`` bounds the tenant's total memory RESERVATION
    (one ``sink_budget`` share per running query) as a fraction of the
    MemoryManager limit; it only gates when ``DAFT_MEMORY_LIMIT`` is set.
    ``priority``: negative = shed first under overload, 0 = default,
    positive = survives the whole ladder.
    ``slo_latency_p99_s``/``slo_error_rate`` (0 = use the config defaults)
    override the tenant's SLO objectives — the burn-rate tracker and the
    tail-based auto-profiler (``slo.py``) read them from here so
    per-tenant SLOs ride the same policy JSON as quotas;
    ``slo_staleness_p99_s`` is the freshness objective of the tenant's
    materialized views, parsed here and read by the views (ROADMAP A.8.6).
    """

    tenant: str = DEFAULT_TENANT
    max_concurrent_queries: int = 0
    max_memory_fraction: float = 1.0
    queue_depth: int = 0
    priority: int = 0
    slo_latency_p99_s: float = 0.0
    slo_error_rate: float = 0.0
    slo_staleness_p99_s: float = 0.0

    @staticmethod
    def from_dict(tenant: str, d: dict) -> "TenantPolicy":
        known = {"max_concurrent_queries", "max_memory_fraction",
                 "queue_depth", "priority", "slo_latency_p99_s",
                 "slo_error_rate", "slo_staleness_p99_s"}
        bad = set(d) - known
        if bad:
            raise DaftValueError(
                f"unknown tenant-policy keys for {tenant!r}: {sorted(bad)} "
                f"(known: {sorted(known)})")
        return TenantPolicy(tenant=tenant, **d)


class AdmissionTicket:
    """Proof of admission, releasable exactly once.

    ``compute_threads_cap`` is set when the shed ladder is at level >= 2:
    the runner applies it to this query's ``num_compute_threads`` (results
    are thread-count invariant, the stage pool's contract, so this
    only trades latency for headroom). ``release()`` is idempotent and must
    run on EVERY exit path — the runners call it in their ``finally``.
    """

    __slots__ = ("query_id", "tenant", "wait_s", "compute_threads_cap",
                 "mem_reserved", "_controller", "_released", "_admitted_at")

    def __init__(self, query_id: str, tenant: str, wait_s: float = 0.0,
                 compute_threads_cap: Optional[int] = None,
                 mem_reserved: int = 0,
                 controller: Optional["AdmissionController"] = None):
        self.query_id = query_id
        self.tenant = tenant
        self.wait_s = wait_s
        self.compute_threads_cap = compute_threads_cap
        self.mem_reserved = mem_reserved
        self._controller = controller
        self._released = False
        self._admitted_at = time.monotonic()

    def release(self) -> None:
        if self._released:
            return
        self._released = True
        if self._controller is not None:
            self._controller._release(self)

    def released(self) -> bool:
        return self._released

    def __enter__(self) -> "AdmissionTicket":
        return self

    def __exit__(self, *exc) -> None:
        self.release()


class _Waiter:
    """One query blocked in a tenant's admission queue."""

    __slots__ = ("query_id", "tenant", "token", "admitted", "enqueued_at",
                 "mem_hint")

    def __init__(self, query_id: str, tenant: str, token, mem_hint=None):
        self.query_id = query_id
        self.tenant = tenant
        self.token = token
        self.admitted = False
        self.enqueued_at = time.monotonic()
        self.mem_hint = mem_hint


class _TenantState:
    """Mutable per-tenant admission state (guarded by the controller lock)."""

    __slots__ = ("policy", "running", "mem_reserved", "cache_bytes", "queue")

    def __init__(self, policy: TenantPolicy):
        self.policy = policy
        self.running: Dict[str, int] = {}  # query_id -> mem reservation
        self.mem_reserved = 0
        # Result-cache bytes charged to this tenant (plancache.py): cached
        # results occupy quota headroom but always YIELD to live queries —
        # admission reclaims them (shrink_tenant) instead of queueing.
        self.cache_bytes = 0
        # Bound enforced explicitly above every append (queue-full REJECTS
        # with DaftAdmissionError; a deque maxlen would silently DROP).
        self.queue: Deque[_Waiter] = deque()


class AdmissionController:
    """The process's admission gate, shared by both runners (one per process,
    like the MemoryManager it fronts)."""

    #: minimum permit-wait samples in a window before p95 is believed
    _P95_MIN_SAMPLES = 8
    #: seconds between permit-wait histogram re-reads (the registry read is
    #: cheap, but shed level must not flap per admit call)
    _SIGNAL_REFRESH_S = 0.25

    def __init__(self, cfg=None):
        self._cond = threading.Condition()
        self._tenants: Dict[str, _TenantState] = {}
        # Shed ladder state: level rises immediately, steps DOWN one level
        # per cooldown without overload (hysteresis).
        self._shed_level = 0
        self._shed_changed_at = time.monotonic()
        # EWMA of released-query durations: the queue-wait estimator.
        self._avg_query_s = 1.0
        # Permit-wait p95 sampling state (delta windows over the cumulative
        # metrics registry's histogram).
        self._hist_base: Optional[List[int]] = None
        self._hist_read_at = 0.0
        self._permit_p95 = 0.0
        # Policy cache keyed by the last-parsed admission_policies string.
        self._policies_cfg_id: Optional[str] = None
        self._policy_overrides: Dict[str, TenantPolicy] = {}
        if cfg is not None:
            self._sync_policies(cfg)

    # -- configuration ---------------------------------------------------- #
    def set_policy(self, policy: TenantPolicy) -> None:
        """Programmatic per-tenant override (wins over the config JSON)."""
        with self._cond:
            self._policy_overrides[policy.tenant] = policy
            st = self._tenants.get(policy.tenant)
            if st is not None:
                st.policy = policy
            self._cond.notify_all()

    def _sync_policies(self, cfg) -> None:
        """Parse ``admission_policies`` JSON once per distinct value. Keyed
        by the STRING itself, not the config object's id — a freed frozen
        dataclass's address can be reused by its replacement, which would
        silently serve stale policies."""
        raw = getattr(cfg, "admission_policies", None)
        if raw == self._policies_cfg_id and hasattr(self, "_config_policies"):
            return
        parsed: Dict[str, TenantPolicy] = {}
        if raw:
            try:
                data = json.loads(raw)
            except (ValueError, TypeError) as e:
                raise DaftValueError(
                    f"admission_policies is not valid JSON: {e}") from e
            for tenant, d in data.items():
                parsed[tenant] = TenantPolicy.from_dict(tenant, dict(d))
        self._policies_cfg_id = raw
        for tenant, pol in parsed.items():
            if tenant not in self._policy_overrides:
                st = self._tenants.get(tenant)
                if st is not None:
                    st.policy = pol
        self._config_policies = parsed

    @staticmethod
    def _effective_priority(pol: TenantPolicy) -> int:
        """The tenant's policy priority, lowered (never raised) by any
        per-request priority the network front door attached
        (:func:`set_request_priority`) — a client can mark its own query
        as background, but cannot outrank its tenant's policy."""
        req = _request_priority_var.get()
        if req is None:
            return pol.priority
        return min(pol.priority, int(req))

    def _policy_for(self, tenant: str) -> TenantPolicy:
        ov = self._policy_overrides.get(tenant)
        if ov is not None:
            return ov
        cfgd = getattr(self, "_config_policies", None) or {}
        return cfgd.get(tenant, TenantPolicy(tenant=tenant))

    def policy_for(self, tenant: str) -> TenantPolicy:
        """The tenant's resolved policy (overrides > config JSON > default)
        — the SLO plane's objective-lookup surface."""
        with self._cond:
            st = self._tenants.get(tenant)
            return st.policy if st is not None else self._policy_for(tenant)

    def _state(self, tenant: str) -> _TenantState:
        st = self._tenants.get(tenant)
        if st is None:
            st = _TenantState(self._policy_for(tenant))
            self._tenants[tenant] = st
        return st

    # -- resolved knobs ---------------------------------------------------- #
    @staticmethod
    def _max_concurrent(pol: TenantPolicy, cfg) -> int:
        n = pol.max_concurrent_queries
        if n <= 0:
            n = getattr(cfg, "admission_max_concurrent_queries", 0)
        return n  # 0 = unlimited

    @staticmethod
    def _queue_depth(pol: TenantPolicy, cfg) -> int:
        n = pol.queue_depth
        if n <= 0:
            n = getattr(cfg, "admission_queue_depth", 32)
        return max(n, 1)

    def _mem_quota(self, pol: TenantPolicy, cfg) -> Optional[int]:
        """Tenant's reservation budget in bytes, or None when ungated."""
        from daft_tpu_torch.execution.resource_manager import get_memory_manager

        limit = get_memory_manager().limit
        if limit is None:
            return None
        frac = pol.max_memory_fraction
        if frac >= 1.0:
            frac = getattr(cfg, "admission_max_memory_fraction", 1.0)
        if frac >= 1.0:
            return None
        return max(int(limit * frac), 1)

    @staticmethod
    def _mem_share(cfg) -> int:
        """Per-query memory reservation: one blocking-sink working set
        (``spill.sink_budget``'s limit/4 share), the engine's own planning
        unit for a query's resident footprint."""
        from daft_tpu_torch.execution.resource_manager import get_memory_manager
        from daft_tpu_torch.execution.spill import sink_budget

        limit = get_memory_manager().limit
        share = sink_budget(limit)
        return share or 0

    def _share_for(self, cfg, quota: Optional[int],
                   mem_hint: Optional[int]) -> int:
        """The reservation one query charges against its tenant quota.
        Without a hint: the static limit/4 sink share. With a hint (an
        observed peak for this query's fingerprint) the reservation is the
        observation padded 25% + 1 MiB, clamped to the quota so a hinted
        query is always satisfiable. The runner passes no hint until the
        feedback store that observes peaks is ported (ROADMAP A.8.6)."""
        share = self._mem_share(cfg)
        if mem_hint is None or mem_hint <= 0:
            return share
        padded = int(mem_hint * 1.25) + (1 << 20)
        if quota is not None:
            padded = min(padded, quota)
        return padded

    # -- overload signal --------------------------------------------------- #
    def _refresh_signals_locked(self, cfg) -> None:
        now = time.monotonic()
        if now - self._hist_read_at < self._SIGNAL_REFRESH_S:
            return
        self._hist_read_at = now
        self._permit_p95 = self._read_permit_p95()
        # Queue pressure: total queued over total configured capacity of
        # ALL known tenants. One throttled tenant's tiny full queue is
        # QUOTA pressure (answered by queue-full rejection of that tenant),
        # not engine overload — only fleet-wide backlog may move the shed
        # ladder, or a hostile tenant could trigger the shedding of
        # well-behaved ones.
        queued = cap = 0
        for st in self._tenants.values():
            queued += len(st.queue)
            cap += self._queue_depth(st.policy, cfg)
        queue_frac = (queued / cap) if cap else 0.0
        watermark = max(
            getattr(cfg, "admission_overload_queue_fraction", 0.8), 1e-6)
        p95_mark = max(getattr(cfg, "admission_permit_wait_p95_s", 1.0), 1e-6)
        pressure = max(queue_frac / watermark, self._permit_p95 / p95_mark)
        if pressure >= 1.5:
            target = 3
        elif pressure >= 1.25:
            target = 2
        elif pressure >= 1.0:
            target = 1
        else:
            target = 0
        if target > self._shed_level:
            self._shed_level = target  # escalate immediately
            self._shed_changed_at = now
        elif target < self._shed_level:
            cooldown = getattr(cfg, "admission_shed_cooldown_s", 2.0)
            if now - self._shed_changed_at >= cooldown:
                self._shed_level -= 1  # de-escalate one step at a time
                self._shed_changed_at = now
        from daft_tpu_torch import metrics

        metrics.ADMISSION_SHED_LEVEL.set(self._shed_level)

    def _read_permit_p95(self) -> float:
        """p95 of MemoryManager permit waits over the window since the last
        read, estimated from the registry's cumulative histogram (bucket upper
        bounds; conservative — the true p95 is <= the returned bound)."""
        from daft_tpu_torch import metrics

        if not metrics.metrics_enabled():
            return 0.0
        child = metrics.PERMIT_WAIT._default_child()
        state = getattr(child, "hist_state", None)
        if state is None:  # noop child (registry disabled mid-flight)
            return 0.0
        h = state()
        counts = h["bucket_counts"]
        if self._hist_base is None or len(self._hist_base) != len(counts):
            self._hist_base = counts
            return 0.0
        delta = [c - b for c, b in zip(counts, self._hist_base)]
        self._hist_base = counts
        total = sum(delta)
        if total < self._P95_MIN_SAMPLES:
            return 0.0
        need = 0.95 * total
        seen = 0
        bounds = h["bounds"]
        for i, d in enumerate(delta):
            seen += d
            if seen >= need:
                return bounds[i] if i < len(bounds) else bounds[-1] * 2
        return bounds[-1] * 2

    def shed_level(self) -> int:
        with self._cond:
            return self._shed_level

    # -- result-cache quota coupling ---------------------------------------- #
    def note_cache_bytes(self, tenant: str, delta: int) -> None:
        """Per-tenant result-cache byte ledger (plancache.py commits and
        evictions mirror their deltas here). Cached bytes are charged
        against the tenant's admission memory quota — a tenant cannot hold
        its whole budget in cached results AND run a full complement of
        queries. Called by the cache strictly OUTSIDE its own lock (lock
        order is always cache → admission, never the reverse)."""
        with self._cond:
            st = self._state(tenant)
            st.cache_bytes = max(0, st.cache_bytes + delta)
            resident = st.cache_bytes
            self._cond.notify_all()
        # Memory observatory: per-tenant cache residency is exported as a
        # gauge (the byte ledger's "cache" kind lives at tenant, not query,
        # granularity — cached results outlive the query that built them).
        from daft_tpu_torch import metrics

        metrics.RESULT_CACHE_TENANT_BYTES.labels(tenant).set(resident)

    def _cache_overage_locked(self, st: _TenantState, cfg) -> int:
        """Bytes of this tenant's cached results that live queries now
        need: reservations + cache over quota. Reclaimed outside the lock
        (cache bytes always yield to live queries — they never block an
        admission)."""
        quota = self._mem_quota(st.policy, cfg)
        if quota is None or not st.cache_bytes:
            return 0
        return max(st.mem_reserved + st.cache_bytes - quota, 0)

    @staticmethod
    def _reclaim_cache(tenant: str, nbytes: int) -> None:
        if nbytes <= 0:
            return
        from daft_tpu_torch import plancache

        plancache.get_result_cache().shrink_tenant(tenant, nbytes)

    # -- admission --------------------------------------------------------- #
    def admit(self, query_id: str, tenant: Optional[str] = None,
              token=None, cfg=None,
              mem_hint: Optional[int] = None) -> AdmissionTicket:
        """Admit ``query_id`` for ``tenant``, blocking in the tenant's
        bounded queue when its quota is saturated. Raises
        ``DaftAdmissionError`` (fast), ``DaftCancelledError``, or
        ``DaftTimeoutError``. The returned ticket MUST be released on every
        exit path."""
        from daft_tpu_torch.context import get_context

        if cfg is None:
            cfg = get_context().execution_config
        if not getattr(cfg, "admission_enabled", True):
            return AdmissionTicket(query_id, tenant or DEFAULT_TENANT)
        # Nested-query bypass: a query issued from INSIDE another query's
        # execution scope (ambient cancel token of a different query id —
        # e.g. a subscriber or analysis pass collecting mid-iteration)
        # rides its parent's admission slot. Queueing it against the same
        # tenant quota the parent holds would deadlock the pair.
        from daft_tpu_torch.cancellation import current_token

        amb = current_token()
        if amb is not None and amb.query_id and amb.query_id != query_id:
            return AdmissionTicket(query_id, tenant or DEFAULT_TENANT)
        if token is not None:
            # An already-cancelled/expired query must fail with ITS error,
            # not be misread as deadline-too-short (a DaftAdmissionError is
            # transient — clients would retry work the cancel meant to stop).
            token.check("admission")
        tenant = resolve_tenant(tenant)
        t0 = time.monotonic()
        events: List[object] = []
        reject: Optional[DaftAdmissionError] = None
        ticket: Optional[AdmissionTicket] = None
        waiter: Optional[_Waiter] = None
        reclaim = 0
        with self._cond:
            self._sync_policies(cfg)
            st = self._state(tenant)
            pol = st.policy
            prio = self._effective_priority(pol)
            self._refresh_signals_locked(cfg)
            level = self._shed_level
            max_c = self._max_concurrent(pol, cfg)
            depth = self._queue_depth(pol, cfg)
            quota = self._mem_quota(pol, cfg)
            share = self._share_for(cfg, quota, mem_hint) \
                if quota is not None else 0
            slots_free = (max_c <= 0 or len(st.running) < max_c)
            # Cache bytes do NOT gate here: they are reclaimable (evicted
            # below, outside the lock) — only live reservations can block.
            mem_free = (quota is None or st.mem_reserved + share <= quota)
            # Shed ladder, most severe first. Positive-priority tenants ride
            # out every level; negative-priority tenants go first.
            if quota is not None and share > quota:
                # Unsatisfiable: the per-query reservation can NEVER fit
                # this tenant's budget, even with zero queries running —
                # enqueueing would wait forever. Fail fast with the policy
                # problem spelled out.
                reject = DaftAdmissionError(
                    f"query {query_id} for tenant {tenant!r} rejected: "
                    f"per-query memory reservation {share} exceeds the "
                    f"tenant's whole quota {quota} "
                    f"(max_memory_fraction too small for this "
                    f"DAFT_MEMORY_LIMIT)",
                    tenant=tenant, reason=REASON_OVERLOAD,
                    queue_depth=len(st.queue), retry_after_s=0.05)
                from daft_tpu_torch import metrics
                from daft_tpu_torch.subscribers.events import QueryShed

                metrics.ADMISSION_REJECTED.labels(
                    tenant, REASON_OVERLOAD).inc()
                events.append(QueryShed(
                    query_id=query_id, tenant=tenant, reason=REASON_OVERLOAD,
                    queue_depth=len(st.queue), retry_after_s=0.05))
            elif level >= 3 and prio <= 0:
                reject = self._reject_locked(st, cfg, query_id,
                                             REASON_OVERLOAD, events)
            elif level >= 1 and prio < 0:
                reject = self._reject_locked(st, cfg, query_id,
                                             REASON_SHED_PRIORITY, events)
            elif level >= 1 and not (slots_free and mem_free) \
                    and prio <= 0:
                # Over-quota work that would have queued is shed instead.
                reject = self._reject_locked(st, cfg, query_id,
                                             REASON_SHED_OVER_QUOTA, events)
            elif slots_free and mem_free and not st.queue:
                ticket = self._admit_locked(st, query_id, tenant, share,
                                            wait_s=0.0, level=level, cfg=cfg,
                                            events=events)
                reclaim = self._cache_overage_locked(st, cfg)
            elif len(st.queue) >= depth:
                # Must wait, but the bounded queue is full -> fast rejection.
                reject = self._reject_locked(st, cfg, query_id,
                                             REASON_QUEUE_FULL, events)
            else:
                # Deadline-aware: if the remaining budget cannot cover the
                # estimated queue wait, reject NOW instead of enqueueing a
                # query that can only time out.
                est_wait = self._estimated_wait_locked(st, max_c)
                remaining = token.remaining() if token is not None else None
                if remaining is not None and remaining < est_wait:
                    reject = self._reject_locked(
                        st, cfg, query_id, REASON_DEADLINE, events,
                        retry_after_s=est_wait)
                else:
                    waiter = _Waiter(query_id, tenant, token,
                                     mem_hint=mem_hint)
                    st.queue.append(waiter)
                    qdepth = len(st.queue)
                    from daft_tpu_torch import metrics

                    metrics.ADMISSION_QUEUE_DEPTH.labels(tenant).set(qdepth)
        # Lock released: emit events (subscribers take their own locks),
        # then raise / return / start the queue wait.
        if reject is not None:
            self._emit(events)
            raise reject
        if ticket is not None:
            self._emit(events)
            # Cached results occupying quota headroom a live query now
            # needs are evicted here — outside the controller lock (the
            # cache takes its own lock and calls back into this one).
            self._reclaim_cache(tenant, reclaim)
            return ticket
        from daft_tpu_torch.subscribers.events import QueryQueued

        self._emit(events + [QueryQueued(query_id=query_id, tenant=tenant,
                                         queue_depth=qdepth)])
        # The JAX package fires its fault point ``admission.enqueue`` here,
        # after the waiter is linked: the fault machinery is ROADMAP A.8.5.
        # Whatever the wait raises dequeues first, so no queue slot leaks.
        try:
            return self._wait_for_slot(st, waiter, cfg, t0)
        except BaseException:
            self._dequeue(st, waiter)
            raise

    def _wait_for_slot(self, st: _TenantState, waiter: _Waiter, cfg,
                       t0: float) -> AdmissionTicket:
        """Block until ``waiter`` reaches the head of its tenant queue and a
        slot + memory reservation free up; deadline/cancel-aware."""
        token = waiter.token
        woken = None
        if token is not None:
            def woken():
                with self._cond:
                    self._cond.notify_all()

            token.add_listener(woken)
        try:
            with self._cond:
                while True:
                    if token is not None:
                        err = token.error("admission wait")
                        if err is not None:
                            # Dequeued by the outer except-path; annotate so
                            # callers see the query never ran.
                            prog = getattr(err, "progress", None)
                            if isinstance(prog, dict):
                                prog["queued"] = True
                                prog["queue_depth"] = len(st.queue)
                            else:
                                err.progress = {"queued": True,
                                                "queue_depth": len(st.queue)}
                            raise err
                    pol = st.policy
                    max_c = self._max_concurrent(pol, cfg)
                    quota = self._mem_quota(pol, cfg)
                    share = self._share_for(cfg, quota, waiter.mem_hint) \
                        if quota is not None else 0
                    if quota is not None and share > quota:
                        # A mid-wait policy/limit change made the quota
                        # unsatisfiable: waiting longer can never succeed.
                        raise DaftAdmissionError(
                            f"query {waiter.query_id} for tenant "
                            f"{waiter.tenant!r} dequeued: per-query memory "
                            f"reservation {share} exceeds the tenant's "
                            f"whole quota {quota}",
                            tenant=waiter.tenant, reason=REASON_OVERLOAD,
                            queue_depth=len(st.queue), retry_after_s=0.05)
                    at_head = st.queue and st.queue[0] is waiter
                    slots_free = (max_c <= 0 or len(st.running) < max_c)
                    mem_free = (quota is None
                                or st.mem_reserved + share <= quota)
                    if at_head and slots_free and mem_free:
                        st.queue.popleft()
                        waiter.admitted = True
                        self._refresh_signals_locked(cfg)
                        wait_s = time.monotonic() - t0
                        events: List[object] = []
                        ticket = self._admit_locked(
                            st, waiter.query_id, waiter.tenant, share,
                            wait_s=wait_s, level=self._shed_level, cfg=cfg,
                            events=events)
                        reclaim = self._cache_overage_locked(st, cfg)
                        break
                    timeout = 0.5
                    if token is not None:
                        rem = token.remaining()
                        if rem is not None:
                            timeout = min(timeout, max(rem, 0.0))
                    self._cond.wait(timeout)
            self._emit(events)
            self._reclaim_cache(waiter.tenant, reclaim)
            return ticket
        finally:
            if woken is not None:
                token.remove_listener(woken)

    def _admit_locked(self, st: _TenantState, query_id: str, tenant: str,
                      share: int, wait_s: float, level: int, cfg,
                      events: List[object]) -> AdmissionTicket:
        cap = None
        if level >= 2:
            cap = max(1, _resolved_compute_threads(cfg) // 2)
        st.running[query_id] = share
        st.mem_reserved += share
        ticket = AdmissionTicket(query_id, tenant, wait_s=wait_s,
                                 compute_threads_cap=cap, mem_reserved=share,
                                 controller=self)
        from daft_tpu_torch import metrics
        from daft_tpu_torch.subscribers.events import QueryAdmitted

        metrics.ADMISSION_ADMITTED.labels(tenant).inc()
        metrics.ADMISSION_ACTIVE.labels(tenant).set(len(st.running))
        metrics.ADMISSION_QUEUE_DEPTH.labels(tenant).set(len(st.queue))
        metrics.ADMISSION_WAIT.observe(wait_s)
        events.append(QueryAdmitted(
            query_id=query_id, tenant=tenant, wait_s=wait_s,
            shed_level=level, compute_threads_cap=cap or 0))
        return ticket

    def _reject_locked(self, st: _TenantState, cfg, query_id: str,
                       reason: str, events: List[object],
                       retry_after_s: Optional[float] = None
                       ) -> DaftAdmissionError:
        """Build (and count) a fast rejection; caller raises it. The
        returned error carries queue depth + a suggested retry-after so
        clients back off instead of hammering the front door."""
        tenant = st.policy.tenant
        depth = len(st.queue)
        if retry_after_s is None:
            retry_after_s = self._estimated_wait_locked(
                st, self._max_concurrent(st.policy, cfg))
        retry_after_s = max(retry_after_s, 0.05)
        from daft_tpu_torch import metrics
        from daft_tpu_torch.subscribers.events import QueryShed

        metrics.ADMISSION_REJECTED.labels(tenant, reason).inc()
        events.append(QueryShed(query_id=query_id, tenant=tenant,
                                reason=reason, queue_depth=depth,
                                retry_after_s=retry_after_s))
        return DaftAdmissionError(
            f"query {query_id} for tenant {tenant!r} rejected at admission "
            f"({reason}): queue depth {depth}, retry after "
            f"~{retry_after_s:.2f}s",
            tenant=tenant, reason=reason, queue_depth=depth,
            retry_after_s=retry_after_s)

    def _estimated_wait_locked(self, st: _TenantState, max_c: int) -> float:
        """Expected queue wait for a NEW waiter: queue position ahead of it
        times the EWMA query duration, divided by the tenant's service
        rate (its concurrency)."""
        lanes = max(max_c, 1) if max_c > 0 else max(len(st.running), 1)
        return (len(st.queue) + 1) * self._avg_query_s / lanes

    def _dequeue(self, st: _TenantState, waiter: _Waiter) -> None:
        with self._cond:
            if waiter.admitted:
                return
            try:
                st.queue.remove(waiter)
            except ValueError:
                pass
            depth = len(st.queue)
            self._cond.notify_all()
        from daft_tpu_torch import metrics

        metrics.ADMISSION_QUEUE_DEPTH.labels(waiter.tenant).set(depth)

    def _release(self, ticket: AdmissionTicket) -> None:
        with self._cond:
            st = self._tenants.get(ticket.tenant)
            if st is None:
                return
            share = st.running.pop(ticket.query_id, None)
            if share is None:
                return
            st.mem_reserved = max(0, st.mem_reserved - share)
            dur = time.monotonic() - ticket._admitted_at
            # EWMA (alpha .2): recent behavior dominates, one outlier can't
            # poison the queue-wait estimator.
            self._avg_query_s += 0.2 * (dur - self._avg_query_s)
            active = len(st.running)
            self._cond.notify_all()
        from daft_tpu_torch import metrics

        metrics.ADMISSION_ACTIVE.labels(ticket.tenant).set(active)

    @staticmethod
    def _emit(events: List[object]) -> None:
        if not events:
            return
        from daft_tpu_torch.context import get_context

        notify = get_context().notify
        for e in events:
            notify(e)

    # -- introspection ------------------------------------------------------ #
    def snapshot(self) -> Dict[str, dict]:
        """Per-tenant admission state for the dashboard panel / load tools."""
        with self._cond:
            out = {}
            for tenant, st in sorted(self._tenants.items()):
                out[tenant] = {
                    "tenant": tenant,
                    "running": len(st.running),
                    "queued": len(st.queue),
                    "mem_reserved": st.mem_reserved,
                    "cache_bytes": st.cache_bytes,
                    "max_concurrent": st.policy.max_concurrent_queries,
                    "priority": st.policy.priority,
                }
            return out

    def totals(self) -> dict:
        with self._cond:
            return {
                "running": sum(len(st.running)
                               for st in self._tenants.values()),
                "queued": sum(len(st.queue)
                              for st in self._tenants.values()),
                "mem_reserved": sum(st.mem_reserved
                                    for st in self._tenants.values()),
                "cache_bytes": sum(st.cache_bytes
                                   for st in self._tenants.values()),
                "shed_level": self._shed_level,
            }

    def reset(self) -> None:
        """Drop all tenant state (tests). Queued waiters are woken so they
        re-check their tokens; live tickets release into nothing."""
        with self._cond:
            self._tenants.clear()
            self._policy_overrides.clear()
            self._policies_cfg_id = None
            self._config_policies = {}
            self._shed_level = 0
            self._avg_query_s = 1.0
            self._hist_base = None
            self._hist_read_at = 0.0
            self._cond.notify_all()


def _resolved_compute_threads(cfg) -> int:
    n = getattr(cfg, "num_compute_threads", 0)
    return n if n > 0 else (os.cpu_count() or 1)


# --------------------------------------------------------------------- #
# Process-global controller + tenant identity                             #
# --------------------------------------------------------------------- #
_CONTROLLER: Optional[AdmissionController] = None
_controller_lock = threading.Lock()


def get_controller() -> AdmissionController:
    """THE process admission controller (one front door per process, like
    the MemoryManager behind it)."""
    global _CONTROLLER
    if _CONTROLLER is None:
        with _controller_lock:
            if _CONTROLLER is None:
                _CONTROLLER = AdmissionController()
    return _CONTROLLER


def set_tenant_policy(tenant: str, *, max_concurrent_queries: int = 0,
                      max_memory_fraction: float = 1.0, queue_depth: int = 0,
                      priority: int = 0, slo_latency_p99_s: float = 0.0,
                      slo_error_rate: float = 0.0,
                      slo_staleness_p99_s: float = 0.0) -> None:
    """Convenience: install a per-tenant policy on the process controller."""
    get_controller().set_policy(TenantPolicy(
        tenant=tenant, max_concurrent_queries=max_concurrent_queries,
        max_memory_fraction=max_memory_fraction, queue_depth=queue_depth,
        priority=priority, slo_latency_p99_s=slo_latency_p99_s,
        slo_error_rate=slo_error_rate,
        slo_staleness_p99_s=slo_staleness_p99_s))


_tenant_var: contextvars.ContextVar[Optional[str]] = \
    contextvars.ContextVar("daft_tenant", default=None)
_request_priority_var: contextvars.ContextVar[Optional[int]] = \
    contextvars.ContextVar("daft_request_priority", default=None)


def set_request_priority(priority: Optional[int]) -> None:
    """Attach a per-request priority to queries issued from this context
    (the network front door's lever). Admission uses
    ``min(policy.priority, request priority)`` — a request can only lower
    its own standing on the shed ladder, never rise above its tenant's
    policy. ``None`` clears."""
    _request_priority_var.set(priority)


def set_tenant(tenant: Optional[str]) -> None:
    """Set the calling context's tenant identity (``daft_tpu_torch.set_tenant``).
    Thread-scoped via contextvar: concurrent serving threads each carry
    their own. ``None`` clears back to ``DAFT_TENANT`` / default."""
    _tenant_var.set(tenant)


def current_tenant() -> str:
    return resolve_tenant(None)


def resolve_tenant(tenant: Optional[str]) -> str:
    """Explicit arg > ``set_tenant()`` contextvar > ``DAFT_TENANT`` env >
    ``default``."""
    if tenant:
        return tenant
    ctx_tenant = _tenant_var.get()
    if ctx_tenant:
        return ctx_tenant
    from daft_tpu_torch.config import daft_env

    return daft_env("DAFT_TENANT") or DEFAULT_TENANT
