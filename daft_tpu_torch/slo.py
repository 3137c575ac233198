"""The per-tenant SLO plane: rolling latency percentiles, burn-rate alerts
and the tail-based auto-profiling sampler (port of ``daft_tpu/slo.py``,
less the views' ``FreshnessTracker``, which is ROADMAP A.8.6).

Fed by the flight recorder (``querylog.py``): every query's record is
observed here, so the plane covers every outcome.

* **Rolling per-tenant health**: bounded windows of (time, duration,
  badness) per tenant; p50 / p95 / p99 latency, error and shed rates over
  the slow window, exported as ``daft_slo_*`` gauges and served at
  ``/api/slo``.
* **Burn-rate alerting** (the multiwindow scheme): a query is bad when it
  failed, timed out, was shed or finished over its tenant's latency
  objective (a user's cancel is left out). The burn rate is the bad
  fraction over ``slo_error_rate``; when both the fast window (60 s, 14x)
  and the slow one (300 s, 6x) trip, one ``SLOBurnRateAlert`` fires for
  the episode, which ends when the fast window drops under 1x. Objectives
  come from the config, overridden per tenant by the admission policy JSON.
* **Tail-based auto-profiling**: a record over its tenant's objective (or
  over ``slo_slow_query_s``) arms its plan fingerprint, and the next
  ``slo_autoprofile_count`` queries of that fingerprint are profiled
  (``querylog.maybe_autoprofile`` consumes the budget after planning).

Each evaluation scans the window, and evaluations are throttled per tenant
(``_EVAL_REFRESH_S``), so a burst of queries costs ring appends, not
repeated scans.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Dict, List, Optional

log = logging.getLogger("daft_tpu_torch.slo")

#: Per-tenant observation window capacity. At serving rates the time
#: windows bound relevance; this bounds MEMORY when a tenant fires faster
#: than the slow window drains.
WINDOW_CAPACITY = 4096

#: Minimum records inside a window before its burn rate is believed — a
#: single failed query must not page anyone.
MIN_SAMPLES = 10

#: Cap on tenants tracked (label-cardinality discipline: caller-supplied
#: tenant names must not grow gauges without bound). Oldest-idle evicted.
MAX_TENANTS = 256

_EVAL_REFRESH_S = 0.25


def _objectives_for(tenant: str, cfg) -> tuple:
    """(latency_objective_s, error_rate_objective) for a tenant: admission-
    policy overrides (the one place per-tenant config already lives) above
    config defaults."""
    lat = rate = 0.0
    try:
        from daft_tpu_torch.execution.admission import get_controller

        pol = get_controller().policy_for(tenant)
        lat = float(getattr(pol, "slo_latency_p99_s", 0.0) or 0.0)
        rate = float(getattr(pol, "slo_error_rate", 0.0) or 0.0)
    except Exception:
        # A policy-layer failure must not take the SLO plane down with it;
        # the config defaults below still apply. Logged: a silently-default
        # objective is an alerting trap.
        log.warning("SLO objective lookup failed for tenant %r", tenant,
                    exc_info=True)
    if lat <= 0:
        lat = float(getattr(cfg, "slo_latency_p99_s", 30.0) or 30.0)
    if rate <= 0:
        rate = float(getattr(cfg, "slo_error_rate", 0.05) or 0.05)
    return lat, rate


class _TenantWindow:
    """One tenant's rolling observations + alert state."""

    __slots__ = ("records", "alerting", "alerts_fired", "last_eval",
                 "last_seen", "fast_burn", "slow_burn", "bad_fast",
                 "bad_slow", "pending")

    def __init__(self):
        # (monotonic_ts, duration_s, bad, shed, counted) triples-ish; a
        # deque maxlen bounds memory, the time windows bound relevance.
        self.records: deque = deque(maxlen=WINDOW_CAPACITY)
        self.alerting = False
        self.alerts_fired = 0
        self.last_eval = 0.0
        self.last_seen = time.monotonic()
        self.fast_burn = 0.0
        self.slow_burn = 0.0
        self.bad_fast = 0.0
        self.bad_slow = 0.0
        # Records since the last evaluation: bursts faster than the time
        # throttle still evaluate every MIN_SAMPLES records, so a storm
        # that finishes inside one throttle period cannot slip past the
        # alert unevaluated.
        self.pending = 0


class SLOTracker:
    """THE process SLO tracker (fed by the flight recorder; one per
    process, like the recorder itself)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._tenants: Dict[str, _TenantWindow] = {}
        # plan_fingerprint -> remaining auto-profile captures.
        self._armed: Dict[str, int] = {}
        self._armed_total = 0

    # -- ingestion --------------------------------------------------------
    def observe(self, record: dict, cfg) -> None:
        """Fold one flight record in; may emit an alert event + metric
        updates (outside the lock)."""
        tenant = record.get("tenant") or "default"
        outcome = record.get("outcome", "")
        duration = float(record.get("duration_s", 0.0))
        lat_obj, rate_obj = _objectives_for(tenant, cfg)
        if outcome == "cancelled":
            # Client-caused: excluded from the SLO arithmetic entirely
            # (counting user cancels as either good or bad lets a client
            # move a tenant's burn rate without the engine misbehaving).
            bad = None
        else:
            bad = (outcome in ("failed", "timeout", "shed")
                   or duration > lat_obj)
        now = time.monotonic()
        alert_event = None
        with self._lock:
            win = self._tenants.get(tenant)
            if win is None:
                self._evict_idle_locked()
                win = self._tenants[tenant] = _TenantWindow()
            win.last_seen = now
            if bad is not None:
                win.records.append(
                    (now, duration, bad, outcome == "shed",
                     outcome != "shed"))
                win.pending += 1
            # Time throttle (steady state) OR sample-count trigger (burst):
            # both cap the O(window) scan's amortized cost while making
            # sure neither a slow trickle nor a sub-throttle storm goes
            # unevaluated.
            if now - win.last_eval >= _EVAL_REFRESH_S \
                    or win.pending >= MIN_SAMPLES:
                win.last_eval = now
                win.pending = 0
                alert_event = self._evaluate_locked(tenant, win, cfg,
                                                    rate_obj, lat_obj, now)
        # Tail sampler: a too-slow COMPLETED query (not a shed — those never
        # planned, their fingerprint is empty anyway) arms its fingerprint.
        self._maybe_arm(record, duration, lat_obj, cfg)
        if alert_event is not None:
            self._emit(alert_event)

    def _evict_idle_locked(self) -> None:
        while len(self._tenants) >= MAX_TENANTS:
            idle = min(self._tenants, key=lambda t: self._tenants[t].last_seen)
            del self._tenants[idle]

    # -- burn-rate math ----------------------------------------------------
    @staticmethod
    def _bad_fraction(win: _TenantWindow, now: float, window_s: float
                      ) -> tuple:
        """(bad_fraction, n) over the trailing ``window_s`` seconds."""
        cutoff = now - window_s
        n = bad = 0
        for ts, _dur, is_bad, _shed, _counted in reversed(win.records):
            if ts < cutoff:
                break
            n += 1
            bad += 1 if is_bad else 0
        return (bad / n if n else 0.0), n

    def _evaluate_locked(self, tenant: str, win: _TenantWindow, cfg,
                         rate_obj: float, lat_obj: float, now: float):
        fast_w = float(getattr(cfg, "slo_fast_window_s", 60.0))
        slow_w = float(getattr(cfg, "slo_slow_window_s", 300.0))
        fast_thr = float(getattr(cfg, "slo_fast_burn", 14.0))
        slow_thr = float(getattr(cfg, "slo_slow_burn", 6.0))
        win.bad_fast, n_fast = self._bad_fraction(win, now, fast_w)
        win.bad_slow, n_slow = self._bad_fraction(win, now, slow_w)
        budget = max(rate_obj, 1e-9)
        win.fast_burn = win.bad_fast / budget
        win.slow_burn = win.bad_slow / budget
        from daft_tpu_torch import metrics

        metrics.SLO_BURN_RATE.labels(tenant, "fast").set(win.fast_burn)
        metrics.SLO_BURN_RATE.labels(tenant, "slow").set(win.slow_burn)
        metrics.SLO_ERROR_RATE.labels(tenant).set(win.bad_slow)
        tripped = (n_fast >= MIN_SAMPLES and win.fast_burn >= fast_thr
                   and n_slow >= MIN_SAMPLES and win.slow_burn >= slow_thr)
        if tripped and not win.alerting:
            win.alerting = True
            win.alerts_fired += 1
            metrics.SLO_ALERTS.labels(tenant).inc()
            from daft_tpu_torch.subscribers.events import SLOBurnRateAlert

            return SLOBurnRateAlert(
                tenant=tenant, fast_burn_rate=round(win.fast_burn, 3),
                slow_burn_rate=round(win.slow_burn, 3),
                bad_fraction=round(win.bad_fast, 4),
                error_rate_objective=rate_obj,
                latency_objective_s=lat_obj,
                window_s=fast_w)
        if win.alerting and win.fast_burn < 1.0:
            # Episode over: burning under budget again. Hysteresis — the
            # alert does not flap between 13.9x and 14.1x.
            win.alerting = False
        return None

    @staticmethod
    def _emit(event) -> None:
        from daft_tpu_torch.context import get_context

        log.warning("SLO burn-rate alert: tenant=%s fast=%.1fx slow=%.1fx",
                    event.tenant, event.fast_burn_rate, event.slow_burn_rate)
        get_context().notify(event)

    # -- tail-based auto-profiling ----------------------------------------
    def _maybe_arm(self, record: dict, duration: float, lat_obj: float,
                   cfg) -> None:
        fp = record.get("plan_fingerprint") or ""
        if not fp or record.get("autoprofiled"):
            # An auto-profiled run re-arming its own fingerprint would
            # profile that shape forever.
            return
        if record.get("outcome") not in ("success", "timeout"):
            # Only queries that actually RAN slow arm the sampler: a shed
            # never planned, a user cancel says nothing about the shape
            # (the SLO math excludes it for the same reason), and a failed
            # query's duration measures the failure, not the plan. A
            # timeout is the slowest completion there is — exactly the
            # shape worth a trace.
            return
        slow_thr = float(getattr(cfg, "slo_slow_query_s", 0.0) or 0.0)
        slow = duration > lat_obj or (slow_thr > 0 and duration > slow_thr)
        if not slow:
            return
        n = int(getattr(cfg, "slo_autoprofile_count", 3) or 0)
        if n <= 0:
            return
        with self._lock:
            armed_now = fp not in self._armed
            if armed_now:
                self._armed[fp] = n
                self._armed_total += 1
                # Bounded: a pathological workload of unique slow shapes
                # must not grow the armed table forever.
                while len(self._armed) > 64:
                    self._armed.pop(next(iter(self._armed)))
        if armed_now:
            log.info("tail-sampling: armed fingerprint %s for %d captures "
                     "(%.3fs > objective)", fp, n, duration)

    def consume_autoprofile(self, fingerprint: str) -> bool:
        """True exactly ``slo_autoprofile_count`` times per armed
        fingerprint — the recorder's post-planning check."""
        with self._lock:
            left = self._armed.get(fingerprint)
            if not left:
                return False
            if left <= 1:
                del self._armed[fingerprint]
            else:
                self._armed[fingerprint] = left - 1
            return True

    def autoprofile_state(self) -> dict:
        with self._lock:
            return {"armed": dict(self._armed),
                    "armed_total": self._armed_total}

    # -- introspection (/api/slo) -----------------------------------------
    def snapshot(self, cfg=None) -> List[dict]:
        """Per-tenant SLO table: rolling percentiles over the slow window,
        error/shed rates, both burn rates, alert state + episode count, and
        the resolved objectives."""
        if cfg is None:
            from daft_tpu_torch.context import get_context

            cfg = get_context().execution_config
        now = time.monotonic()
        slow_w = float(getattr(cfg, "slo_slow_window_s", 300.0))
        with self._lock:
            tenants = list(self._tenants.items())
        out = []
        alerts = []
        for tenant, win in sorted(tenants):
            lat_obj, rate_obj = _objectives_for(tenant, cfg)
            # A scrape is an evaluation (the Prometheus-rule model): burn
            # rates and alert state are re-derived from the CURRENT
            # windows, so the panel is never a stale snapshot of whenever
            # the last query happened to land.
            with self._lock:
                win.last_eval = now
                win.pending = 0
                ev = self._evaluate_locked(tenant, win, cfg, rate_obj,
                                           lat_obj, now)
            if ev is not None:
                alerts.append(ev)
            cutoff = now - slow_w
            durs: List[float] = []
            n = bad = shed = 0
            for ts, dur, is_bad, is_shed, counted in reversed(win.records):
                if ts < cutoff:
                    break
                n += 1
                bad += 1 if is_bad else 0
                shed += 1 if is_shed else 0
                if counted:
                    durs.append(dur)
            durs.sort()

            def pct(q: float) -> float:
                if not durs:
                    return 0.0
                return durs[min(int(q * len(durs)), len(durs) - 1)]

            from daft_tpu_torch import metrics

            p99 = pct(0.99)
            metrics.SLO_LATENCY_P99.labels(tenant).set(p99)
            out.append({
                "tenant": tenant,
                "window_s": slow_w,
                "queries": n,
                "latency_p50_s": round(pct(0.5), 6),
                "latency_p95_s": round(pct(0.95), 6),
                "latency_p99_s": round(p99, 6),
                "error_rate": round(bad / n, 4) if n else 0.0,
                "shed_rate": round(shed / n, 4) if n else 0.0,
                "fast_burn_rate": round(win.fast_burn, 3),
                "slow_burn_rate": round(win.slow_burn, 3),
                "alerting": win.alerting,
                "alerts_fired": win.alerts_fired,
                "objective_latency_p99_s": lat_obj,
                "objective_error_rate": rate_obj,
            })
        for ev in alerts:
            self._emit(ev)
        return out

    def reset(self) -> None:
        with self._lock:
            self._tenants.clear()
            self._armed.clear()
            self._armed_total = 0


_TRACKER: Optional[SLOTracker] = None
_tracker_lock = threading.Lock()


def get_tracker() -> SLOTracker:
    global _TRACKER
    if _TRACKER is None:
        with _tracker_lock:
            if _TRACKER is None:
                _TRACKER = SLOTracker()
    return _TRACKER
