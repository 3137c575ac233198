"""The runner interface and the query prologue both runners share (port of
``daft_tpu/runners/runner.py``; reference: daft/runners/runner.py:26-61).

``enter_front_door`` opens the query's flight record, builds its one cancel
token and passes the admission gate; ``plan_with_caches`` serves a
result-cache hit, else a plan-cache hit, else optimizes and translates
under the ``daft.plan`` span.
"""

from __future__ import annotations

import contextlib
import logging
import time
from typing import Iterator, List, Optional

from daft_tpu_torch.micropartition import MicroPartition


class PartitionCacheEntry:
    """Materialised result partitions, cacheable on a DataFrame
    (reference: partition caching in src/daft-context/src/partition_cache.rs)."""

    def __init__(self, partitions: List[MicroPartition]):
        self.partitions = partitions

    def num_rows(self) -> int:
        return sum(len(p) for p in self.partitions)

    def size_bytes(self) -> int:
        return sum(p.size_bytes() for p in self.partitions)


def enter_front_door(query_id: str, cfg, timeout: Optional[float],
                     runner: str = "native"):
    """The shared query prologue, before any planning: open the query's
    flight-recorder entry (every query gets exactly one record, a query
    rejected here included), make the one cancel token (explicit timeout >
    ``query_timeout_s`` > unbounded) and pass the admission gate. Returns
    ``(token, ticket, cfg, entry)``: ``cfg`` carries the shed ladder's
    compute-thread cap when the ticket has one (the stage pool gives the
    same bytes at any count), ``entry`` is None when recording is off.

    On a failed admission the entry notes the wait, its record lands with
    the outcome the gate raised (``shed``, ``timeout`` or ``cancelled``)
    and the profile the caller opened is closed, so nothing leaks. The
    caller owns ``ticket.release()`` and ``querylog.finish_entry(entry)``
    on every later exit. The JAX package's ``mem_hint``, the feedback
    store's observed peak that sizes the reservation, is ROADMAP A.8.6."""
    from daft_tpu_torch import profiling, querylog
    from daft_tpu_torch.cancellation import CancelToken, Deadline
    from daft_tpu_torch.execution.admission import get_controller

    if timeout is None:
        timeout = cfg.query_timeout_s
    token = CancelToken(Deadline.after(timeout) if timeout is not None else None,
                        query_id=query_id)
    entry = querylog.get_recorder().begin(query_id, cfg, runner=runner)
    controller = get_controller()
    admit_t0 = time.monotonic()
    try:
        # May block in the tenant's bounded queue (deadline- and
        # cancel-aware), or raise: a shed query costs one lock acquisition,
        # never an optimizer pass.
        ticket = controller.admit(query_id, token=token, cfg=cfg)
    except BaseException as e:  # noqa: BLE001 — the record and profile must not leak
        if entry is not None:
            # The failed admission is the record's story: a query that
            # waited in the queue until its deadline must not read
            # admission_wait_s=0.
            entry.note_admission(time.monotonic() - admit_t0, controller.shed_level())
        querylog.finish_entry(entry, error=e)
        profiling.end_query(query_id, error=str(e))
        raise
    if entry is not None:
        entry.note_admission(ticket.wait_s, controller.shed_level())
    if ticket.compute_threads_cap:
        cfg = cfg.with_changes(num_compute_threads=ticket.compute_threads_cap)
    return token, ticket, cfg, entry


def plan_with_caches(builder, cfg, prof, fentry, token, tenant: str, key=None):
    """Result cache first, then the plan cache, then (and only then) a real
    optimize + translate under the ``daft.plan`` span.

    Returns ``(physical, plan_repr, cached_partitions, build_handle)``:

    * ``cached_partitions`` is not None on a **result-cache hit**: the
      runner streams them and never plans or executes (``physical`` is
      None; the flight record, ``fentry``, carries ``result_cache_hit``).
    * ``build_handle`` is not None when this query claimed the single-flight
      build of its key: the runner feeds it every partition it yields,
      commits on a FULL drain and aborts it in its ``finally``.
    * A **plan-cache hit** reuses the cached optimize + translate output;
      the ``daft.plan`` span is entered only on a miss.

    A key that cannot be computed runs the query uncached and logs it, as
    in the JAX package. The feedback store's corrected plans (the JAX
    package's ``fb_scope`` and its ``fp~eN`` plan keys) are ROADMAP A.8.6.
    """
    from daft_tpu_torch import plancache
    from daft_tpu_torch.physical.translate import translate

    use_plan = cfg.plan_cache_enabled
    use_result = cfg.result_cache_enabled
    if key is None and (use_plan or use_result):
        try:
            key = plancache.compute_query_key(builder.plan, cfg)
        except Exception:  # noqa: BLE001
            # An unfingerprintable plan runs uncached, never fails: the
            # cache is an optimization, not a gate.
            logging.getLogger("daft_tpu_torch.plancache").warning(
                "query key computation failed; running uncached", exc_info=True)
            key = None

    handle = None
    if use_result and key is not None and key.result_cacheable:
        outcome, payload = plancache.get_result_cache(cfg).lookup_or_claim(
            key.fp, plancache.KIND_RESULT, tenant, token=token)
        if outcome == "hit":
            if fentry is not None:
                fentry.observe_plan(payload.plan_repr)
                fentry.note_caches(result_hit=True)
            return None, payload.plan_repr, payload.partitions, None
        handle = payload

    try:
        use_plan = use_plan and key is not None and key.plan_cacheable
        pentry = plancache.get_plan_cache(cfg).get(key) if use_plan else None
        if pentry is not None:
            physical = pentry.physical
            plan_repr = pentry.plan_repr
            sources, roots = pentry.sources, pentry.roots
            if fentry is not None:
                fentry.note_caches(plan_hit=True)
        else:
            with contextlib.ExitStack() as plan_scope:
                if prof is not None:
                    plan_scope.enter_context(prof.driver_span("daft.plan"))
                optimized = builder.optimize()
                physical = translate(optimized.plan)
            plan_repr = repr(optimized.plan)
            sources = plancache.source_fingerprints(optimized.plan) \
                if key is not None and (use_plan or handle is not None) else []
            roots = key.roots if key is not None else []
            if use_plan:
                plancache.get_plan_cache(cfg).put(key, optimized.plan, physical, plan_repr)
        if handle is not None:
            handle.set_provenance(sources, roots, plan_repr)
    except BaseException:
        # A planning failure releases the single-flight claim, or every
        # later arrival of this shape waits out the claim's patience.
        if handle is not None:
            handle.abort()
        raise
    return physical, plan_repr, None, handle


class Runner:
    name = "base"

    def run_iter(self, builder, timeout: Optional[float] = None,
                 query_id: Optional[str] = None) -> Iterator[MicroPartition]:
        """Stream result partitions. ``timeout`` (seconds) bounds the whole
        query: on expiry it fails with DaftTimeoutError instead of running
        on. None falls back to ExecutionConfig.query_timeout_s
        (DAFT_QUERY_TIMEOUT_S); both None = unbounded. ``query_id`` names
        the query (``cancellation.cancel_query``); a fresh one by default."""
        raise NotImplementedError

    def run(self, builder, timeout: Optional[float] = None) -> PartitionCacheEntry:
        return PartitionCacheEntry(list(self.run_iter(builder, timeout=timeout)))
