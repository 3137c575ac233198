"""NativeRunner: single-host execution (port of ``daft_tpu/runners/native.py``;
reference: daft/runners/native_runner.py:69-200).

The front door (the flight record, the cancel token and the admission
ticket), then the result cache, the plan cache or a real optimize +
translate (``runner.plan_with_caches``),
then the executor's stream, emitting ``QueryStart`` / ``QueryEnd`` along the
way. The observability prologue and epilogue are the JAX native runner's:
``profiling.begin_query`` (a profile when ``collect(profile=...)``,
``DAFT_PROFILE`` or ``profile_enabled`` asks for one), the byte ledger and
its RSS sampler, ``QueryStart`` after planning, a ``RuntimeStats`` as
``last_query_stats``, the task profiler handed to the executor and made
ambient per resumption; on every exit the build handle aborted unless it
committed, the ticket released, the ledger closed against the ticket's
reservation, ``QueryEnd`` with the error, ``end_query`` and the query's one
flight record (with the finished profile's operator digest). A planning
failure closes the profile, the ticket, the ledger and the record too.
After planning, :func:`querylog.maybe_autoprofile` opens a profile for a
plan fingerprint the SLO plane armed. The feedback store's estimates and
its ``mem_hint`` are ROADMAP A.8.6.
"""

from __future__ import annotations

import time
import uuid
from typing import Iterator, Optional

from daft_tpu_torch.context import get_context, iter_with_frozen_clock
from daft_tpu_torch.micropartition import MicroPartition
from daft_tpu_torch.runners.runner import Runner, enter_front_door, plan_with_caches
from daft_tpu_torch.subscribers.events import QueryEnd, QueryStart


class NativeRunner(Runner):
    name = "native"

    def run_iter(self, builder, timeout: Optional[float] = None,
                 query_id: Optional[str] = None) -> Iterator[MicroPartition]:
        from daft_tpu_torch import profiling, querylog
        from daft_tpu_torch.cancellation import (
            iter_with_cancel_scope,
            register_query_token,
            unregister_query_token,
        )
        from daft_tpu_torch.execution.executor import Executor
        from daft_tpu_torch.execution.memledger import get_ledger
        from daft_tpu_torch.execution.resource_manager import RuntimeStats

        ctx = get_context()
        cfg = ctx.execution_config
        query_id = query_id or uuid.uuid4().hex[:16]
        prof = profiling.begin_query(query_id, cfg)
        token, ticket, cfg, fentry = enter_front_door(query_id, cfg, timeout,
                                                      runner=self.name)
        ledger = get_ledger()
        # The configuration can only turn the ledger off, and doing so drops
        # what it held, so no balance strands.
        if not cfg.memory_ledger_enabled and ledger.enabled:
            ledger.enabled = False
            ledger.reset()
        ledger.ensure_sampler(cfg)

        def finish_mem():
            # The ledger closes the query (force-draining any residue) and
            # reconciles its peak against the admission reservation; the
            # block lands on the flight record.
            mem = ledger.finish_query(query_id, reserved_bytes=ticket.mem_reserved,
                                      tenant=ticket.tenant)
            if fentry is not None:
                fentry.note_memory(mem)

        build = None
        try:
            physical, plan_repr, cached_parts, build = plan_with_caches(
                builder, cfg, prof, fentry, token, ticket.tenant)
            if fentry is not None and cached_parts is None:
                # The fingerprint exists only now: the first moment the tail
                # sampler can recognise a shape it armed after a slow run.
                fentry.observe_plan(plan_repr)
                if prof is None:
                    prof = querylog.maybe_autoprofile(query_id, fentry)
                fentry.profiled = prof is not None
        except BaseException as e:  # noqa: BLE001 — re-raised below
            # The execution try/finally below has not started: close the
            # profile, the ticket, the ledger and the record here, or a
            # planning failure leaks them.
            if build is not None:
                build.abort()
            ticket.release()
            finish_mem()
            profiling.end_query(query_id, error=str(e))
            querylog.finish_entry(fentry, error=e)
            raise
        ctx.notify(QueryStart(query_id=query_id, plan=plan_repr))
        start = time.perf_counter()
        error = None
        error_obj = None
        register_query_token(query_id, token)
        run = stream = None
        try:
            if cached_parts is not None:
                # Result-cache hit: stream the materialized partitions. The
                # deadline and a cancel are still observed per partition.
                for mp in cached_parts:
                    token.check("cached-result")
                    if fentry is not None:
                        fentry.count(mp)
                    yield mp
            else:
                stats = RuntimeStats(query_id)
                ctx.last_query_stats = stats  # DataFrame.metrics()
                tprof = prof.local_task_profiler() if prof is not None else None
                # The daft.execute span covers the generator's whole
                # lifetime; ambient=False keeps the profiler out of the
                # caller's context, where iter_with_profiler_scope sets it
                # per resumption.
                with profiling.profiled_task_scope(tprof, name="daft.execute", ambient=False):
                    run = Executor(cfg, cancel_token=token, stats=stats,
                                   profiler=tprof).run(physical)
                    # CURRENT_TIMESTAMP is one instant per statement, frozen
                    # per resumption as the cancel token and the profiler
                    # are.
                    stream = profiling.iter_with_profiler_scope(
                        iter_with_cancel_scope(iter_with_frozen_clock(run), token), tprof)
                    for mp in stream:
                        if fentry is not None:
                            fentry.count(mp)
                        if build is not None:
                            build.add(mp)
                        yield mp
                if build is not None:
                    # Reached only on a FULL drain: a partial iteration
                    # aborts in the finally instead, so no entry is partial.
                    build.commit()
        except BaseException as e:  # noqa: BLE001 — re-raised
            error = str(e)
            error_obj = e
            raise
        finally:
            if build is not None:
                build.abort()  # a no-op after commit
            for gen in (stream, run):
                if gen is not None:
                    gen.close()  # a failure or an abandoned iteration stops the pool now
            ticket.release()
            finish_mem()
            unregister_query_token(query_id)
            ctx.notify(QueryEnd(query_id=query_id, duration_s=time.perf_counter() - start,
                                error=error))
            # The query's one flight record, whatever the outcome, with the
            # finished profile's operator digest.
            querylog.finish_entry(fentry, error=error_obj,
                                  profile=profiling.end_query(query_id, error=error))
