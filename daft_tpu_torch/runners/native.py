"""NativeRunner: single-host execution (port of ``daft_tpu/runners/native.py``;
reference: daft/runners/native_runner.py:69-200).

The front door (the cancel token and the ticket), then the result cache,
the plan cache or a real optimize + translate (``runner.plan_with_caches``),
then the executor's stream, emitting ``QueryStart`` / ``QueryEnd`` along the
way. The observability prologue and epilogue are the JAX native runner's:
``profiling.begin_query`` (a profile when ``collect(profile=...)``,
``DAFT_PROFILE`` or ``profile_enabled`` asks for one), the byte ledger and
its RSS sampler, ``QueryStart`` after planning, a ``RuntimeStats`` as
``last_query_stats``, the task profiler handed to the executor and made
ambient per resumption; on every exit the build handle aborted unless it
committed, ``QueryEnd`` with the error, the ledger closed and
``end_query``. A planning failure closes the profile and the ledger too.
The flight record of each query is ROADMAP A.8.4, the feedback store's
estimates A.8.6.
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
        from daft_tpu_torch import profiling
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
        token, ticket, cfg, _ = enter_front_door(query_id, cfg, timeout)
        ledger = get_ledger()
        # The configuration can only turn the ledger off, and doing so drops
        # what it held, so no balance strands.
        if not cfg.memory_ledger_enabled and ledger.enabled:
            ledger.enabled = False
            ledger.reset()
        ledger.ensure_sampler(cfg)
        build = None
        try:
            physical, plan_repr, cached_parts, build = plan_with_caches(
                builder, cfg, prof, token, ticket.tenant)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            # The execution try/finally below has not started: close the
            # profile, the ticket and the ledger here, or a planning failure
            # leaks them.
            if build is not None:
                build.abort()
            ticket.release()
            ledger.finish_query(query_id)
            profiling.end_query(query_id, error=str(e))
            raise
        ctx.notify(QueryStart(query_id=query_id, plan=plan_repr))
        start = time.perf_counter()
        error = None
        register_query_token(query_id, token)
        run = stream = None
        try:
            if cached_parts is not None:
                # Result-cache hit: stream the materialized partitions. The
                # deadline and a cancel are still observed per partition.
                for mp in cached_parts:
                    token.check("cached-result")
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
                        if build is not None:
                            build.add(mp)
                        yield mp
                if build is not None:
                    # Reached only on a FULL drain: a partial iteration
                    # aborts in the finally instead, so no entry is partial.
                    build.commit()
        except BaseException as e:  # noqa: BLE001 — re-raised
            error = str(e)
            raise
        finally:
            if build is not None:
                build.abort()  # a no-op after commit
            for gen in (stream, run):
                if gen is not None:
                    gen.close()  # a failure or an abandoned iteration stops the pool now
            ticket.release()
            unregister_query_token(query_id)
            ledger.finish_query(query_id)
            ctx.notify(QueryEnd(query_id=query_id, duration_s=time.perf_counter() - start,
                                error=error))
            profiling.end_query(query_id, error=error)
