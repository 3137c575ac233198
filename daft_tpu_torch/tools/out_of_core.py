"""Queries under a memory limit, for ``chip_smoke.py``'s phases 15 and 16
and the tests: TPC-H q01, q18 and q21 in SQL (``tools/tpch_sql.py``) with the limit
at 1/8 of the tables' in-memory bytes, floored at 1 MiB, as the JAX
package's out-of-core benchmark sets it
(``tests/benchmarks/test_tpch_out_of_core.py``).

:func:`run` drives one query through the DataFrame API (``df_fn`` builds
it) under ``memory_limit(limit)`` and returns its rows with what the run
left behind: the spill counters, the byte ledger's ``mem`` block for the
query, the stage feeders' stall seconds per operator, the joins' routes,
the device layer's counters, the pinned staging bytes, the RSS growth over
the run (the ``RssSampler``'s high-water for the query less the RSS before
it; None when no sample fell inside the query), and the audit after the query (ledger held bytes, available permits,
spill directories still on disk). ``limit=None`` runs it without a limit.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Optional

QUERIES = ("q01", "q18", "q21")
LIMIT_FRACTION = 8
MIN_LIMIT_BYTES = 1 << 20


def tables_bytes(frames: dict) -> int:
    """The in-memory bytes of the tables behind ``frames`` (name ->
    DataFrame)."""
    return sum(p.size_bytes() for df in frames.values() for p in df.iter_partitions())


def limit_for(frames: dict) -> int:
    return max(tables_bytes(frames) // LIMIT_FRACTION, MIN_LIMIT_BYTES)


def run(df_fn: Callable, limit: Optional[int], timeout: Optional[float] = None,
        arrow: bool = False, parts: bool = False) -> dict:
    """Run ``df_fn()``'s query once under ``memory_limit(limit)``; its rows
    as a pydict, or with ``arrow`` as one Arrow table (for results of
    millions of rows), or with ``parts`` as one Arrow table per result
    partition (a repartition's)."""
    from daft_tpu_torch.micropartition import MicroPartition
    from daft_tpu_torch.execution.join_index import join_counters
    from daft_tpu_torch.execution.memledger import get_ledger, read_rss_bytes
    from daft_tpu_torch.execution.resource_manager import memory_limit
    from daft_tpu_torch.execution.spill import spill_metrics
    from daft_tpu_torch.ops import device_eval as de

    ledger = get_ledger()
    spill_metrics.reset()
    join_counters.reset()
    de.device_eval_counters.reset()
    stall0 = ledger.process_stats()["stall_s_by_op"]
    rss0 = read_rss_bytes()
    with memory_limit(limit) as mm:
        df = df_fn()
        t0 = time.perf_counter()
        try:
            df.collect(timeout=timeout)
            if parts:
                rows = [mp.to_arrow_table() for mp in df._result]
            elif arrow:
                rows = (MicroPartition.concat(df._result) if df._result
                        else MicroPartition.empty(df.schema)).to_arrow_table()
            else:
                rows = df.to_pydict()
        finally:
            wall = time.perf_counter() - t0
            available = mm.available_permits()
    mem = ledger.profile_for(df.query_id) or {}
    stall = {op: s - stall0.get(op, 0.0)
             for op, s in ledger.process_stats()["stall_s_by_op"].items()
             if s > stall0.get(op, 0.0)}
    return {
        "rows": rows, "wall_s": wall, "limit": limit, "spill": spill_metrics.snapshot(),
        "mem": mem, "stall_s_by_op": stall, "joins": join_counters.snapshot(),
        "counters": de.device_eval_counters.snapshot(), "pinned_bytes": de.pinned_bytes(),
        "rss_growth": mem["rss_peak_bytes"] - rss0 if mem.get("rss_peak_bytes") else None,
        "audit": audit(limit, available),
    }


def audit(limit: Optional[int], available: Optional[int]) -> dict:
    """What a finished query must leave at zero: the ledger's held bytes,
    the permits taken (``limit - available``) and the spill directories
    still on disk."""
    from daft_tpu_torch.execution.memledger import get_ledger
    from daft_tpu_torch.execution.spill import spill_metrics

    return {"held": get_ledger().total_held(),
            "permits_out": 0 if limit is None else limit - available,
            "spill_dirs": [d for d in spill_metrics.dirs() if os.path.exists(d)]}


def run_sql(dt, frames: dict, name: str, scale_factor: float, limit: Optional[int],
            timeout: Optional[float] = None) -> dict:
    """TPC-H ``name`` in SQL over ``frames`` (``tools/tpch.sql_frames``)."""
    from daft_tpu_torch.tools import tpch_sql

    text = tpch_sql.sql_text(name, scale_factor)
    return run(lambda: dt.sql(text, **frames), limit, timeout)
