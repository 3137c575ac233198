"""Morsel stream primitives (port of ``daft_tpu/execution/pipeline.py``).

This slice ports ``split_morsels``, the re-morselling step of the UDF
operator. Not ported yet: ``coalesce_morsels``/``morselize``,
``chunk_morsels``, and the stage machinery (``map_stage``, ``run_stage``,
``collect_parallel``) that runs morsels on a shared thread pool.
"""

from __future__ import annotations


def split_morsels(it, max_rows: int):
    """Split oversized morsels at ``max_rows`` boundaries; smaller morsels
    pass through untouched. Split points depend only on the incoming
    stream (deterministic across thread counts)."""
    for mp in it:
        n = len(mp)
        if n <= max_rows:
            yield mp
            continue
        for start in range(0, n, max_rows):
            yield mp.slice(start, min(max_rows, n - start))
