"""Morsel stream primitives (port of ``daft_tpu/execution/pipeline.py``).

``split_morsels`` (the UDF operator's re-morselling), ``morselize`` (the
canonical input of a Project/Filter/Aggregate stage: split oversized, coalesce
undersized) and ``chunk_morsels`` (the aggregation's fixed row-chunks). Every
boundary is a pure function of the incoming stream. Not ported yet: the stage
machinery (``map_stage``, ``run_stage``, ``collect_parallel``) that runs
morsels on a shared thread pool.
"""

from __future__ import annotations

from typing import List


def split_morsels(it, max_rows: int):
    """Split oversized morsels at ``max_rows`` boundaries; smaller morsels
    pass through untouched."""
    for mp in it:
        n = len(mp)
        if n <= max_rows:
            yield mp
            continue
        for start in range(0, n, max_rows):
            yield mp.slice(start, min(max_rows, n - start))


def coalesce_morsels(it, min_rows: int):
    """Merge undersized morsels until they reach ``min_rows``. Zero-row
    morsels are absorbed; an empty or all-empty stream still yields its
    (empty) tail morsel so schema-only results survive."""
    pending: List = []
    pending_rows = 0
    emitted = False
    tail = None
    for mp in it:
        tail = mp
        n = len(mp)
        if n == 0:
            continue
        pending.append(mp)
        pending_rows += n
        if pending_rows >= min_rows:
            yield _concat(pending)
            pending, pending_rows = [], 0
            emitted = True
    if pending:
        yield _concat(pending)
    elif not emitted and tail is not None:
        yield tail


def _concat(parts):
    from daft_tpu_torch.micropartition import MicroPartition

    return parts[0] if len(parts) == 1 else MicroPartition.concat(parts)


def morselize(it, min_rows: int, max_rows: int):
    """Canonical stage-input morsel stream: split oversized, coalesce
    undersized."""
    if min_rows > 1:
        it = coalesce_morsels(it, min(min_rows, max_rows))
    return split_morsels(it, max_rows)


def chunk_morsels(it, chunk_rows: int):
    """Group a morsel stream into lists whose cumulative rows first exceed
    ``chunk_rows``: yields ``List[MicroPartition]``. The boundaries fix the
    association of the aggregation's float partial sums."""
    chunk: List = []
    rows = 0
    for mp in it:
        n = len(mp)
        if n == 0:
            continue
        chunk.append(mp)
        rows += n
        if rows > chunk_rows:
            yield chunk
            chunk, rows = [], 0
    if chunk:
        yield chunk
