"""DataFrame constructors (port of ``daft_tpu/dataframe/creation.py``;
reference: daft/convert.py): ``from_pydict``, ``from_pylist``, ``from_arrow``,
``from_pandas`` and ``range``, with the JAX package's schemas, partitions and
errors.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import pyarrow as pa

from daft_tpu_torch.dataframe.dataframe import DataFrame
from daft_tpu_torch.errors import DaftValueError
from daft_tpu_torch.logical.builder import LogicalPlanBuilder
from daft_tpu_torch.micropartition import MicroPartition


def from_pydict(data: Dict[str, Any]) -> DataFrame:
    mp = MicroPartition.from_pydict(data)
    return DataFrame(LogicalPlanBuilder.in_memory([mp], mp.schema))


def from_pylist(rows: Sequence[Dict[str, Any]]) -> DataFrame:
    if not rows:
        raise DaftValueError("from_pylist requires at least one row")
    keys = list(rows[0].keys())
    data = {k: [r.get(k) for r in rows] for k in keys}
    return from_pydict(data)


def from_arrow(tables) -> DataFrame:
    """One partition per Arrow table or record batch."""
    if isinstance(tables, (pa.Table, pa.RecordBatch)):
        tables = [tables]
    parts = [MicroPartition.from_arrow_table(
        t if isinstance(t, pa.Table) else pa.Table.from_batches([t])
    ) for t in tables]
    return DataFrame(LogicalPlanBuilder.in_memory(parts, parts[0].schema))


def from_pandas(dfs) -> DataFrame:
    """One partition per pandas DataFrame, its index dropped."""
    import pandas as pd

    if isinstance(dfs, pd.DataFrame):
        dfs = [dfs]
    return from_arrow([pa.Table.from_pandas(d, preserve_index=False) for d in dfs])


def range(start: int, end: Optional[int] = None, step: int = 1, partitions: int = 1) -> DataFrame:
    """An int64 ``id`` column of ``start, start + step, ... < end`` (``range(n)``
    counts from 0) in ``partitions`` nearly equal partitions."""
    import numpy as np

    if end is None:
        start, end = 0, start
    values = np.arange(start, end, step, dtype=np.int64)
    chunks = np.array_split(values, max(partitions, 1))
    parts = [MicroPartition.from_pydict({"id": c}) for c in chunks]
    return DataFrame(LogicalPlanBuilder.in_memory(parts, parts[0].schema))
