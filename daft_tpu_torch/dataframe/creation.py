"""DataFrame constructors (port of ``daft_tpu/dataframe/creation.py``;
reference: daft/convert.py). This slice ports ``from_pydict``; ``from_pylist``,
``from_arrow``, ``from_pandas`` and ``range`` are not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict

from daft_tpu_torch.dataframe.dataframe import DataFrame
from daft_tpu_torch.logical.builder import LogicalPlanBuilder
from daft_tpu_torch.micropartition import MicroPartition


def from_pydict(data: Dict[str, Any]) -> DataFrame:
    mp = MicroPartition.from_pydict(data)
    return DataFrame(LogicalPlanBuilder.in_memory([mp], mp.schema))
