"""Pluggable DataSource ABC (port of ``daft_tpu/io/source.py``; reference:
daft/io/source.py:27).

Third-party readers implement ``DataSource``/``DataSourceTask``; the engine
plans one scan task per DataSourceTask and streams MicroPartitions from
``execute()`` — same pushdown surface as file scans.
"""

from __future__ import annotations

from typing import Iterator, List, Optional

from daft_tpu_torch.micropartition import MicroPartition
from daft_tpu_torch.schema import Schema


class DataSourceTask:
    """One unit of scan work for a custom source."""

    def schema(self) -> Schema:
        raise NotImplementedError

    def execute(self) -> Iterator[MicroPartition]:
        raise NotImplementedError

    def estimate_size_bytes(self) -> Optional[int]:
        return None


class DataSource:
    @property
    def name(self) -> str:
        return type(self).__name__

    def schema(self) -> Schema:
        raise NotImplementedError

    def get_tasks(self, pushdowns=None) -> List[DataSourceTask]:
        raise NotImplementedError

    def display_name(self) -> str:
        return self.name


class _PythonScanInfo:
    """Adapter presenting a DataSource as a ScanInfo (io/scan.py surface)."""

    def __init__(self, source: DataSource):
        self.source = source
        self.schema = source.schema()
        self.file_format = "python_source"
        self.read_options: dict = {}

    def display_name(self) -> str:
        return f"source({self.source.display_name()})"

    def to_scan_tasks(self, pushdowns, cfg):
        from daft_tpu_torch.io.scan import ScanTask

        out = []
        for t in self.source.get_tasks(pushdowns):
            out.append(ScanTask([], "python_source", self.schema, pushdowns,
                                {"source_task": t}))
        return out


def read_source(source: DataSource):
    """Build a DataFrame over a custom DataSource (reference: daft.read_source)."""
    from daft_tpu_torch.dataframe.dataframe import DataFrame
    from daft_tpu_torch.logical.builder import LogicalPlanBuilder

    return DataFrame(LogicalPlanBuilder.scan(_PythonScanInfo(source)))
