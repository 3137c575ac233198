"""Mock data source with configurable failure injection (port of
``daft_tpu/io/mock.py``).

Reference: src/daft-io/src/mock.rs:19-130 — a mock ObjectSource emitting
transient/fatal errors on a schedule, used to test retry paths without real
object stores.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterator, List, Optional

from daft_tpu_torch.errors import DaftIOError, DaftTransientError
from daft_tpu_torch.io.source import DataSource, DataSourceTask
from daft_tpu_torch.micropartition import MicroPartition
from daft_tpu_torch.schema import Schema


class MockScanTask(DataSourceTask):
    def __init__(self, source: "MockSource", index: int, data: dict):
        self.source = source
        self.index = index
        self.data = data

    def schema(self) -> Schema:
        return self.source.schema()

    def execute(self) -> Iterator[MicroPartition]:
        self.source.record_attempt(self.index)
        failures = self.source.transient_failures.get(self.index, 0)
        if self.source.attempts(self.index) <= failures:
            raise DaftTransientError(
                f"mock transient failure #{self.source.attempts(self.index)} "
                f"for task {self.index}"
            )
        if self.index in self.source.fatal_tasks:
            raise DaftIOError(f"mock fatal failure for task {self.index}")
        yield MicroPartition.from_pydict(self.data)


class MockSource(DataSource):
    """``transient_failures[i] = n`` makes task i fail its first n attempts;
    ``fatal_tasks`` always fail."""

    def __init__(self, partitions: List[dict],
                 transient_failures: Optional[Dict[int, int]] = None,
                 fatal_tasks: Optional[set] = None):
        self.partitions = partitions
        self.transient_failures = transient_failures or {}
        self.fatal_tasks = fatal_tasks or set()
        import tempfile

        # Attempt counters are file-backed, as in the JAX package, whose scans
        # may run in worker processes.
        self._attempt_dir = tempfile.mkdtemp(prefix="daft_mock_attempts_")
        self._lock = threading.Lock()

    def schema(self) -> Schema:
        return MicroPartition.from_pydict(self.partitions[0]).schema

    def get_tasks(self, pushdowns=None) -> List[MockScanTask]:
        return [MockScanTask(self, i, p) for i, p in enumerate(self.partitions)]

    def record_attempt(self, index: int) -> None:
        import os
        import uuid as _uuid

        with self._lock:
            path = os.path.join(self._attempt_dir,
                                f"{index}-{_uuid.uuid4().hex[:8]}")
            open(path, "w").close()

    def attempts(self, index: int) -> int:
        import os

        with self._lock:
            try:
                return sum(1 for f in os.listdir(self._attempt_dir)
                           if f.startswith(f"{index}-"))
            except OSError:
                return 0

    # The lock is per-process state: it is dropped when the source is
    # pickled and made anew on unpickling.
    def __getstate__(self):
        state = self.__dict__.copy()
        del state["_lock"]
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._lock = threading.Lock()
