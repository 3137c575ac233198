"""Pluggable DataSink ABC (port of ``daft_tpu/io/sink.py``; reference:
daft/io/sink.py:31).

``DataFrame.write_sink`` drives: start() once, write(partition) per
partition, finalize(results) once.
"""

from __future__ import annotations

from typing import Generic, Iterable, List, TypeVar

from daft_tpu_torch.micropartition import MicroPartition

T = TypeVar("T")


class WriteResult(Generic[T]):
    def __init__(self, result: T, rows: int = 0, bytes_: int = 0):
        self.result = result
        self.rows = rows
        self.bytes_ = bytes_


class DataSink(Generic[T]):
    @property
    def name(self) -> str:
        return type(self).__name__

    def start(self) -> None:
        """Called once before any writes."""

    def write(self, partition: MicroPartition) -> WriteResult[T]:
        raise NotImplementedError

    def finalize(self, results: List[WriteResult[T]]):
        """Called once after all writes; returns the result table dict."""
        return {"wrote": [r.rows for r in results]}

    def invalidates(self) -> Iterable[str]:
        """Paths this sink wrote to: the JAX package drops its cached reads
        under them after ``finalize``. The port has no plan or result cache
        yet (ROADMAP A.8), so nothing reads this; sinks keep the method for
        the same contract."""
        return ()
