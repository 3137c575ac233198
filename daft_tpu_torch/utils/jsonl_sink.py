"""Size-capped rotating JSONL appender — the one shared implementation of
the "bounded always-on log file" discipline.

Port of ``daft_tpu/utils/jsonl_sink.py``. Used by the event log
(``subscribers/event_log.py``; the JAX package's query flight recorder,
ROADMAP A.8, is its other user): one line per record, rotation to
``<path>.1`` at ``max_bytes`` (the previous rotation is replaced, so the
on-disk footprint is bounded at ~2x the cap). Rotation is best-effort —
an OS-level rename failure re-caps growth on the next open rather than
failing the write. Readers are expected to be torn-line-safe (a process
may die mid-write); this writer flushes per line for liveness, it does
not fsync.
"""

from __future__ import annotations

import os
import threading
from typing import Optional, TextIO

DEFAULT_MAX_BYTES = 64 * 1024 * 1024


class RotatingJsonlSink:
    def __init__(self, path: str, max_bytes: int = DEFAULT_MAX_BYTES):
        self.path = path
        self.max_bytes = max(int(max_bytes), 4096)
        self._lock = threading.Lock()
        self._f: Optional[TextIO] = None
        self._size = 0

    def _open_locked(self) -> None:
        self._f = open(self.path, "a")
        try:
            self._size = os.path.getsize(self.path)
        except OSError:
            self._size = 0

    def write_line(self, line: str) -> None:
        """Append one already-serialized line (no trailing newline)."""
        data = line + "\n"
        with self._lock:
            if self._f is None:
                self._open_locked()
            if self._size + len(data) > self.max_bytes and self._size > 0:
                self._rotate_locked()
            self._f.write(data)
            self._f.flush()
            self._size += len(data)

    def _rotate_locked(self) -> None:
        self._f.close()
        try:
            os.replace(self.path, self.path + ".1")
        except OSError:
            pass  # best-effort; the fresh open below re-caps growth
        self._f = None
        self._open_locked()

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None
