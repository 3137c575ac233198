"""IO statistics + range reads + chunked uploads (port of
``daft_tpu/io/iostats.py``).

Reference: src/daft-io/src/{stats.rs,range.rs,multipart.rs,retry.rs} — the
reference's object-store layer counts gets/puts/bytes, serves range reads,
and uploads large objects in retried parts. Arrow C++ filesystems carry the
transport here, over local files and the native S3 / GCS / HTTP clients
(``io/scan.py::resolve_filesystem``); this layer adds the same accounting and
chunk/retry semantics on top. Not ported yet: the fault-injection hook in
``read_range`` (``maybe_inject``, the distributed layer's, ROADMAP A.8.5).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Optional

from daft_tpu_torch.errors import DaftIOError


@dataclass
class IOStatsSnapshot:
    gets: int = 0
    puts: int = 0
    bytes_read: int = 0
    bytes_written: int = 0
    files_opened: int = 0
    read_time_s: float = 0.0
    write_time_s: float = 0.0
    retries: int = 0
    files_pruned: int = 0  # scan files skipped via partition-value pruning
    # Parquet record batches decoded, and the file columns they held summed
    # over those batches (the projection pushdown's measure: a scan that
    # decodes k columns adds k per batch).
    parquet_batches: int = 0
    parquet_columns: int = 0


class IOStats:
    """Process-wide thread-safe IO counters (reference: daft-io IOStatsRef).

    Every count also feeds the unified registry (metrics.py ``daft_io_*``
    series): callers that know their endpoint pass it so the exports break
    requests/bytes/latency out per origin; others fall back to the shared
    ``unattributed`` series."""

    def __init__(self):
        self._lock = threading.Lock()
        self._s = IOStatsSnapshot()

    def count_get(self, nbytes: int = 0, seconds: float = 0.0,
                  endpoint: Optional[str] = None,
                  verb: str = "GET") -> None:
        with self._lock:
            self._s.gets += 1
            self._s.bytes_read += nbytes
            self._s.read_time_s += seconds
        from daft_tpu_torch.metrics import record_io

        record_io(endpoint or "unattributed", verb, nbytes, seconds, "read")

    def count_put(self, nbytes: int = 0, seconds: float = 0.0,
                  endpoint: Optional[str] = None,
                  verb: str = "PUT") -> None:
        with self._lock:
            self._s.puts += 1
            self._s.bytes_written += nbytes
            self._s.write_time_s += seconds
        from daft_tpu_torch.metrics import record_io

        record_io(endpoint or "unattributed", verb, nbytes, seconds, "write")

    def count_open(self) -> None:
        with self._lock:
            self._s.files_opened += 1

    def count_retry(self, endpoint: Optional[str] = None) -> None:
        with self._lock:
            self._s.retries += 1
        from daft_tpu_torch import metrics

        if metrics.get_registry().enabled:
            metrics.IO_RETRIES.labels(endpoint or "unattributed").inc()

    def count_pruned(self, nfiles: int) -> None:
        with self._lock:
            self._s.files_pruned += nfiles

    def count_decoded(self, ncolumns: int) -> None:
        with self._lock:
            self._s.parquet_batches += 1
            self._s.parquet_columns += ncolumns

    def snapshot(self) -> IOStatsSnapshot:
        with self._lock:
            return IOStatsSnapshot(**vars(self._s))

    def reset(self) -> None:
        with self._lock:
            self._s = IOStatsSnapshot()


IO_STATS = IOStats()


def io_stats() -> IOStatsSnapshot:
    """Current process-wide IO counters (reference: daft-io stats)."""
    return IO_STATS.snapshot()


def reset_io_stats() -> None:
    IO_STATS.reset()


def read_range(path: str, start: int, length: int, io_config=None) -> bytes:
    """Ranged read: `length` bytes at `start` (reference: daft-io range.rs)."""
    from daft_tpu_torch.io.scan import resolve_filesystem

    fs, p = resolve_filesystem(path, io_config)
    t0 = time.perf_counter()
    with fs.open_input_file(p) as f:
        f.seek(start)
        data = f.read(length)
    from daft_tpu_torch.io.circuit import endpoint_of

    IO_STATS.count_open()
    IO_STATS.count_get(len(data), time.perf_counter() - t0,
                       endpoint=endpoint_of(path))
    return data


def parallel_ranged_read(path: str, ranges, max_concurrency: int = 8,
                         io_config=None, policy=None) -> list:
    """Read many (start, length) ranges of one object concurrently, each
    range independently retried (reference: src/daft-io/src/range.rs — the
    reference fans ranged gets out over its IO runtime; here a thread pool,
    Arrow filesystems release the GIL)."""
    from concurrent.futures import ThreadPoolExecutor

    from daft_tpu_torch.io.retry import RetryPolicy, with_retries

    policy = policy or RetryPolicy()
    ranges = list(ranges)
    if not ranges:
        return []

    def read_one(rng):
        start, length = rng
        return with_retries(
            lambda: read_range(path, start, length, io_config), policy,
            describe=f"ranged read {path}[{start}:{start + length}]",
            on_retry=IO_STATS.count_retry)

    if len(ranges) == 1:
        return [read_one(ranges[0])]
    with ThreadPoolExecutor(max_workers=min(max_concurrency, len(ranges)),
                            thread_name_prefix="daft-range") as pool:
        return list(pool.map(read_one, ranges))


class MultipartUpload:
    """Resumable, part-parallel upload (reference: src/daft-io/src/multipart.rs).

    Parts are staged as sibling objects ``{path}.daft-parts/NNNNN`` written
    concurrently with per-part retry; ``close()`` composes them into the
    target by streaming concatenation and deletes the staging area. A crashed
    upload resumes: parts already staged with the right size are skipped.
    (Per-cloud native multipart — S3 UploadPart/Complete — plugs in at this
    seam; Arrow C++ filesystems expose only whole-object streams.)
    """

    def __init__(self, path: str, part_size: int = 8 * 1024 * 1024,
                 max_concurrency: int = 4, io_config=None, policy=None,
                 filesystem=None):
        from daft_tpu_torch.io.retry import RetryPolicy
        from daft_tpu_torch.io.scan import resolve_filesystem

        self.path = path
        self.part_size = part_size
        self.max_concurrency = max_concurrency
        self.policy = policy or RetryPolicy()
        if filesystem is not None:
            self.fs, self.p = filesystem, path
        else:
            self.fs, self.p = resolve_filesystem(path, io_config)
        self.stage_dir = f"{self.p}.daft-parts"
        self._buf = bytearray()
        self._next_part = 0
        self._futures = []
        self._pool = None
        self._closed = False

    def _part_path(self, i: int) -> str:
        return f"{self.stage_dir}/{i:05d}"

    def _pool_lazy(self):
        from concurrent.futures import ThreadPoolExecutor

        if self._pool is None:
            self.fs.create_dir(self.stage_dir, recursive=True)
            self._pool = ThreadPoolExecutor(max_workers=self.max_concurrency,
                                            thread_name_prefix="daft-part")
        return self._pool

    def _upload_part(self, i: int, data: bytes) -> int:
        from daft_tpu_torch.io.retry import with_retries

        import pyarrow.fs as pafs

        part = self._part_path(i)
        existing = self.fs.get_file_info(part)
        if isinstance(existing, list):
            existing = existing[0]
        if existing.type == pafs.FileType.File and existing.size == len(data):
            return 0  # resume: this part already landed

        def put():
            t0 = time.perf_counter()
            with self.fs.open_output_stream(part) as out:
                out.write(data)
            IO_STATS.count_put(len(data), time.perf_counter() - t0)
            return len(data)

        return with_retries(put, self.policy, describe=f"upload part {part}",
                            on_retry=IO_STATS.count_retry)

    def write(self, data: bytes) -> None:
        if self._closed:
            raise DaftIOError("MultipartUpload already closed")
        self._buf.extend(data)
        while len(self._buf) >= self.part_size:
            chunk = bytes(self._buf[:self.part_size])
            del self._buf[:self.part_size]
            i = self._next_part
            self._next_part += 1
            self._futures.append(self._pool_lazy().submit(self._upload_part, i, chunk))

    def abort(self) -> None:
        self._closed = True
        if self._pool is not None:
            self._pool.shutdown(wait=True, cancel_futures=True)
        try:
            self.fs.delete_dir(self.stage_dir)
        except Exception:  # noqa: BLE001
            pass

    def close(self) -> int:
        """Flush, await parts, compose the target object, clean staging."""
        if self._closed:
            raise DaftIOError("MultipartUpload already closed")
        self._closed = True
        if self._buf or self._next_part:
            if self._buf:
                i = self._next_part
                self._next_part += 1
                chunk = bytes(self._buf)
                self._buf.clear()
                self._futures.append(self._pool_lazy().submit(self._upload_part, i, chunk))
        total_parts = self._next_part
        errors = []
        for f in self._futures:
            try:
                f.result()
            except Exception as e:  # noqa: BLE001
                errors.append(e)
        if self._pool is not None:
            self._pool.shutdown(wait=True)
        if errors:
            raise DaftIOError(
                f"multipart upload to {self.path}: {len(errors)} part(s) "
                f"failed (staged parts kept for resume): {errors[0]}")
        t0 = time.perf_counter()
        written = 0
        with self.fs.open_output_stream(self.p) as out:
            for i in range(total_parts):
                with self.fs.open_input_stream(self._part_path(i)) as part:
                    while True:
                        block = part.read(1 << 20)
                        if not block:
                            break
                        out.write(block)
                        written += len(block)
        IO_STATS.count_put(written, time.perf_counter() - t0)
        try:
            self.fs.delete_dir(self.stage_dir)
        except Exception:  # noqa: BLE001
            pass
        return written


def chunked_upload(path: str, data: bytes, chunk_size: int = 8 * 1024 * 1024,
                   max_retries: int = 3, io_config=None) -> int:
    """Upload `data` in chunks with whole-object retry (reference:
    daft-io multipart.rs; Arrow C++ streams don't expose per-part resume, so
    retry granularity is the object — counted in io_stats().retries)."""
    from daft_tpu_torch.io.scan import resolve_filesystem

    fs, p = resolve_filesystem(path, io_config)
    last: Optional[Exception] = None
    for attempt in range(max_retries):
        t0 = time.perf_counter()
        try:
            with fs.open_output_stream(p) as out:
                for off in range(0, len(data), chunk_size):
                    out.write(data[off:off + chunk_size])
            IO_STATS.count_put(len(data), time.perf_counter() - t0)
            return len(data)
        except Exception as e:  # noqa: BLE001
            last = e
            IO_STATS.count_retry()
    raise DaftIOError(f"chunked_upload to {path} failed after {max_retries} "
                      f"attempts: {last}")
