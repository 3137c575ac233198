"""Scan planning: pushdowns, scan tasks, file listing (port of
``daft_tpu/io/scan.py``).

Reference: src/daft-scan — ``ScanTask`` (lib.rs:350-378) bundles source files +
schema + pushdowns; scan-task split/merge iterators size tasks between
min/max byte targets (scan_task_iters/); ``Pushdowns`` carries
projection/filter/limit/shard pruning into readers.

The port lists and reads local paths and ``file://`` URLs through
``pyarrow.fs.LocalFileSystem``; every other scheme raises, as the object-store
and HTTP clients are ROADMAP A.8. ``ScanInfo.estimate_rows_bytes`` feeds the
cardinality estimates that ``ReorderJoins`` reads; ``EnrichWithStats`` sets
each parquet file's ``num_rows`` and the scan's per-column footer stats.
"""

from __future__ import annotations

import dataclasses
import glob as _glob
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import pyarrow.fs as pafs

from daft_tpu_torch.errors import DaftIOError
from daft_tpu_torch.schema import Schema


@dataclass(frozen=True)
class Pushdowns:
    """Pushdowns applied to a scan (reference: src/daft-scan/src/pushdowns.rs)."""

    columns: Optional[Tuple[str, ...]] = None
    filters: Optional[object] = None  # Expr
    limit: Optional[int] = None
    shard: Optional[Tuple[int, int]] = None  # (world_size, rank)

    def with_changes(self, **kwargs) -> "Pushdowns":
        return dataclasses.replace(self, **kwargs)


@dataclass
class FileInfo:
    path: str
    size_bytes: Optional[int] = None
    num_rows: Optional[int] = None
    # Hive partition values parsed from the path (io/hive.py); the readers
    # inject them as constant columns.
    partition_values: Optional[Dict[str, Any]] = None


@dataclass
class ScanTask:
    """A unit of scan work: one or more files read into MicroPartitions
    (reference: src/daft-scan/src/lib.rs:350-378)."""

    files: List[FileInfo]
    file_format: str  # parquet | csv | json | text | warc | python_source
    schema: Schema
    pushdowns: Pushdowns = field(default_factory=Pushdowns)
    read_options: Dict[str, Any] = field(default_factory=dict)

    def size_bytes(self) -> int:
        return sum(f.size_bytes or 0 for f in self.files)

    def display(self) -> str:
        return f"ScanTask({self.file_format}, {len(self.files)} files)"


def resolve_filesystem(path: str, io_config=None) -> Tuple[pafs.FileSystem, str]:
    """Resolve a path to (filesystem, fs-local path): local paths and
    ``file://`` URLs; any other scheme raises ``DaftValueError`` (ROADMAP
    A.8)."""
    if "://" in path:
        scheme, rest = path.split("://", 1)
        if scheme != "file":
            from daft_tpu_torch.io.config import remote_scheme_error

            raise remote_scheme_error(path)
        path = rest
    return pafs.LocalFileSystem(), os.path.abspath(os.path.expanduser(path))


def glob_paths(paths: Sequence[str], io_config=None) -> List[FileInfo]:
    """Expand glob patterns / directories into concrete files with sizes.
    A directory lists recursively, sorted by path, skipping files whose name
    starts with ``.`` or ``_``; a glob sorts its matches. Multiple patterns
    fan out over a thread pool (reference:
    src/daft-io/src/object_store_glob.rs's concurrent fanout)."""
    if len(paths) > 1:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=min(len(paths), 16)) as pool:
            chunks = list(pool.map(lambda one: _glob_one(one, io_config), paths))
        out = [f for chunk in chunks for f in chunk]
        # Emptiness is judged on the AGGREGATE: one pattern matching nothing
        # is fine as long as some path matched.
        if not out:
            raise DaftIOError(f"No files found at {list(paths)!r}")
        return out
    out: List[FileInfo] = []
    for path in paths:
        fs, p = resolve_filesystem(path, io_config)
        if any(ch in p for ch in "*?["):
            for m in sorted(_glob.glob(p, recursive=True)):
                if os.path.isfile(m):
                    out.append(FileInfo(m, os.path.getsize(m)))
        elif os.path.isdir(p):
            sel = pafs.FileSelector(p, recursive=True)
            for info in fs.get_file_info(sel):
                if info.type == pafs.FileType.File \
                        and not os.path.basename(info.path).startswith((".", "_")):
                    out.append(FileInfo(info.path, info.size))
            out.sort(key=lambda f: f.path)
        elif os.path.isfile(p):
            out.append(FileInfo(p, os.path.getsize(p)))
        else:
            raise DaftIOError(f"Path not found: {path}")
    if not out:
        raise DaftIOError(f"No files found at {list(paths)!r}")
    return out


def list_paths_tolerant(paths: Sequence[str], io_config=None) -> List[FileInfo]:
    """Listing for tailing sources: the same contract as :func:`glob_paths`,
    but an empty or not-yet-created prefix is an empty listing, not an error.
    Sorted by path."""
    out: List[FileInfo] = []
    for p in paths:
        try:
            out.extend(glob_paths([p], io_config))
        except DaftIOError as e:
            if "No files found" in str(e) or "Path not found" in str(e):
                continue
            raise
    out.sort(key=lambda f: f.path)
    return out


def _glob_one(path: str, io_config=None) -> List[FileInfo]:
    try:
        return glob_paths([path], io_config)
    except DaftIOError as e:
        # "Pattern matched nothing" is tolerated per path; a missing concrete
        # path propagates.
        if "No files found" in str(e):
            return []
        raise


class ScanInfo:
    """A scan operator over a set of globbed files of one format
    (reference: src/daft-scan/src/glob.rs GlobScanOperator)."""

    def __init__(self, paths: Sequence[str], file_format: str, schema: Schema,
                 read_options: Optional[Dict[str, Any]] = None,
                 files: Optional[List[FileInfo]] = None):
        self.paths = list(paths)
        self.file_format = file_format
        self.schema = schema
        self.read_options = read_options or {}
        self._files = files

    def files(self) -> List[FileInfo]:
        if self._files is None:
            self._files = glob_paths(self.paths, self.read_options.get("io_config"))
        return self._files

    def display_name(self) -> str:
        return f"{self.file_format}({self.paths[0]}{'...' if len(self.paths) > 1 else ''})"

    def estimate_rows_bytes(self) -> Tuple[float, float]:
        files = self.files()
        size = float(sum(f.size_bytes or 0 for f in files))
        row_size = self.schema.estimate_row_size_bytes()
        inflation = 3.0 if self.file_format == "parquet" else 1.0
        return (size * inflation / max(row_size, 1.0), size * inflation)

    def to_scan_tasks(self, pushdowns: Pushdowns, cfg) -> List[ScanTask]:
        """Prune files by partition value, then pack them into scan tasks
        within [min, max] byte targets (reference:
        src/daft-scan/src/scan_task_iters/split_parquet_*)."""
        files = self.files()
        if pushdowns.filters is not None:
            from daft_tpu_torch.io.hive import prune_files_by_partition
            from daft_tpu_torch.io.iostats import IO_STATS

            pruned = prune_files_by_partition(files, pushdowns.filters, self.schema)
            if len(pruned) < len(files):
                IO_STATS.count_pruned(len(files) - len(pruned))
            files = pruned
        if pushdowns.shard is not None:
            world, rank = pushdowns.shard
            files = [f for i, f in enumerate(files) if i % world == rank]
        tasks: List[ScanTask] = []
        bucket: List[FileInfo] = []
        bucket_bytes = 0
        for f in files:
            fsize = f.size_bytes or cfg.scan_tasks_min_size_bytes
            if bucket and (bucket_bytes + fsize > cfg.scan_tasks_max_size_bytes
                           or len(bucket) >= cfg.max_sources_per_scan_task):
                tasks.append(ScanTask(bucket, self.file_format, self.schema, pushdowns,
                                      self.read_options))
                bucket, bucket_bytes = [], 0
            bucket.append(f)
            bucket_bytes += fsize
            if bucket_bytes >= cfg.scan_tasks_min_size_bytes:
                tasks.append(ScanTask(bucket, self.file_format, self.schema, pushdowns,
                                      self.read_options))
                bucket, bucket_bytes = [], 0
        if bucket:
            tasks.append(ScanTask(bucket, self.file_format, self.schema, pushdowns,
                                  self.read_options))
        return tasks
