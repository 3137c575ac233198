"""Scan planning: pushdowns, scan tasks, file listing (port of
``daft_tpu/io/scan.py``).

Reference: src/daft-scan — ``ScanTask`` (lib.rs:350-378) bundles source files +
schema + pushdowns; scan-task split/merge iterators size tasks between
min/max byte targets (scan_task_iters/); ``Pushdowns`` carries
projection/filter/limit/shard pruning into readers.

Filesystem access goes through pyarrow.fs: local paths, ``file://``, the
native S3 / GCS / HTTP(S) / hf:// clients (``s3_client.py``,
``gcs_client.py``, ``http_source.py``) and Arrow's S3 / GCS / Azure
filesystems, resolved by :func:`resolve_filesystem` as in the JAX package.
``ScanInfo.estimate_rows_bytes`` feeds the
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
    """Resolve a URI to (filesystem, fs-local path) via Arrow C++ filesystems,
    honouring IOConfig credentials (reference: common/io-config). http(s) and
    hf:// resolve to the native ranged-read HTTP source
    (``io/http_source.py``)."""
    if "://" in path:
        scheme = path.split("://", 1)[0]
        if io_config is None:
            from daft_tpu_torch.context import get_context

            io_config = get_context().planning_config.default_io_config
        if io_config is None and scheme in ("gs", "gcs"):
            # gs:// rides the native client by DEFAULT, io_config or not
            # (an empty GCSConfig resolves auth through the ADC chain);
            # DAFT_NATIVE_GCS=0 opts back out to Arrow's URI resolution.
            from daft_tpu_torch.io.config import IOConfig

            io_config = IOConfig()
        if scheme in ("http", "https", "hf"):
            from daft_tpu_torch.io.http_source import (
                HttpFileSystemHandler,
                resolve_hf_url,
            )
            from daft_tpu_torch.io.retry import policy_from_config

            if scheme == "hf":
                url = resolve_hf_url(path)
                scheme = url.split("://", 1)[0]
            else:
                url = path
            headers = {}
            if io_config is not None and scheme != "http":
                tok = getattr(getattr(io_config, "hf", None), "token", None)
                if tok and "huggingface.co" in url:
                    headers["Authorization"] = f"Bearer {tok}"
            handler = HttpFileSystemHandler(
                scheme, policy_from_config(io_config, "http"), headers)
            return pafs.PyFileSystem(handler), url.split("://", 1)[1]
        if io_config is not None:
            from daft_tpu_torch.io.config import filesystem_for

            fs = filesystem_for(scheme, io_config)
            if fs is not None:
                return fs, path.split("://", 1)[1]
        fs, p = pafs.FileSystem.from_uri(path)
        return fs, p
    return pafs.LocalFileSystem(), os.path.abspath(os.path.expanduser(path))


def glob_paths(paths: Sequence[str], io_config=None) -> List[FileInfo]:
    """Expand glob patterns / directories into concrete files with sizes.
    Multiple patterns fan out over a thread pool (reference:
    src/daft-io/src/object_store_glob.rs's concurrent fanout)."""
    if len(paths) > 1:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=min(len(paths), 16)) as pool:
            chunks = list(pool.map(
                lambda one: _glob_one(one, io_config), paths))
        out = [f for chunk in chunks for f in chunk]
        # Emptiness is judged on the AGGREGATE: one pattern matching nothing
        # is fine as long as some path matched.
        if not out:
            raise DaftIOError(f"No files found at {list(paths)!r}")
        return out
    out: List[FileInfo] = []
    for path in paths:
        if path.startswith("hf://"):
            from daft_tpu_torch.io.http_source import expand_hf_dataset

            expanded = expand_hf_dataset(path, io_config)
            if expanded is not None:  # repo-level listing -> concrete URLs
                out.extend(glob_paths(expanded, io_config))
                continue
        fs, p = resolve_filesystem(path, io_config)
        if isinstance(fs, pafs.LocalFileSystem):
            if any(ch in p for ch in "*?["):
                matches = sorted(_glob.glob(p, recursive=True))
                for m in matches:
                    if os.path.isfile(m):
                        out.append(FileInfo(m, os.path.getsize(m)))
            elif os.path.isdir(p):
                sel = pafs.FileSelector(p, recursive=True)
                for info in fs.get_file_info(sel):
                    if info.type == pafs.FileType.File and not os.path.basename(info.path).startswith((".", "_")):
                        out.append(FileInfo(info.path, info.size))
                out.sort(key=lambda f: f.path)
            elif os.path.isfile(p):
                out.append(FileInfo(p, os.path.getsize(p)))
            else:
                raise DaftIOError(f"Path not found: {path}")
        else:
            # Remote. FileInfo paths must stay full URIs (readers re-resolve
            # them); reattach the RESOLVED scheme — e.g. hf:// paths resolve
            # to https URLs, so the stored path is the https one.
            scheme = path.split("://", 1)[0]
            is_http = isinstance(fs, pafs.PyFileSystem)
            if is_http:
                scheme = getattr(fs.handler, "scheme", scheme)
            full = lambda q: f"{scheme}://{q}"  # noqa: E731
            # Support trailing glob on the basename and directories. HTTP
            # sources are never glob-expanded: '?' there starts a query
            # string (presigned URLs), not a wildcard, and listing is
            # impossible anyway.
            if not is_http and any(ch in p for ch in "*?["):
                base = p.split("*")[0].rsplit("/", 1)[0]
                sel = pafs.FileSelector(base, recursive=True)
                import fnmatch

                for info in fs.get_file_info(sel):
                    if info.type == pafs.FileType.File and fnmatch.fnmatch(info.path, p):
                        out.append(FileInfo(full(info.path), info.size))
                out.sort(key=lambda f: f.path)
            else:
                info = fs.get_file_info(p)
                if isinstance(info, list):
                    info = info[0]
                if info.type == pafs.FileType.Directory:
                    sel = pafs.FileSelector(p, recursive=True)
                    for i in fs.get_file_info(sel):
                        if i.type == pafs.FileType.File:
                            out.append(FileInfo(full(i.path), i.size))
                    out.sort(key=lambda f: f.path)
                elif info.type == pafs.FileType.File:
                    out.append(FileInfo(full(p), info.size))
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
