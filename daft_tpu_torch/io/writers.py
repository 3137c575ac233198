"""Write path: file writers + write info (port of ``daft_tpu/io/writers.py``).

Reference: src/daft-writers — ``AsyncFileWriter`` trait (lib.rs:67-82),
physical writer factory (physical.rs), target-file-size batching
(batch_file_writer.rs), partitioned writes (partition.rs). Arrow C++ writers
(pyarrow.parquet / csv / ipc / json) are the native encode path.
``write_mode="overwrite"`` replaces what was under the root directory
(``overwrite_files``), where the JAX package appends (ROADMAP C.32). Every
writer's ``close`` invalidates the query caches under its root directory
(``plancache.invalidate_path``), as in the JAX package. A root under an
object store (``s3://``, ``gs://``, ...) writes through the filesystem that
``io/scan.py::resolve_filesystem`` gives it under the context's default
``IOConfig``; the JAX package hands such a root to pyarrow's URI resolution,
which ignores the ``IOConfig`` (ROADMAP C.51).
"""

from __future__ import annotations

import os
import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import pyarrow as pa
import pyarrow.csv as pacsv
import pyarrow.parquet as pq

from daft_tpu_torch.datatype import DataType
from daft_tpu_torch.errors import DaftValueError
from daft_tpu_torch.micropartition import MicroPartition
from daft_tpu_torch.recordbatch import RecordBatch
from daft_tpu_torch.schema import Field, Schema


@dataclass
class WriteInfo:
    """Sink description carried by LogicalPlan::Sink (reference: SinkInfo /
    OutputFileInfo in src/daft-logical-plan/src/sink_info.rs)."""

    file_format: str  # parquet | csv | json | ipc
    root_dir: str
    partition_cols: Optional[List] = None  # list[Expr]
    compression: Optional[str] = None
    write_mode: str = "append"  # append | overwrite
    io_options: Dict[str, Any] = field(default_factory=dict)

    def __post_init__(self):
        if self.write_mode not in ("append", "overwrite"):
            raise DaftValueError(
                f"write_mode must be 'append' or 'overwrite', got {self.write_mode!r}")

    def display_name(self) -> str:
        return f"{self.file_format}->{self.root_dir}"

    def result_schema(self) -> Schema:
        return Schema([Field("path", DataType.string()), Field("num_rows", DataType.uint64())])


class FileWriter:
    """Size-targeted rolling file writer for one partition-stream.

    Mirrors the reference's TargetFileSizeWriter: rolls to a new file when the
    current file exceeds the target size.
    """

    def __init__(self, info: WriteInfo, schema: Schema, target_file_bytes: int,
                 subdir: str = "", prefix: Optional[str] = None):
        self.info = info
        self.schema = schema
        self.target = target_file_bytes
        self.subdir = subdir
        self.prefix = prefix or uuid.uuid4().hex[:12]
        self.results: List[Dict[str, Any]] = []
        self._idx = 0
        self._current = None
        self._current_path = None
        self._current_bytes = 0
        self._current_rows = 0
        self._stream = None
        self._remote = _remote_root(info.root_dir)

    def _dir(self) -> str:
        d = os.path.join(self.info.root_dir, self.subdir) if self.subdir else self.info.root_dir
        os.makedirs(d, exist_ok=True)
        return d

    def _open(self):
        ext = {"parquet": "parquet", "csv": "csv", "json": "jsonl", "ipc": "arrow"}[self.info.file_format]
        name = f"{self.prefix}-{self._idx}.{ext}"
        if self._remote is not None:
            fs, base, scheme = self._remote
            fs_path = "/".join(x for x in (base, self.subdir, name) if x)
            path = self._stream = fs.open_output_stream(fs_path)
            self._current_path = f"{scheme}://{fs_path}"
        else:
            path = os.path.join(self._dir(), name)
            self._current_path = path
        self._idx += 1
        self._current_bytes = 0
        self._current_rows = 0
        arrow_schema = self.schema.to_arrow()
        if self.info.file_format == "json" and self._stream is not None:
            self._current = _TextStream(self._stream)
        elif self.info.file_format == "parquet":
            self._current = pq.ParquetWriter(path, arrow_schema,
                                             compression=self.info.compression or "snappy")
        elif self.info.file_format == "csv":
            self._current = pacsv.CSVWriter(path, arrow_schema)
        elif self.info.file_format == "ipc":
            self._current = pa.ipc.new_file(path, arrow_schema)
        elif self.info.file_format == "json":
            self._current = open(path, "w")
        else:
            raise DaftValueError(f"Unknown write format {self.info.file_format}")

    def write(self, mp: MicroPartition) -> None:
        if len(mp) == 0:
            return
        if self._current is None:
            self._open()
        table = mp.to_arrow_table().cast(self.schema.to_arrow())
        if self.info.file_format == "json":
            for row in table.to_pylist():
                import json as _json

                self._current.write(_json.dumps(row, default=str) + "\n")
        elif self.info.file_format == "csv":
            self._current.write_table(table)
        else:
            self._current.write_table(table) if self.info.file_format == "parquet" else self._current.write(table)
        self._current_bytes += mp.size_bytes()
        self._current_rows += len(mp)
        if self._current_bytes >= self.target:
            self._roll()

    def _roll(self):
        if self._current is not None:
            self._close_current()

    def _close_current(self):
        self._current.close()
        from daft_tpu_torch.io.iostats import IO_STATS

        if self._stream is not None:
            # The object store's client publishes the object when the stream
            # closes. The port's native clients (``py::daft-s3``,
            # ``py::daft-gcs``) count their own PUT; Arrow's filesystems
            # count none, so the writer counts it for them.
            size = self._stream.tell()
            self._stream.close()
            self._stream = None
            if not self._remote[0].type_name.startswith("py::daft-"):
                IO_STATS.count_put(size)
        else:
            try:
                size = os.path.getsize(self._current_path)
            except OSError:
                size = 0
            IO_STATS.count_put(size)
        self.results.append({"path": self._current_path, "num_rows": self._current_rows})
        self._current = None

    def close(self) -> List[Dict[str, Any]]:
        if self._current is not None:
            self._close_current()
        # Write-invalidation: every cached plan, result or scan reading
        # under this root is now stale. The source fingerprints checked at
        # each hit catch the writes this process never saw.
        from daft_tpu_torch.plancache import invalidate_path

        invalidate_path(self.info.root_dir)
        return self.results


class PartitionedWriter:
    """Hash/value-partitioned writer: routes rows to per-partition-value
    FileWriters (reference: src/daft-writers/src/partition.rs)."""

    def __init__(self, info: WriteInfo, schema: Schema, target_file_bytes: int):
        self.info = info
        self.schema = schema
        self.target = target_file_bytes
        self._writers: Dict[tuple, FileWriter] = {}

    def write(self, mp: MicroPartition) -> None:
        from daft_tpu_torch.expressions.evaluator import evaluate

        rb = mp.combined()
        key_series = [evaluate(e, rb) for e in self.info.partition_cols]
        parts, keys = rb.partition_by_value(key_series)
        data_schema = self.out_schema()
        for i, part in enumerate(parts):
            key_vals = tuple(keys.columns()[j].to_pylist()[i] for j in range(keys.num_columns()))
            w = self._writers.get(key_vals)
            if w is None:
                subdir = "/".join(
                    f"{c.name}={_hive_escape(v)}" for c, v in zip(keys.columns(), key_vals)
                )
                w = FileWriter(self.info, data_schema, self.target, subdir=subdir)
                self._writers[key_vals] = w
            drop = [c.name for c in keys.columns()]
            kept = part.schema.exclude(drop)
            part_data = RecordBatch(kept, [part.get_column(n) for n in kept.column_names()], len(part))
            w.write(MicroPartition.from_record_batches([part_data], kept))

    def out_schema(self) -> Schema:
        names = {e.name() for e in self.info.partition_cols}
        return self.schema.exclude(list(names))

    def close(self) -> List[Dict[str, Any]]:
        out = []
        for w in self._writers.values():
            out.extend(w.close())
        from daft_tpu_torch.plancache import invalidate_path

        invalidate_path(self.info.root_dir)
        return out


def _remote_root(root_dir: str):
    """(filesystem, its path of the root, scheme) for a root under an object
    store or another non-local filesystem; None for a local path or
    ``file://``."""
    if "://" not in root_dir:
        return None
    import pyarrow.fs as pafs

    from daft_tpu_torch.io.scan import resolve_filesystem

    fs, base = resolve_filesystem(root_dir)
    if isinstance(fs, pafs.LocalFileSystem):
        return None
    return fs, base.rstrip("/"), root_dir.split("://", 1)[0]


class _TextStream:
    """The JSON writer's text lines onto a binary output stream."""

    def __init__(self, stream):
        self._stream = stream

    def write(self, text: str) -> None:
        self._stream.write(text.encode())

    def close(self) -> None:
        pass


def _hive_escape(v) -> str:
    if v is None:
        # Hive's null-partition sentinel (read back as null by io/hive.py).
        return "__HIVE_DEFAULT_PARTITION__"
    s = str(v)
    # '%' first: the read side (io/hive.py) unquotes every %XX sequence, so
    # the escaping must be a proper injection to round-trip.
    return s.replace("%", "%25").replace("/", "%2F").replace("=", "%3D")


def overwrite_files(root_dir: str, written: List[str]) -> None:
    """``write_mode="overwrite"``: once the write has finished, delete every
    file under ``root_dir`` that it did not produce, as Daft's
    ``overwrite_files`` does. The JAX package stores the mode and appends
    (ROADMAP C.32)."""
    if _remote_root(root_dir) is not None:
        raise DaftValueError(f"write_mode='overwrite' under {root_dir!r}: the port replaces "
                             "files under local roots only")
    keep = {os.path.abspath(p) for p in written}
    for dirpath, _, files in os.walk(root_dir):
        for name in files:
            path = os.path.abspath(os.path.join(dirpath, name))
            if path not in keep:
                os.remove(path)


def make_writer(info: WriteInfo, schema: Schema, cfg):
    target = {
        "parquet": cfg.parquet_target_filesize,
        "csv": cfg.csv_target_filesize,
        "json": cfg.json_target_filesize,
        "ipc": cfg.parquet_target_filesize,
    }[info.file_format]
    if info.partition_cols:
        return PartitionedWriter(info, schema, target)
    return FileWriter(info, schema, target)
