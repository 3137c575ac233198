"""Format readers: execute a ScanTask into a stream of MicroPartitions
(port of ``daft_tpu/io/formats.py``).

Reference: the native readers src/daft-parquet (streaming reads),
src/daft-csv, src/daft-json, src/daft-text, src/daft-warc. Decode runs on
Arrow C++ (pyarrow.parquet/csv/json) with the reference's pushdown
semantics: projection → reader column selection, filters → a post-filter on
the host (``evaluate``, never the device layer, as in the JAX package),
limit → early stop. Not ported yet: the fault-injection hook of the
distributed layer (``maybe_inject`` at ``daft_tpu/io/formats.py:39, 54``,
ROADMAP A.8).
"""

from __future__ import annotations

from typing import Iterator, List, Optional

import pyarrow as pa
import pyarrow.csv as pacsv
import pyarrow.json as pajson
import pyarrow.parquet as pq

from daft_tpu_torch.errors import DaftValueError
from daft_tpu_torch.io.iostats import IO_STATS
from daft_tpu_torch.io.scan import ScanTask, resolve_filesystem
from daft_tpu_torch.micropartition import MicroPartition
from daft_tpu_torch.recordbatch import RecordBatch
from daft_tpu_torch.schema import Schema


def read_scan_task(task: ScanTask, morsel_rows: int = 128 * 1024) -> Iterator[MicroPartition]:
    """Stream a scan task as MicroPartitions of ~morsel_rows rows."""
    pushdowns = task.pushdowns
    remaining = pushdowns.limit
    if task.file_format == "python_source":
        # Custom DataSource task (io/source.py plugin surface); same
        # transient-retry policy as file scans.
        source_task = task.read_options["source_task"]
        yield from _stream_with_retry(task, lambda: source_task.execute(),
                                      remaining, project_columns=True)
        return

    for f in task.files:
        if remaining is not None and remaining <= 0:
            return
        # Counted up front: a generator can be abandoned mid-stream (limit),
        # and timing around `yield from` would measure downstream compute,
        # not IO. bytes_read is the file's size upper bound.
        IO_STATS.count_open()
        IO_STATS.count_get(f.size_bytes or 0)

        def open_file(f=f):
            return _read_one_file(task, f, morsel_rows)

        remaining = yield from _stream_with_retry(task, open_file, remaining,
                                                  endpoint=f.path)


_SCAN_RETRIES = 3


def _stream_with_retry(task: ScanTask, make_iter, remaining,
                       project_columns: bool = False,
                       endpoint: Optional[str] = None):
    """Stream morsels from ``make_iter()`` applying pushdown filters/limit,
    retrying transient failures (reference: src/daft-io/src/retry.rs).

    Retry is only safe BEFORE the first morsel reached the consumer (a
    mid-stream retry would duplicate yielded rows); the final attempt always
    re-raises, so the loop has no normal fall-through.

    Bounded-time: sleeps are interruptible against the ambient cancel token
    and never overrun the query's remaining budget. With an ``endpoint``,
    attempts feed that endpoint's shared circuit breaker — a host failing
    across MANY scan tasks opens the circuit and later tasks fail fast with
    ``DaftCircuitOpenError`` (transient).
    """
    import time as _time

    from daft_tpu_torch.cancellation import current_token
    from daft_tpu_torch.errors import DaftCircuitOpenError, DaftTransientError

    breaker = None
    if endpoint is not None:
        from daft_tpu_torch.io.circuit import breaker_for, endpoint_of

        breaker = breaker_for(endpoint_of(endpoint))
    token = current_token()
    for attempt in range(_SCAN_RETRIES):
        if breaker is not None:
            breaker.allow()
        yielded = False
        try:
            for mp in make_iter():
                mp = _apply_post_pushdowns(mp, task)
                if project_columns and task.pushdowns.columns is not None:
                    from daft_tpu_torch.expressions.expr import ColumnRef

                    mp = mp.eval_expression_list(
                        [ColumnRef(c) for c in task.pushdowns.columns])
                if remaining is not None:
                    if len(mp) > remaining:
                        mp = mp.head(remaining)
                    remaining -= len(mp)
                if len(mp):
                    yielded = True
                    yield mp
                if remaining is not None and remaining <= 0:
                    if breaker is not None:
                        breaker.record_success()
                    return remaining
            if breaker is not None:
                breaker.record_success()
            return remaining
        except DaftTransientError as e:
            if breaker is not None and not isinstance(e, DaftCircuitOpenError):
                breaker.record_failure()
            if yielded or attempt + 1 >= _SCAN_RETRIES:
                raise

            delay = 0.05 * (2 ** attempt)
            if token is not None:
                rem = token.remaining()
                if rem is not None and delay >= rem:
                    raise  # sleeping would overrun the query budget
            IO_STATS.count_retry()
            if token is not None:
                if token.wait(delay):
                    token.check("scan retry backoff")
            else:
                _time.sleep(delay)


def _read_one_file(task: ScanTask, f, morsel_rows: int):
    if task.file_format == "parquet":
        return _read_parquet_file(f.path, task, morsel_rows,
                                  partition_values=f.partition_values)
    if task.file_format == "warc":
        it = _read_warc_file(f.path, task, morsel_rows)
    elif task.file_format == "csv":
        it = _read_csv_file(f.path, task, morsel_rows)
    elif task.file_format == "json":
        it = _read_json_file(f.path, task, morsel_rows)
    elif task.file_format == "text":
        it = _read_text_file(f.path, task, morsel_rows)
    else:
        raise DaftValueError(f"Unknown file format: {task.file_format}")
    if f.partition_values:
        # Hive-partitioned csv/json: materialize path-borne partition columns
        # as constants, like the parquet path (reference: hive.rs partition
        # column materialization).
        it = _inject_partition_columns(it, task, f.partition_values)
    return it


def _partition_inject_plan(task: ScanTask, pv):
    """(needed columns, partition columns to inject) for a file whose
    partition values live in its path rather than the data file."""
    needed = None
    if task.pushdowns.columns is not None:
        needed = list(dict.fromkeys(
            list(task.pushdowns.columns) + _filter_ref_columns(task)))
    inject = [c for c in pv
              if c in task.schema and (needed is None or c in needed)]
    return needed, inject


def _inject_into_table(tbl: pa.Table, task: ScanTask, pv, needed,
                       inject) -> pa.Table:
    """Append partition-value constants (typed to the table schema) and
    reorder to the projected schema — shared by the parquet and csv/json
    hive paths."""
    for c in inject:
        if c in tbl.column_names:
            continue
        atype = task.schema[c].dtype.to_arrow()
        v = pv[c]
        tbl = tbl.append_column(
            pa.field(c, atype),
            pa.nulls(len(tbl), atype) if v is None
            else pa.array([v] * len(tbl), atype))
    present = set(tbl.column_names)
    order = (needed if needed is not None else [f.name for f in task.schema])
    return tbl.select([c for c in order if c in present])


def _inject_partition_columns(it: Iterator[MicroPartition], task: ScanTask,
                              pv) -> Iterator[MicroPartition]:
    needed, inject = _partition_inject_plan(task, pv)
    for mp in it:
        tbl = _inject_into_table(mp.to_arrow_table(), task, pv, needed, inject)
        yield MicroPartition.from_arrow_table(tbl)


def _apply_post_pushdowns(mp: MicroPartition, task: ScanTask) -> MicroPartition:
    if task.pushdowns.filters is not None:
        mp = mp.filter(task.pushdowns.filters)
    return mp


def _project_schema(task: ScanTask) -> Schema:
    if task.pushdowns.columns is not None:
        return task.schema.select(list(task.pushdowns.columns))
    return task.schema


def _filter_ref_columns(task: ScanTask) -> List[str]:
    if task.pushdowns.filters is None:
        return []
    return sorted(task.pushdowns.filters.column_refs())


def _read_parquet_file(path: str, task: ScanTask, morsel_rows: int,
                       partition_values=None) -> Iterator[MicroPartition]:
    fs, p = resolve_filesystem(path, task.read_options.get("io_config"))
    schema = _project_schema(task)
    pv = partition_values or {}
    # `needed` = projection + filter refs (None = every schema column); the
    # file itself only holds the non-partition subset. Path-borne partition
    # columns are injected as constants, cast to the table schema's dtype,
    # in schema column order.
    needed, inject = _partition_inject_plan(task, pv)
    file_cols = None if needed is None else [c for c in needed if c not in pv]
    pf = pq.ParquetFile(fs.open_input_file(p))
    try:
        # Batches of exactly morsel_rows rows across row groups (the file's
        # last one short), decoded on Arrow's own thread pool.
        for batch in pf.iter_batches(batch_size=morsel_rows, columns=file_cols,
                                     use_threads=True):
            IO_STATS.count_decoded(batch.num_columns)
            tbl = pa.Table.from_batches([batch])
            if inject:
                tbl = _inject_into_table(tbl, task, pv, needed, inject)
            rb = RecordBatch.from_arrow_table(tbl)
            yield MicroPartition.from_record_batches([rb])
    finally:
        pf.close()


def _read_csv_file(path: str, task: ScanTask, morsel_rows: int) -> Iterator[MicroPartition]:
    fs, p = resolve_filesystem(path, task.read_options.get("io_config"))
    opts = task.read_options
    read_opts = pacsv.ReadOptions(block_size=16 * 1024 * 1024)
    parse_opts = pacsv.ParseOptions(delimiter=opts.get("delimiter", ","))
    convert_opts = pacsv.ConvertOptions()
    if not opts.get("has_headers", True):
        read_opts.autogenerate_column_names = True
    with fs.open_input_stream(p) as stream:
        reader = pacsv.open_csv(stream, read_options=read_opts, parse_options=parse_opts,
                                convert_options=convert_opts)
        for batch in reader:
            table = pa.Table.from_batches([batch])
            if task.pushdowns.columns is not None:
                keep = [c for c in table.schema.names
                        if c in task.pushdowns.columns or c in _filter_ref_columns(task)]
                table = table.select(keep)
            yield MicroPartition.from_arrow_table(table)


def _read_json_file(path: str, task: ScanTask, morsel_rows: int) -> Iterator[MicroPartition]:
    fs, p = resolve_filesystem(path, task.read_options.get("io_config"))
    with fs.open_input_stream(p) as stream:
        table = pajson.read_json(stream)
    if task.pushdowns.columns is not None:
        keep = [c for c in table.schema.names
                if c in task.pushdowns.columns or c in _filter_ref_columns(task)]
        table = table.select(keep)
    for i in range(0, max(table.num_rows, 1), morsel_rows):
        chunk = table.slice(i, morsel_rows)
        if chunk.num_rows or table.num_rows == 0:
            yield MicroPartition.from_arrow_table(chunk)
        if table.num_rows == 0:
            break


def _read_text_file(path: str, task: ScanTask, morsel_rows: int) -> Iterator[MicroPartition]:
    fs, p = resolve_filesystem(path, task.read_options.get("io_config"))
    with fs.open_input_stream(p) as stream:
        raw = stream.read()
    if raw[:2] == b"\x1f\x8b":
        # Still-gzipped text manifests (Common Crawl *.paths.gz; magic-byte
        # gated — pyarrow streams often decompress *.gz transparently).
        import gzip

        raw = gzip.decompress(raw)
    data = raw.decode("utf-8", errors="replace")
    lines = data.splitlines()
    for i in range(0, max(len(lines), 1), morsel_rows):
        chunk = lines[i:i + morsel_rows]
        yield MicroPartition.from_pydict({"text": chunk})
        if not lines:
            break


# -- schema inference ------------------------------------------------------
def infer_schema(paths: List[str], file_format: str, read_options=None,
                 files=None) -> Schema:
    """Infer schema from the first file (reference: per-format schema
    inference in daft-parquet/daft-csv/daft-json). Pass already-globbed
    ``files`` to avoid re-listing the store."""
    from daft_tpu_torch.io.scan import glob_paths

    read_options = read_options or {}
    if files is None:
        files = glob_paths(paths, read_options.get("io_config"))
    path = files[0].path
    fs, p = resolve_filesystem(path, read_options.get("io_config"))
    if file_format == "parquet":
        pf = pq.ParquetFile(fs.open_input_file(p))
        arrow_schema = pf.schema_arrow
        pf.close()
        return Schema.from_arrow(arrow_schema)
    if file_format == "csv":
        read_opts = pacsv.ReadOptions(block_size=1 << 20)
        if not read_options.get("has_headers", True):
            read_opts.autogenerate_column_names = True
        parse_opts = pacsv.ParseOptions(delimiter=read_options.get("delimiter", ","))
        with fs.open_input_stream(p) as stream:
            reader = pacsv.open_csv(stream, read_options=read_opts, parse_options=parse_opts)
            batch = reader.read_next_batch()
        return Schema.from_arrow(batch.schema)
    if file_format == "json":
        with fs.open_input_stream(p) as stream:
            table = pajson.read_json(stream)
        return Schema.from_arrow(table.schema)
    if file_format == "text":
        from daft_tpu_torch.datatype import DataType
        from daft_tpu_torch.schema import Field

        return Schema([Field("text", DataType.string())])
    raise DaftValueError(f"Unknown file format: {file_format}")


def _read_warc_file(path: str, task: ScanTask, morsel_rows: int) -> Iterator[MicroPartition]:
    """WARC (Common Crawl) reader (reference: src/daft-warc). Streams records
    incrementally — a multi-GB archive never materialises in memory. Handles
    plain and gzip payloads (pyarrow decompresses *.gz transparently; a
    still-gzipped payload is wrapped in GzipFile)."""
    import gzip
    import io as _io

    fs, p = resolve_filesystem(path, task.read_options.get("io_config"))
    stream = fs.open_input_stream(p)
    try:
        reader = _io.BufferedReader(_WarcRawAdapter(stream), buffer_size=1 << 20)
        head = reader.peek(2)[:2]
        if head == b"\x1f\x8b":
            reader = _io.BufferedReader(gzip.GzipFile(fileobj=reader), buffer_size=1 << 20)
        rows = {"WARC-Record-ID": [], "WARC-Type": [], "WARC-Target-URI": [],
                "WARC-Date": [], "Content-Length": [], "warc_content": []}
        while True:
            line = reader.readline()
            if not line:
                break
            if not line.startswith(b"WARC/"):
                continue
            headers = {}
            while True:
                h = reader.readline()
                if not h or h in (b"\r\n", b"\n"):
                    break
                if b":" in h:
                    k, v = h.split(b":", 1)
                    headers[k.strip().decode()] = v.strip().decode()
            length = int(headers.get("Content-Length", "0"))
            content = reader.read(length)
            rows["WARC-Record-ID"].append(headers.get("WARC-Record-ID"))
            rows["WARC-Type"].append(headers.get("WARC-Type"))
            rows["WARC-Target-URI"].append(headers.get("WARC-Target-URI"))
            rows["WARC-Date"].append(headers.get("WARC-Date"))
            rows["Content-Length"].append(length)
            rows["warc_content"].append(content)
            if len(rows["WARC-Type"]) >= morsel_rows:
                yield MicroPartition.from_pydict(dict(rows))
                rows = {k: [] for k in rows}
        if rows["WARC-Type"]:
            yield MicroPartition.from_pydict(dict(rows))
    finally:
        stream.close()


class _WarcRawAdapter:
    """Minimal raw-IO adapter so io.BufferedReader can wrap a pyarrow stream."""

    def __init__(self, stream):
        self._stream = stream

    def readable(self):
        return True

    def readinto(self, b):
        data = self._stream.read(len(b))
        n = len(data)
        b[:n] = data
        return n

    def read(self, n=-1):
        return self._stream.read(n if n is not None and n >= 0 else None)

    def close(self):
        pass

    closed = False
    seekable = lambda self: False
