"""The port's media sources (``daft_tpu_torch/io/media_sources.py``) against
the JAX package's, on the CPU.

Mirrors ``tests/test_io_media_sources.py`` case for case: the same MCAP files
(plain, and with a chunk stored raw, zstd or lz4), video and globbed files,
written in ``tmp_path``, go through both packages (``device="cpu"`` for the
port) and must give the JAX package's rows and the values the JAX test
asserts. ``read_video_frames``' frames must equal ``video_frames``' at the
same width and height, bit for bit. Exact equality throughout.
"""

import struct
import warnings

import numpy as np
import pyarrow as pa
import pytest

import daft_tpu
import daft_tpu_torch
from torch_isolation import caches_reset  # noqa: F401

pytestmark = pytest.mark.usefixtures("caches_reset")

PKGS = (daft_tpu, daft_tpu_torch)
MAGIC = b"\x89MCAP0\r\n"


@pytest.fixture(autouse=True)
def _cpu():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        with daft_tpu.execution_config_ctx(result_cache_enabled=False), \
                daft_tpu_torch.execution_config_ctx(device="cpu", result_cache_enabled=False):
            yield


def _both(build):
    """``build(pkg)`` in the port, held equal to the JAX package's."""
    jax, port = (build(pkg) for pkg in PKGS)
    assert port == jax
    return port


def _rec(op: int, payload: bytes) -> bytes:
    return bytes([op]) + struct.pack("<Q", len(payload)) + payload


def _s(text: str) -> bytes:
    b = text.encode()
    return struct.pack("<I", len(b)) + b


def _channel(cid: int, topic: str) -> bytes:
    return _rec(0x04, struct.pack("<H", cid) + struct.pack("<H", 1) +
                _s(topic) + _s("json") + struct.pack("<I", 0))


def _message(cid: int, seq: int, log_t: int, pub_t: int, data: bytes) -> bytes:
    return _rec(0x05, struct.pack("<HIQQ", cid, seq, log_t, pub_t) + data)


def _write_mcap(path, chunk_compression=None):
    """Minimal spec-conformant MCAP: header, channels, messages (optionally
    inside a compressed chunk), data-end, footer."""
    header = _rec(0x01, _s("") + _s("daft-test"))
    body = (_channel(1, "/camera") + _channel(2, "/lidar") +
            _message(1, 0, 100, 90, b"img-a") +
            _message(2, 0, 150, 140, b"pc-a") +
            _message(1, 1, 200, 190, b"img-b"))
    if chunk_compression is not None:
        blob = body if not chunk_compression else pa.Codec(chunk_compression).compress(
            body, asbytes=True)
        body = _rec(0x06, struct.pack("<QQQ", 100, 200, len(body)) + struct.pack("<I", 0) +
                    _s(chunk_compression) + struct.pack("<Q", len(blob)) + blob)
    data_end = _rec(0x0F, struct.pack("<I", 0))
    footer = _rec(0x02, struct.pack("<QQI", 0, 0, 0))
    path.write_bytes(MAGIC + header + body + data_end + footer + MAGIC)


@pytest.mark.parametrize("compression", [None, "", "zstd", "lz4"])
def test_read_mcap(tmp_path, compression):
    p = tmp_path / "log.mcap"
    _write_mcap(p, chunk_compression=compression)
    out = _both(lambda pkg: pkg.read_mcap(str(p)).sort("log_time").to_pydict())
    assert out["topic"] == ["/camera", "/lidar", "/camera"]
    assert out["log_time"] == [100, 150, 200]
    assert out["publish_time"] == [90, 140, 190]
    assert out["sequence"] == [0, 0, 1]
    assert out["data"] == [b"img-a", b"pc-a", b"img-b"]
    assert _both(lambda pkg: [(f.name, repr(f.dtype)) for f in pkg.read_mcap(str(p)).schema])


def test_read_mcap_filters(tmp_path):
    p = tmp_path / "log.mcap"
    _write_mcap(p, chunk_compression="zstd")
    only_cam = _both(lambda pkg: pkg.read_mcap(str(p), topics=["/camera"]).to_pydict())
    assert only_cam["topic"] == ["/camera", "/camera"]
    windowed = _both(lambda pkg: pkg.read_mcap(str(p), start_time=120, end_time=180).to_pydict())
    assert windowed["topic"] == ["/lidar"]
    # engine pushdowns compose on top
    agg = _both(lambda pkg: pkg.read_mcap(str(p)).groupby("topic").agg(
        pkg.col("sequence").count().alias("n")).sort("topic").to_pydict())
    assert agg == {"topic": ["/camera", "/lidar"], "n": [2, 1]}
    batched = _both(lambda pkg: pkg.read_mcap(str(p), batch_size=2).to_pydict())
    assert batched["log_time"] == [100, 150, 200]


def test_read_mcap_bad_magic(tmp_path):
    p = tmp_path / "bad.mcap"
    p.write_bytes(b"not an mcap file")
    for pkg in PKGS:
        with pytest.raises(Exception, match="magic"):
            pkg.read_mcap(str(p)).collect()


def _write_video(path, n=8, w=64, h=48):
    cv2 = pytest.importorskip("cv2")
    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 10, (w, h))
    rng = np.random.default_rng(n)
    for i in range(n):
        vw.write(np.clip(rng.integers(0, 256, (h, w, 3)) // 4 + i * 30 % 255, 0, 255
                         ).astype(np.uint8))
    vw.release()


def test_read_video_frames(tmp_path):
    p = tmp_path / "v.mp4"
    _write_video(p)

    def run(pkg):
        df = pkg.read_video_frames(str(p), image_height=24, image_width=32)
        out = df.to_pydict()
        return ({k: v for k, v in out.items() if k != "data"},
                [np.asarray(a, dtype=np.uint8).tobytes() for a in out["data"]],
                repr(df.schema["data"].dtype),
                df.where(pkg.col("frame_index") % 2 == 0).count_rows())

    out, data, dtype, n = _both(run)
    assert len(out["frame_index"]) == 8 and out["path"][0] == str(p)
    assert out["frame_index"] == list(range(8))
    assert dtype == repr(daft_tpu_torch.DataType.image("RGB", 24, 32)) and n == 4
    # The same frames as video_frames' at that size, bit for bit.
    F = daft_tpu_torch.functions
    rows = daft_tpu_torch.from_pydict({"p": [str(p)]}).select(F.video_frames(
        F.video_file(daft_tpu_torch.col("p")), width=32, height=24).alias("fr")
    ).to_pydict()["fr"][0]
    assert [r["data"]["data"] for r in rows] == data
    for key in ("frame_index", "frame_time", "frame_time_base", "frame_pts", "frame_dts",
                "frame_duration", "is_key_frame"):
        assert [r[key] for r in rows] == out[key]


def test_from_files(tmp_path):
    for i in range(3):
        (tmp_path / f"f{i}.txt").write_text(f"data{i}")

    def run(pkg):
        df = pkg.from_files(str(tmp_path / "*.txt"))
        out = df.to_pydict()
        return (df.schema["file"].dtype.id.value, sorted(f.read() for f in out["file"]),
                sorted(f.url for f in out["file"]),
                pkg.from_files(str(tmp_path / "*.nope")).count_rows())

    dtype, data, urls, empty = _both(run)
    assert dtype == "file" and data == [b"data0", b"data1", b"data2"] and len(urls) == 3
    # empty glob -> empty frame, not an error (reference behavior)
    assert empty == 0
    # An object store's prefix, through the context's IOConfig, as in the JAX
    # package. A glob over the native client's handler matches nothing in
    # either package (C.50: glob_paths takes every PyFileSystem for HTTP).
    from daft_tpu_torch.tools.object_stores import S3Stub

    with S3Stub() as stub:
        stub.mount("bucket", str(tmp_path))

        def remote(pkg):
            cfg = pkg.IOConfig(s3=pkg.S3Config(endpoint_url=stub.url, region_name=stub.region,
                                               key_id=stub.key_id, access_key=stub.secret,
                                               use_native_client=True))
            with pkg.planning_config_ctx(default_io_config=cfg):
                out = pkg.from_files("s3://bucket/").to_pydict()["file"]
                return ([f.url for f in out], [f.read() for f in out], [f.size() for f in out],
                        pkg.from_files("s3://bucket/*.txt").count_rows())

        urls, data, sizes, globbed = _both(remote)
        assert urls == [f"s3://bucket/f{i}.txt" for i in range(3)] and not stub.bad_auth
        assert data == [b"data0", b"data1", b"data2"] and sizes == [5, 5, 5] and globbed == 0


def test_gated_sources_raise_clearly():
    for pkg in PKGS:
        with pytest.raises(pkg.errors.DaftIOError, match="confluent-kafka"):
            pkg.read_kafka(["t"], bootstrap_servers="localhost:9092")
        with pytest.raises(pkg.errors.DaftIOError, match="pypaimon"):
            pkg.read_paimon(object())


def test_io_config_surface():
    for pkg in PKGS:
        cfg = pkg.IOConfig(
            s3=pkg.S3Config(region_name="us-east-1"),
            unity=pkg.UnityConfig(endpoint="http://dbx"),
            hf=pkg.HuggingFaceConfig(anonymous=True),
        )
        assert cfg.s3.region_name == "us-east-1"
        assert cfg.unity.endpoint == "http://dbx"
        assert pkg.S3Credentials(key_id="k").key_id == "k"
        for name in ("CosConfig", "TosConfig", "GooseFSConfig", "GravitinoConfig"):
            assert getattr(pkg, name)() is not None
