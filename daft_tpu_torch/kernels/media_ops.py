"""Audio and video media kernels (port of ``daft_tpu/kernels/media_ops.py``).

Reference: daft/functions/{audio,video}.py — the reference decodes via
soundfile / av UDFs. Here, as in the JAX package: WAV metadata and a linear
resample (header parse, vectorized numpy), and AVI/RIFF metadata parsed from
the header, all on the host; formats that need ffmpeg raise a clear error.
"""

from __future__ import annotations

import struct

import numpy as np

from daft_tpu_torch.datatype import DataType
from daft_tpu_torch.errors import DaftValueError
from daft_tpu_torch.kernels.registry import register_kernel
from daft_tpu_torch.schema import Field
from daft_tpu_torch.series import Series

_AUDIO_META = DataType.struct({
    "sample_rate": DataType.int64(), "channels": DataType.int64(),
    "frames": DataType.int64(), "duration_sec": DataType.float64(),
    "format": DataType.string(),
})
_VIDEO_META = DataType.struct({
    "width": DataType.int64(), "height": DataType.int64(),
    "fps": DataType.float64(), "frames": DataType.int64(),
    "duration_sec": DataType.float64(), "format": DataType.string(),
})


def _read_bytes(v):
    if v is None:
        return None
    if isinstance(v, (bytes, bytearray)):
        return bytes(v)
    with open(v, "rb") as f:
        return f.read()


def _parse_wav(data: bytes, with_offset: bool = False):
    """RIFF chunk walk; with_offset also returns the data payload offset
    (never substring-search for b"data" — comment chunks may contain it)."""
    if len(data) < 44 or data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        return None
    pos = 12
    fmt = None
    frames = 0
    data_off = None
    while pos + 8 <= len(data):
        cid = data[pos:pos + 4]
        (size,) = struct.unpack("<I", data[pos + 4:pos + 8])
        if cid == b"fmt ":
            (_, channels, rate, _, block_align, _) = struct.unpack(
                "<HHIIHH", data[pos + 8:pos + 24])
            fmt = (channels, rate, block_align)
        elif cid == b"data" and fmt is not None:
            frames = size // max(fmt[2], 1)
            data_off = pos + 8
        pos += 8 + size + (size & 1)
    if fmt is None:
        return None
    channels, rate, _ = fmt
    meta = {"sample_rate": rate, "channels": channels, "frames": frames,
            "duration_sec": frames / rate if rate else 0.0, "format": "wav"}
    return (meta, data_off) if with_offset else meta


@register_kernel("audio_metadata", lambda f, k: Field(f[0].name, _AUDIO_META))
def _audio_metadata(args, **kwargs):
    def do(v):
        data = _read_bytes(v)
        if data is None:
            return None
        meta = _parse_wav(data)
        if meta is None:
            raise DaftValueError(
                "audio_metadata: only WAV is natively decodable in this build")
        return meta

    return Series.from_pylist([do(v) for v in args[0].to_pylist()],
                              args[0].name, _AUDIO_META)


@register_kernel("audio_resample",
                 lambda f, k: Field(f[0].name, DataType.list(DataType.float32())))
def _audio_resample(args, target_rate: int = 16000, **kwargs):
    """Linear resample of PCM samples (list<float> + source rate kwarg or
    WAV bytes). Vectorized numpy — the device path runs inside model UDFs."""
    source_rate = kwargs.get("source_rate")

    def do(v):
        if v is None:
            return None
        if isinstance(v, (bytes, bytearray, str)):
            data = _read_bytes(v)
            parsed = _parse_wav(data, with_offset=True)
            if parsed is None or parsed[1] is None:
                raise DaftValueError("audio_resample: not a WAV payload")
            meta, data_off = parsed
            pcm = np.frombuffer(data, np.int16, offset=data_off,
                                count=meta["frames"] * meta["channels"])
            samples = pcm.astype(np.float32).reshape(-1, meta["channels"]).mean(1) / 32768.0
            rate = meta["sample_rate"]
        else:
            samples = np.asarray(v, dtype=np.float32)
            rate = source_rate or target_rate
        if rate == target_rate or len(samples) == 0:
            return samples.tolist()
        n_out = int(round(len(samples) * target_rate / rate))
        x = np.linspace(0.0, len(samples) - 1, n_out)
        return np.interp(x, np.arange(len(samples)), samples).astype(np.float32).tolist()

    return Series.from_pylist([do(v) for v in args[0].to_pylist()],
                              args[0].name, DataType.list(DataType.float32()))


def _parse_avi(data: bytes):
    if len(data) < 64 or data[:4] != b"RIFF" or data[8:12] != b"AVI ":
        return None
    idx = data.find(b"avih")
    if idx < 0 or idx + 64 > len(data):
        return None
    (us_per_frame, _, _, _, total_frames, _, _, width, height) = struct.unpack(
        "<IIIIIIIII", data[idx + 8:idx + 44])
    fps = 1e6 / us_per_frame if us_per_frame else 0.0
    return {"width": width, "height": height, "fps": fps, "frames": total_frames,
            "duration_sec": total_frames / fps if fps else 0.0, "format": "avi"}


@register_kernel("video_metadata", lambda f, k: Field(f[0].name, _VIDEO_META))
def _video_metadata(args, **kwargs):
    def do(v):
        data = _read_bytes(v)
        if data is None:
            return None
        meta = _parse_avi(data)
        if meta is None:
            raise DaftValueError(
                "video_metadata: only AVI/RIFF is natively parseable in this "
                "build (ffmpeg/av not available)")
        return meta

    return Series.from_pylist([do(v) for v in args[0].to_pylist()],
                              args[0].name, _VIDEO_META)
