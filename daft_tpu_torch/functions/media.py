"""Typed-file, HDF5, video and process functions (port of
``daft_tpu/functions/media.py``).

Reference: daft/functions/{file_.py,hdf5.py,video.py,image_file_.py,process.py}.
The File constructors verify format by magic-byte sniffing
(``kernels/file_ops.py``). They take no ``io_config``: ``File`` reads local
paths and ``file://`` URLs only (remote schemes are ROADMAP A.8). The HDF5
functions use h5py, imported where the JAX package imports it (never at
``import daft_tpu_torch``); the video decode uses OpenCV, and MP4 / AVI
keyframe indices come from container parsing (stss box / idx1
AVIIF_KEYFRAME flags), since cv2 does not expose keyframes. Each of these
runs on the host through a row-wise UDF (``udf.func``), as in the JAX package.
"""

from __future__ import annotations

import struct
import subprocess
from typing import List, Optional

from daft_tpu_torch.datatype import DataType
from daft_tpu_torch.errors import DaftValueError
from daft_tpu_torch.expressions.expression import Expression, col, lit
from daft_tpu_torch.io.file import File


def _fref(url, kind=None, verify: bool = False) -> Expression:
    e = url if isinstance(url, Expression) else col(url)
    return e._fn("file_ref", kind=kind, verify=verify)


def file(url) -> Expression:
    """String path/URL (or inline bytes) -> File reference column
    (reference: daft/functions/file_.py file)."""
    return _fref(url)


def video_file(url, verify: bool = False) -> Expression:
    """String -> File[Video]; with verify=True the header magic is checked
    (reference: file_.py video_file)."""
    return _fref(url, "video", verify)


def audio_file(url, verify: bool = False) -> Expression:
    """String -> File[Audio] (reference: file_.py audio_file)."""
    return _fref(url, "audio", verify)


def image_file(url, verify: bool = False) -> Expression:
    """String -> File[Image] (reference: file_.py image_file)."""
    return _fref(url, "image", verify)


def hdf5_file(url, verify: bool = False) -> Expression:
    """String -> File[Hdf5] (reference: file_.py hdf5_file)."""
    return _fref(url, "hdf5", verify)


def decode_image_file(file_expr: Expression, mode: Optional[str] = None,
                      on_error: str = "raise") -> Expression:
    """File -> decoded Image column (reference: image_file_.py
    decode_image_file)."""
    return file_expr._fn("decode_image_file", mode=mode, on_error=on_error)


def image_file_metadata(file_expr: Expression) -> Expression:
    """File -> struct{width, height, format, mode} without decoding pixels
    (reference: image_file_.py image_file_metadata)."""
    return file_expr._fn("image_file_metadata")


# ------------------------------------------------------------------ #
# HDF5 (reference: daft/functions/hdf5.py, via h5py)                   #
# ------------------------------------------------------------------ #
def _h5_open(f: File):
    import io as _io

    import h5py

    return h5py.File(_io.BytesIO(f.read()), "r")


def hdf5_keys(file_expr: Expression, group: str = "/") -> Expression:
    """List member names directly under an HDF5 group (reference: hdf5.py
    hdf5_keys)."""
    from daft_tpu_torch.udf import func as _udf

    @_udf(return_dtype=DataType.list(DataType.string()))
    def _keys(f):
        if f is None:
            return None
        with _h5_open(f) as h5:
            return list(h5[group].keys())

    return _keys(file_expr)


_H5_META = DataType.list(DataType.struct({
    "h5path": DataType.string(), "kind": DataType.string(),
    "shape": DataType.list(DataType.int64()), "dtype": DataType.string(),
    "chunks": DataType.list(DataType.int64()), "compression": DataType.string(),
}))


def hdf5_metadata(file_expr: Expression, group: str = "/") -> Expression:
    """Metadata structs for each object under an HDF5 group (reference:
    hdf5.py hdf5_metadata)."""
    import h5py

    from daft_tpu_torch.udf import func as _udf

    @_udf(return_dtype=_H5_META)
    def _meta(f):
        if f is None:
            return None
        out = []
        with _h5_open(f) as h5:
            g = h5[group]
            for name in g:
                obj = g[name]
                if isinstance(obj, h5py.Dataset):
                    out.append({
                        "h5path": obj.name, "kind": "dataset",
                        "shape": [int(s) for s in obj.shape],
                        "dtype": str(obj.dtype),
                        "chunks": [int(c) for c in obj.chunks] if obj.chunks else None,
                        "compression": obj.compression,
                    })
                else:
                    out.append({"h5path": obj.name, "kind": "group",
                                "shape": None, "dtype": None, "chunks": None,
                                "compression": None})
        return out

    return _meta(file_expr)


def hdf5_attrs(file_expr: Expression, h5path: str = "/") -> Expression:
    """HDF5 attributes of a group/dataset as a Python dict (reference:
    hdf5.py hdf5_attrs)."""
    from daft_tpu_torch.udf import func as _udf

    @_udf(return_dtype=DataType.python())
    def _attrs(f):
        if f is None:
            return None
        with _h5_open(f) as h5:
            return {k: (v.tolist() if hasattr(v, "tolist") else v)
                    for k, v in h5[h5path].attrs.items()}

    return _attrs(file_expr)


# ------------------------------------------------------------------ #
# Video (reference: daft/functions/video.py, via cv2 + container      #
# parsing for keyframe indices)                                       #
# ------------------------------------------------------------------ #
def _mp4_keyframe_indices(data: bytes) -> Optional[List[int]]:
    """Parse the first video trak's stss (sync sample) box: 1-based sample
    numbers of keyframes. Returns None when absent (then ALL samples are
    sync samples per the MP4 spec)."""
    def walk(buf, start, end, path):
        off = start
        while off + 8 <= end:
            size, box = struct.unpack_from(">I4s", buf, off)
            if size == 1:
                size = struct.unpack_from(">Q", buf, off + 8)[0]
                hdr = 16
            else:
                hdr = 8
            if size < hdr or off + size > end:
                return None
            name = box.decode("latin1")
            if name == path[0]:
                if len(path) == 1:
                    return (off + hdr, off + size)
                r = walk(buf, off + hdr, off + size, path[1:])
                if r is not None:
                    return r
            off += size
        return None

    # moov/trak/mdia/minf/stbl/stss — first trak carrying one wins.
    span = walk(data, 0, len(data), ["moov", "trak", "mdia", "minf", "stbl", "stss"])
    if span is None:
        return None
    s, e = span
    if e - s < 8:
        return None
    count = struct.unpack_from(">I", data, s + 4)[0]
    out = []
    for i in range(count):
        p = s + 8 + 4 * i
        if p + 4 > e:
            break
        out.append(struct.unpack_from(">I", data, p)[0] - 1)  # to 0-based
    return out


def _avi_keyframe_indices(data: bytes) -> Optional[List[int]]:
    """Parse the AVI idx1 chunk: entries with AVIIF_KEYFRAME (0x10) set."""
    pos = data.find(b"idx1")
    if pos < 0 or pos + 8 > len(data):
        return None
    size = struct.unpack_from("<I", data, pos + 4)[0]
    out, frame = [], 0
    for off in range(pos + 8, min(pos + 8 + size, len(data) - 15), 16):
        ckid, flags = data[off:off + 4], struct.unpack_from("<I", data, off + 4)[0]
        if ckid[2:4] in (b"dc", b"db"):  # video frame chunk
            if flags & 0x10:
                out.append(frame)
            frame += 1
    return out


def _keyframe_indices(data: bytes) -> Optional[List[int]]:
    if len(data) > 12 and data[4:8] == b"ftyp":
        return _mp4_keyframe_indices(data)
    if data[:4] == b"RIFF" and data[8:12] == b"AVI ":
        return _avi_keyframe_indices(data)
    return None


def _img_row(frame_rgb) -> dict:
    import numpy as np

    from daft_tpu_torch.datatype import ImageMode

    arr = np.ascontiguousarray(frame_rgb)
    return {"data": arr.tobytes(), "channel": arr.shape[2],
            "height": arr.shape[0], "width": arr.shape[1],
            "mode": ImageMode.RGB.value}


_FRAME_STRUCT = DataType.struct({
    "frame_index": DataType.int64(),
    "frame_time": DataType.float64(),
    "frame_time_base": DataType.string(),
    "frame_pts": DataType.int64(),
    "frame_dts": DataType.int64(),
    "frame_duration": DataType.int64(),
    "is_key_frame": DataType.bool(),
    "data": DataType.image("RGB"),
})


def _decode_frames(f: File, start_time: float, end_time, width, height,
                   is_key_frame, sample_interval_seconds):
    import os
    import tempfile

    import cv2
    import numpy as np

    data = f.read()
    # Always parse container keyframe indices (cheap) so the per-frame
    # is_key_frame metadata is truthful even when no filtering was asked.
    # When the container has no sync-sample table, every sample is a sync
    # sample per the MP4 spec.
    keys = _keyframe_indices(data)
    keyset = set(keys) if keys is not None else None
    # cv2 VideoCapture needs a real path.
    with tempfile.NamedTemporaryFile(suffix=".bin", delete=False) as tmp:
        tmp.write(data)
        path = tmp.name
    try:
        cap = cv2.VideoCapture(path)
        if not cap.isOpened():
            raise DaftValueError(f"cannot decode video {f!r}")
        fps = cap.get(cv2.CAP_PROP_FPS) or 0.0
        tb = 1.0 / fps if fps else 0.0
        out, idx = [], -1
        next_target = start_time
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            idx += 1
            t = (cap.get(cv2.CAP_PROP_POS_MSEC) / 1000.0) or (idx * tb)
            # POS_MSEC is the time of the NEXT frame; this frame's pts:
            ft = max(t - tb, 0.0) if fps else t
            if ft < start_time:
                continue
            if end_time is not None and ft > end_time:
                break
            is_key = keyset is None or idx in (keyset or ())
            if is_key_frame is True and keyset is not None and idx not in keyset:
                continue
            if is_key_frame is False and keyset is not None and idx in keyset:
                continue
            if sample_interval_seconds and sample_interval_seconds > 0:
                if ft < next_target:
                    continue
                next_target = max(next_target + sample_interval_seconds,
                                  ft + 1e-9)
            rgb = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
            if width and height:
                rgb = cv2.resize(rgb, (width, height))
            pts = int(round(ft / tb)) if tb else idx
            out.append({
                "frame_index": idx, "frame_time": ft,
                "frame_time_base": f"1/{int(round(fps))}" if fps else "0/1",
                "frame_pts": pts, "frame_dts": pts,
                "frame_duration": 1,
                "is_key_frame": bool(is_key),
                "data": _img_row(rgb),
            })
        cap.release()
        return out
    finally:
        os.unlink(path)


def video_frames(file_expr: Expression, *, start_time: float = 0,
                 end_time: Optional[float] = None, width: Optional[int] = None,
                 height: Optional[int] = None, is_key_frame: Optional[bool] = None,
                 sample_interval_seconds: Optional[float] = None) -> Expression:
    """Decode video frames in a time range with per-frame metadata
    (reference: daft/functions/video.py video_frames)."""
    from daft_tpu_torch.udf import func as _udf

    @_udf(return_dtype=DataType.list(_FRAME_STRUCT))
    def _frames(f):
        if f is None:
            return []
        return _decode_frames(f, start_time, end_time, width, height,
                              is_key_frame, sample_interval_seconds)

    return _frames(file_expr)


def video_keyframes(file_expr: Expression, *, start_time: float = 0,
                    end_time: Optional[float] = None) -> Expression:
    """Decode only keyframes (container sync samples) as a list of images
    (reference: video.py video_keyframes)."""
    from daft_tpu_torch.udf import func as _udf

    @_udf(return_dtype=DataType.list(DataType.image("RGB")))
    def _keyframes(f):
        if f is None:
            return []
        rows = _decode_frames(f, start_time, end_time, None, None, True, None)
        return [r["data"] for r in rows]

    return _keyframes(file_expr)


# ------------------------------------------------------------------ #
# Process (reference: daft/functions/process.py run_process)           #
# ------------------------------------------------------------------ #
def run_process(args, *, shell: bool = False, on_error: str = "log",
                return_dtype: Optional[DataType] = None) -> Expression:
    """Run an external process per row, exposing its stdout as a column
    (reference: daft/functions/process.py run_process)."""
    import logging

    from daft_tpu_torch.udf import func as _udf

    rd = return_dtype or DataType.string()
    arg_list = args if isinstance(args, (list, tuple)) else [args]
    if shell and len(arg_list) != 1:
        raise ValueError(
            "run_process with shell=True requires exactly one string "
            "expression; row values must not be joined into shell syntax")
    exprs = [a if isinstance(a, Expression) else lit(a) for a in arg_list]

    def _cast_stdout(out: bytes):
        kind = rd.id.value
        if kind == "binary":
            return out
        # errors="replace": a successful command whose stdout holds stray
        # non-UTF-8 bytes must not be misreported as a process failure.
        s = out.decode(errors="replace").strip()
        if kind in ("int8", "int16", "int32", "int64",
                    "uint8", "uint16", "uint32", "uint64"):
            return int(s or 0)
        if kind in ("float32", "float64"):
            return float(s or 0.0)
        if kind == "bool":
            return s.lower() in ("1", "true", "t", "yes")
        return out.decode(errors="replace")

    @_udf(return_dtype=rd)
    def _run(*argv):
        cmd = str(argv[0]) if shell else [str(a) for a in argv]
        try:
            # capture raw bytes: binary stdout must survive untouched
            proc = subprocess.run(cmd, shell=shell, capture_output=True,
                                  check=True)
            return _cast_stdout(proc.stdout)
        except Exception as e:
            if on_error == "raise":
                raise
            if on_error == "log":
                logging.warning("run_process failed: %s", e)
            return None

    return _run(*exprs)
