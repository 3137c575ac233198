"""Typed file-reference kernels: constructors with format verification, and
image-file decode/metadata (port of ``daft_tpu/kernels/file_ops.py``).

Reference: daft/functions/file_.py (file/video_file/audio_file/image_file/
hdf5_file), daft/functions/image_file_.py (decode_image_file,
image_file_metadata), src/daft-file (File runtime). Format verification is a
host-side magic-byte sniff over the file header — the engine never needs a
full decode to reject a mistyped column.
"""

from __future__ import annotations

import io

import pyarrow as pa

from daft_tpu_torch.datatype import DataType
from daft_tpu_torch.errors import DaftValueError
from daft_tpu_torch.io.file import File
from daft_tpu_torch.kernels.registry import register_kernel
from daft_tpu_torch.schema import Field
from daft_tpu_torch.series import Series

_FILE = DataType.file()


def _sniff_image(head: bytes) -> bool:
    return (
        head.startswith(b"\x89PNG\r\n\x1a\n")
        or head.startswith(b"\xff\xd8\xff")            # JPEG
        or head.startswith((b"GIF87a", b"GIF89a"))
        or head.startswith(b"BM")                       # BMP
        or head.startswith((b"II*\x00", b"MM\x00*"))   # TIFF
        or (head[:4] == b"RIFF" and head[8:12] == b"WEBP")
    )


def _sniff_video(head: bytes) -> bool:
    return (
        head[4:8] == b"ftyp"                            # MP4 / MOV / M4V
        or (head[:4] == b"RIFF" and head[8:12] == b"AVI ")
        or head.startswith(b"\x1aE\xdf\xa3")            # Matroska / WebM
        or head.startswith(b"\x00\x00\x01\xba")         # MPEG-PS
    )


def _sniff_audio(head: bytes) -> bool:
    return (
        (head[:4] == b"RIFF" and head[8:12] == b"WAVE")
        or head.startswith(b"ID3")                      # MP3 w/ ID3 tag
        or head[:2] in (b"\xff\xfb", b"\xff\xf3", b"\xff\xf2")  # MP3 frame
        or head.startswith(b"fLaC")
        or head.startswith(b"OggS")
        or head[4:8] == b"ftypM4A "[:4] and head[8:11] == b"M4A"
    )


def _sniff_hdf5(head: bytes) -> bool:
    return head.startswith(b"\x89HDF\r\n\x1a\n")


_SNIFFERS = {
    "image": _sniff_image,
    "video": _sniff_video,
    "audio": _sniff_audio,
    "hdf5": _sniff_hdf5,
}


def _head_bytes(f: File, n: int = 16) -> bytes:
    with f.open() as fh:
        return fh.read(n)


@register_kernel("file_path", lambda f, k: Field(f[0].name, DataType.string()))
def _file_path(args, **kwargs):
    """Path/URL of each File value (null for inline-bytes files)
    (reference: daft Expression.file_path over the File dtype)."""
    s = args[0]
    rows = []
    for v in s.to_pylist():
        if isinstance(v, File):
            rows.append(v._url)
        elif isinstance(v, str):
            rows.append(v)
        else:
            rows.append(None)
    return Series.from_arrow(pa.array(rows, pa.large_string()), s.name,
                             DataType.string())


@register_kernel("file_ref", lambda f, k: Field(f[0].name, _FILE))
def _file_ref(args, kind=None, verify: bool = False, **kwargs):
    """String path/URL or inline binary -> File column, optionally verifying
    the header magic for ``kind`` in {image, video, audio, hdf5}."""
    s = args[0]
    sniff = _SNIFFERS.get(kind) if kind else None
    rows = []
    for v in s.to_pylist():
        if v is None:
            rows.append(None)
            continue
        if isinstance(v, File):
            f = v
        elif isinstance(v, bytes):
            f = File(data=v)
        elif isinstance(v, str):
            f = File(url=v)
        else:
            raise DaftValueError(f"Cannot build File from {type(v).__name__}")
        if verify and sniff is not None:
            head = _head_bytes(f)
            if not sniff(head):
                raise DaftValueError(
                    f"File {f!r} is not a valid {kind} file "
                    f"(header: {head[:8]!r})")
        rows.append(f.to_row())
    return Series.from_arrow(pa.array(rows, _FILE.to_arrow()), s.name, _FILE)


def _decode_image_file_resolver(fields, kwargs):
    from daft_tpu_torch.datatype import ImageMode

    mode = kwargs.get("mode")
    if isinstance(mode, str):
        mode = ImageMode.from_str(mode)
    return Field(fields[0].name, DataType.image(mode))


@register_kernel("decode_image_file", _decode_image_file_resolver)
def _decode_image_file(args, mode=None, on_error: str = "raise", **kwargs):
    """File column -> Image column (read bytes, then the image_decode path)."""
    from daft_tpu_torch.kernels.registry import get_kernel

    s = args[0]
    raw = []
    for v in s.to_pylist():
        if v is None:
            raw.append(None)
        else:
            try:
                raw.append(v.read())
            except Exception:
                if on_error == "raise":
                    raise
                raw.append(None)
    blob = Series.from_arrow(pa.array(raw, pa.large_binary()), s.name,
                             DataType.binary())
    return get_kernel("image_decode")([blob], mode=mode, on_error=on_error)


_IMG_META = DataType.struct({
    "width": DataType.uint32(),
    "height": DataType.uint32(),
    "format": DataType.string(),
    "mode": DataType.string(),
})


@register_kernel("image_file_metadata", lambda f, k: Field(f[0].name, _IMG_META))
def _image_file_metadata(args, **kwargs):
    """Header-only image metadata (width/height/format/mode) from a File
    column — PIL parses the header without decoding pixel data."""
    from PIL import Image as PILImage

    s = args[0]
    rows = []
    for v in s.to_pylist():
        if v is None:
            rows.append(None)
            continue
        try:
            img = PILImage.open(io.BytesIO(v.read()))
            rows.append({
                "width": img.width, "height": img.height,
                "format": (img.format or "").lower(), "mode": img.mode,
            })
        except Exception:
            rows.append(None)
    return Series.from_arrow(pa.array(rows, _IMG_META.to_arrow()), s.name,
                             _IMG_META)
