"""File dtype runtime: lazy file handles usable inside UDFs (port of
``daft_tpu/io/file.py``).

Reference: src/daft-file (~1.7k LoC) — a ``File`` value is either inline bytes
or a URL/path opened lazily inside UDFs through
``io/scan.py::resolve_filesystem`` (local paths, ``file://``, object stores,
HTTP(S) and ``hf://``).
"""

from __future__ import annotations

import io
from typing import Optional

import pyarrow as pa

from daft_tpu_torch.datatype import DataType
from daft_tpu_torch.errors import DaftValueError


class File:
    """A lazy file value: inline data or a path/URL opened on demand."""

    __slots__ = ("_data", "_url")

    def __init__(self, data: Optional[bytes] = None, url: Optional[str] = None):
        if (data is None) == (url is None):
            raise DaftValueError("File requires exactly one of data= or url=")
        self._data = data
        self._url = url

    @staticmethod
    def from_bytes(data: bytes) -> "File":
        return File(data=data)

    @staticmethod
    def from_path(url: str) -> "File":
        return File(url=url)

    @property
    def url(self) -> Optional[str]:
        return self._url

    def open(self) -> io.BufferedIOBase:
        if self._data is not None:
            return io.BytesIO(self._data)
        from daft_tpu_torch.io.scan import resolve_filesystem

        fs, p = resolve_filesystem(self._url)
        return fs.open_input_stream(p)

    def read(self) -> bytes:
        if self._data is not None:
            return self._data
        with self.open() as f:
            return f.read()

    def size(self) -> int:
        if self._data is not None:
            return len(self._data)
        from daft_tpu_torch.io.scan import resolve_filesystem

        fs, p = resolve_filesystem(self._url)
        return fs.get_file_info(p).size

    def to_row(self) -> dict:
        return {"discriminant": 0 if self._data is not None else 1,
                "data": self._data, "url": self._url}

    @staticmethod
    def from_row(row: Optional[dict]) -> Optional["File"]:
        if row is None:
            return None
        if row["discriminant"] == 0:
            return File(data=row["data"])
        return File(url=row["url"])

    def __repr__(self) -> str:
        if self._data is not None:
            return f"File(<{len(self._data)} bytes>)"
        return f"File(url={self._url!r})"


def file_series(values, name: str = "file"):
    """Build a File-dtype Series from File objects / paths / bytes."""
    from daft_tpu_torch.series import Series

    rows = []
    for v in values:
        if v is None:
            rows.append(None)
        elif isinstance(v, File):
            rows.append(v.to_row())
        elif isinstance(v, bytes):
            rows.append(File(data=v).to_row())
        elif isinstance(v, str):
            rows.append(File(url=v).to_row())
        else:
            raise DaftValueError(f"Cannot build File from {type(v)}")
    dt = DataType.file()
    return Series.from_arrow(pa.array(rows, dt.to_arrow()), name, dt)
