"""URL/URI kernels: url_download / url_upload / url_parse (port of
``daft_tpu/kernels/uri_ops.py``).

Reference: src/daft-functions-uri (~722 LoC — batched async IO inside
expressions). Downloads run concurrently on a thread pool over pyarrow
filesystems (local/gs/s3) or urllib for http(s).
"""

from __future__ import annotations

import os
import uuid
from concurrent.futures import ThreadPoolExecutor
from typing import Optional
from urllib.parse import urlparse

from daft_tpu_torch.datatype import DataType
from daft_tpu_torch.errors import DaftIOError
from daft_tpu_torch.kernels.registry import register_kernel
from daft_tpu_torch.schema import Field
from daft_tpu_torch.series import Series

_MAX_CONNECTIONS = 32


def _fetch_one(url: Optional[str]) -> Optional[bytes]:
    if url is None:
        return None
    parsed = urlparse(url)
    if parsed.scheme in ("http", "https"):
        import urllib.request

        with urllib.request.urlopen(url, timeout=30) as resp:
            return resp.read()
    from daft_tpu_torch.io.scan import resolve_filesystem

    fs, p = resolve_filesystem(url)
    with fs.open_input_stream(p) as f:
        return f.read()


@register_kernel("url_download", lambda f, k: Field(f[0].name, DataType.binary()))
def _url_download(args, on_error: str = "raise", max_connections: int = _MAX_CONNECTIONS, **kwargs):
    s = args[0]
    urls = s.to_pylist()
    out: list = [None] * len(urls)

    def task(i_url):
        i, url = i_url
        try:
            out[i] = _fetch_one(url)
        except Exception as e:  # noqa: BLE001
            if on_error == "raise":
                raise DaftIOError(f"Failed to download {url!r}: {e}") from e
            out[i] = None

    with ThreadPoolExecutor(max_workers=min(max_connections, max(len(urls), 1))) as pool:
        list(pool.map(task, enumerate(urls)))
    return Series.from_pylist(out, s.name, DataType.binary())


@register_kernel("url_upload", lambda f, k: Field(f[0].name, DataType.string()))
def _url_upload(args, location: str = "", on_error: str = "raise", **kwargs):
    s = args[0]
    from daft_tpu_torch.io.scan import resolve_filesystem

    fs, base = resolve_filesystem(location)
    try:
        fs.create_dir(base, recursive=True)
    except Exception:
        pass
    out = []
    for data in s.to_pylist():
        if data is None:
            out.append(None)
            continue
        name = f"{uuid.uuid4().hex}"
        path = f"{base}/{name}"
        try:
            with fs.open_output_stream(path) as f:
                f.write(data if isinstance(data, bytes) else str(data).encode())
            out.append(os.path.join(location, name))
        except Exception as e:  # noqa: BLE001
            if on_error == "raise":
                raise DaftIOError(f"Failed to upload to {path!r}: {e}") from e
            out.append(None)
    return Series.from_pylist(out, s.name, DataType.string())


_PARSE_DT = DataType.struct({
    "scheme": DataType.string(), "host": DataType.string(), "port": DataType.int32(),
    "path": DataType.string(), "query": DataType.string(), "fragment": DataType.string(),
})


@register_kernel("url_parse", lambda f, k: Field(f[0].name, _PARSE_DT))
def _url_parse(args, **kwargs):
    s = args[0]
    out = []
    for url in s.to_pylist():
        if url is None:
            out.append(None)
            continue
        p = urlparse(url)
        out.append({
            "scheme": p.scheme or None, "host": p.hostname, "port": p.port,
            "path": p.path or None, "query": p.query or None, "fragment": p.fragment or None,
        })
    return Series.from_pylist(out, s.name, _PARSE_DT)
