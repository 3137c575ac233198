"""URL kernels (port of ``daft_tpu/kernels/uri_ops.py``; reference:
src/daft-functions-uri). The port has ``url_parse``; ``url_download`` and
``url_upload`` come with the remote IO clients (``registry.LEFT_OUT``)."""

from __future__ import annotations

from urllib.parse import urlparse

from daft_tpu_torch.datatype import DataType
from daft_tpu_torch.kernels.registry import register_kernel
from daft_tpu_torch.schema import Field
from daft_tpu_torch.series import Series

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
