"""HTTP(S) + HuggingFace object sources (port of
``daft_tpu/io/http_source.py``).

Reference: src/daft-io/src/{http.rs,huggingface/} — an HTTP object store
serving sized stat (HEAD), full gets, and RANGED gets, plus the hf:// URI
scheme resolved onto huggingface.co resolve URLs.

Design: :class:`HttpReadableFile` is a seekable file over HTTP Range
requests, and :class:`HttpFileSystemHandler` wraps it as a
``pyarrow.fs.PyFileSystem`` — so every existing reader (parquet row-group
pruning included) transparently issues genuine ranged reads against remote
HTTP objects, with per-request retry/backoff and IO-stats accounting.
"""

from __future__ import annotations

import io
import urllib.error
import urllib.request
from typing import Optional

import pyarrow.fs as pafs

from daft_tpu_torch.errors import DaftIOError
from daft_tpu_torch.io.iostats import IO_STATS
from daft_tpu_torch.io.retry import RetryPolicy, with_retries

_USER_AGENT = "daft-tpu/0"


class _HttpStatusError(DaftIOError):
    def __init__(self, msg: str, status: int, retry_after: Optional[str] = None):
        super().__init__(msg)
        self.status = status
        self.retry_after = retry_after


def _is_retryable(e: BaseException, policy: RetryPolicy) -> bool:
    if isinstance(e, _HttpStatusError):
        return e.status in policy.retryable_statuses
    return isinstance(e, policy.retryable_exceptions)


def _request(url: str, headers: dict, method: str = "GET",
             timeout: float = 60.0):
    req = urllib.request.Request(url, headers={"User-Agent": _USER_AGENT,
                                               **headers}, method=method)
    try:
        return urllib.request.urlopen(req, timeout=timeout)
    except urllib.error.HTTPError as e:
        raise _HttpStatusError(f"{method} {url}: HTTP {e.code}", e.code,
                               e.headers.get("Retry-After")) from e
    except (urllib.error.URLError, TimeoutError, OSError) as e:
        raise ConnectionError(f"{method} {url}: {e}") from e


def http_head(url: str, policy: Optional[RetryPolicy] = None,
              headers: Optional[dict] = None) -> dict:
    """HEAD (GET-fallback) returning {size, final_url}. Servers without HEAD
    support get a 1-byte ranged GET probe."""
    policy = policy or RetryPolicy()
    hdrs = dict(headers or {})

    def attempt():
        import time as _time

        t0 = _time.perf_counter()
        try:
            with _request(url, hdrs, method="HEAD") as resp:
                size = resp.headers.get("Content-Length")
                out = {"size": int(size) if size is not None else None,
                       "final_url": resp.geturl()}
        except _HttpStatusError as e:
            if e.status not in (405, 501):  # no HEAD support -> range probe
                raise
            with _request(url, {**hdrs, "Range": "bytes=0-0"}) as resp:
                rng = resp.headers.get("Content-Range", "")
                size = rng.rsplit("/", 1)[-1] if "/" in rng else None
                out = {"size": int(size) if size and size != "*" else None,
                       "final_url": resp.geturl()}
        IO_STATS.count_get(0, _time.perf_counter() - t0,
                           endpoint=endpoint_of(url), verb="HEAD")
        return out

    from daft_tpu_torch.io.circuit import breaker_for_url, endpoint_of

    return with_retries(attempt, policy, describe=f"HEAD {url}",
                        is_retryable=lambda e: _is_retryable(e, policy),
                        on_retry=lambda: IO_STATS.count_retry(
                            endpoint=endpoint_of(url)),
                        breaker=breaker_for_url(url))


def http_get(url: str, start: Optional[int] = None,
             length: Optional[int] = None,
             policy: Optional[RetryPolicy] = None,
             headers: Optional[dict] = None) -> bytes:
    """GET, optionally ranged (reference: range.rs single range)."""
    policy = policy or RetryPolicy()
    hdrs = dict(headers or {})
    if start is not None:
        end = "" if length is None else str(start + length - 1)
        hdrs["Range"] = f"bytes={start}-{end}"

    def attempt() -> bytes:
        import time as _time

        t0 = _time.perf_counter()
        with _request(url, hdrs) as resp:
            data = resp.read()
            # A server that ignores Range returns 200 with the full body:
            # slice locally so callers still get exactly the range.
            if start is not None and getattr(resp, "status", 206) == 200:
                data = data[start:start + length] if length is not None else data[start:]
        IO_STATS.count_get(len(data), _time.perf_counter() - t0,
                           endpoint=endpoint_of(url))
        return data

    from daft_tpu_torch.io.circuit import breaker_for_url, endpoint_of

    return with_retries(attempt, policy, describe=f"GET {url}",
                        is_retryable=lambda e: _is_retryable(e, policy),
                        on_retry=lambda: IO_STATS.count_retry(
                            endpoint=endpoint_of(url)),
                        breaker=breaker_for_url(url))


class HttpReadableFile(io.RawIOBase):
    """Seekable read-only file over HTTP Range requests."""

    def __init__(self, url: str, size: Optional[int] = None,
                 policy: Optional[RetryPolicy] = None,
                 headers: Optional[dict] = None):
        self.url = url
        self.policy = policy or RetryPolicy()
        self.headers = dict(headers or {})
        self._pos = 0
        self._size = size if size is not None else http_head(
            url, self.policy, self.headers)["size"]
        if self._size is None:
            # No Content-Length: fetch eagerly; keeps seekability.
            self._buf = http_get(url, policy=self.policy, headers=self.headers)
            self._size = len(self._buf)
        else:
            self._buf = None
        IO_STATS.count_open()

    def readable(self) -> bool:
        return True

    def seekable(self) -> bool:
        return True

    def size(self) -> int:
        return self._size

    def seek(self, offset: int, whence: int = 0) -> int:
        if whence == 0:
            self._pos = offset
        elif whence == 1:
            self._pos += offset
        elif whence == 2:
            self._pos = self._size + offset
        return self._pos

    def tell(self) -> int:
        return self._pos

    def read(self, n: int = -1) -> bytes:
        if n is None or n < 0:
            n = self._size - self._pos
        n = max(0, min(n, self._size - self._pos))
        if n == 0:
            return b""
        if self._buf is not None:
            out = self._buf[self._pos:self._pos + n]
        else:
            out = http_get(self.url, self._pos, n, self.policy, self.headers)
        self._pos += len(out)
        return out

    def readinto(self, b) -> int:
        data = self.read(len(b))
        b[:len(data)] = data
        return len(data)


class HttpFileSystemHandler(pafs.FileSystemHandler):
    """pyarrow PyFileSystem over HTTP objects; paths are full URLs with the
    scheme stripped by resolve_filesystem (restored here)."""

    def __init__(self, scheme: str = "https",
                 policy: Optional[RetryPolicy] = None,
                 headers: Optional[dict] = None):
        self.scheme = scheme
        self.policy = policy or RetryPolicy()
        self.headers = dict(headers or {})

    def _url(self, path: str) -> str:
        return path if "://" in path else f"{self.scheme}://{path}"

    def get_type_name(self) -> str:
        return f"daft-{self.scheme}"

    def get_file_info(self, paths):
        out = []
        for p in paths:
            try:
                meta = http_head(self._url(p), self.policy, self.headers)
                out.append(pafs.FileInfo(p, pafs.FileType.File,
                                         size=meta["size"] or -1))
            except _HttpStatusError as e:
                # Only genuine absence maps to NotFound; auth/server errors
                # must surface (a 403 on a private dataset is not "no file").
                if e.status in (404, 410):
                    out.append(pafs.FileInfo(p, pafs.FileType.NotFound))
                else:
                    raise
        return out

    def get_file_info_selector(self, selector):
        raise NotImplementedError("HTTP sources cannot be listed")

    def open_input_file(self, path):
        import pyarrow as pa

        return pa.PythonFile(
            HttpReadableFile(self._url(path), policy=self.policy,
                             headers=self.headers), mode="r")

    def open_input_stream(self, path):
        return self.open_input_file(path)

    # Writes/mutations are unsupported on HTTP sources.
    def open_output_stream(self, path, metadata=None):
        raise NotImplementedError("HTTP sources are read-only")

    def open_append_stream(self, path, metadata=None):
        raise NotImplementedError("HTTP sources are read-only")

    def create_dir(self, path, recursive):
        raise NotImplementedError("HTTP sources are read-only")

    def delete_dir(self, path):
        raise NotImplementedError("HTTP sources are read-only")

    def delete_dir_contents(self, path, missing_dir_ok=False):
        raise NotImplementedError("HTTP sources are read-only")

    def delete_root_dir_contents(self):
        raise NotImplementedError("HTTP sources are read-only")

    def delete_file(self, path):
        raise NotImplementedError("HTTP sources are read-only")

    def move(self, src, dest):
        raise NotImplementedError("HTTP sources are read-only")

    def copy_file(self, src, dest):
        raise NotImplementedError("HTTP sources are read-only")

    def normalize_path(self, path):
        return path

    def __eq__(self, other):
        return (isinstance(other, HttpFileSystemHandler)
                and other.scheme == self.scheme)

    def __ne__(self, other):
        return not self.__eq__(other)


# HuggingFace base override (tests point this at a local server).
HF_RESOLVE_BASE = "https://huggingface.co"


def hf_auth_headers(io_config=None) -> dict:
    """Authorization header from IOConfig.hf.token (or the context config)."""
    if io_config is None:
        from daft_tpu_torch.context import get_context

        io_config = get_context().planning_config.default_io_config
    tok = getattr(getattr(io_config, "hf", None), "token", None)
    return {"Authorization": f"Bearer {tok}"} if tok else {}


def expand_hf_dataset(path: str, io_config=None) -> Optional[list]:
    """Repo-level hf:// path -> list of parquet URLs via the dataset-viewer
    parquet API (reference: the hf source's listing in
    src/daft-io/src/huggingface/ and daft/io/huggingface/__init__.py's
    read_parquet("hf://datasets/{repo}") fast path).

    Returns None when the path already names a file (has a component after
    org/repo), so the caller falls through to single-object resolution.
    """
    import json as _json

    rest = path.split("://", 1)[1]
    parts = [p for p in rest.split("/") if p]
    if parts and parts[0] == "datasets":
        parts = parts[1:]
    if len(parts) != 2:
        return None  # file-level path (or invalid; resolve_hf_url reports)
    org, repo = parts
    url = f"{HF_RESOLVE_BASE.rstrip('/')}/api/datasets/{org}/{repo}/parquet"
    body = http_get(url, headers=hf_auth_headers(io_config))
    listing = _json.loads(body.decode())
    urls = []
    for config in sorted(listing):
        splits = listing[config]
        for split in sorted(splits):
            urls.extend(splits[split])
    if not urls:
        raise DaftIOError(f"HuggingFace dataset {org}/{repo} exposes no "
                          f"parquet files")
    return urls


def resolve_hf_url(path: str) -> str:
    """Map hf:// URIs to huggingface resolve URLs (reference:
    src/daft-io/src/huggingface/).

    hf://datasets/{org}/{repo}/{file}   -> {base}/datasets/{org}/{repo}/resolve/main/{file}
    hf://datasets/{org}/{repo}@rev/{f}  -> .../resolve/{rev}/{f}
    hf://{org}/{repo}/{file}            -> {base}/{org}/{repo}/resolve/main/{file}
    """
    rest = path.split("://", 1)[1] if "://" in path else path
    parts = rest.split("/")
    if parts and parts[0] in ("datasets", "spaces", "models"):
        kind_prefix = [parts[0]]
        parts = parts[1:]
    else:
        kind_prefix = []
    if len(parts) < 3:
        raise DaftIOError(
            f"hf:// path must be hf://[datasets/]org/repo/file, got {path!r}")
    org, repo, file_parts = parts[0], parts[1], parts[2:]
    rev = "main"
    if "@" in repo:
        repo, rev = repo.split("@", 1)
    pieces = kind_prefix + [org, repo, "resolve", rev] + file_parts
    return f"{HF_RESOLVE_BASE.rstrip('/')}/" + "/".join(pieces)
