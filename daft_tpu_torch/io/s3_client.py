"""Native S3-compatible client: sigv4-signed ranged reads, listing, writes
(port of ``daft_tpu/io/s3_client.py``).

Reference: src/daft-io/src/{s3_like.rs,object_io.rs:287-330} — the
reference's first-party S3 client (credential chain, per-request signing,
ranged gets, multipart-free puts) rather than an SDK. Here the transport is
the stdlib HTTP stack under the shared retry policy (io/retry.py), the
signer is io/sigv4.py, and the surface is both a direct client and a
pyarrow ``FileSystemHandler`` so scans/writers ride it transparently
(``S3Config.use_native_client=True`` or DAFT_NATIVE_S3=1).
"""

from __future__ import annotations

import io
import urllib.error
import urllib.parse
import urllib.request
import xml.etree.ElementTree as ET
from typing import Iterator, List, Optional, Tuple

import pyarrow.fs as pafs

from daft_tpu_torch.errors import DaftIOError, DaftTransientError
from daft_tpu_torch.io.retry import RetryPolicy, with_retries
from daft_tpu_torch.io.sigv4 import resolve_credentials, sign_request


class S3Object:
    __slots__ = ("key", "size", "is_prefix")

    def __init__(self, key: str, size: int, is_prefix: bool = False):
        self.key = key
        self.size = size
        self.is_prefix = is_prefix


class S3Client:
    """Signed requests against an S3-compatible endpoint (path-style)."""

    def __init__(self, s3_config=None, endpoint_url: Optional[str] = None,
                 region: Optional[str] = None,
                 policy: Optional[RetryPolicy] = None):
        cfg = s3_config
        self.cfg = cfg
        self.endpoint = (endpoint_url
                         or getattr(cfg, "endpoint_url", None)
                         or "https://s3.amazonaws.com").rstrip("/")
        self.region = region or getattr(cfg, "region_name", None) or "us-east-1"
        self.creds = resolve_credentials(cfg)
        tries = getattr(cfg, "num_tries", 3) if cfg is not None else 3
        # num_tries is TOTAL attempts (policy_from_config convention):
        # max_retries = num_tries - 1.
        self.policy = policy or RetryPolicy(max_retries=max(tries - 1, 0))
        # Shared per-endpoint breaker: repeated transient failures against
        # this host fail fast instead of re-hitting it (io/circuit.py).
        from daft_tpu_torch.io.circuit import breaker_for

        self.breaker = breaker_for(self.endpoint)

    # ------------------------------------------------------------------ #
    def _request(self, method: str, bucket: str, key: str = "",
                 query: Optional[dict] = None, payload: bytes = b"",
                 headers: Optional[dict] = None) -> Tuple[int, bytes, dict]:
        path = f"/{bucket}" + (f"/{key}" if key else "")
        url = self.endpoint + urllib.parse.quote(path, safe="/-._~")
        hdrs = dict(headers or {})
        if self.creds is not None:
            hdrs = sign_request(method, url, region=self.region, service="s3",
                                credentials=self.creds, headers=hdrs,
                                query=query or {}, payload=payload)
        # %20 (never '+') so the sent query matches the sigv4 canonical
        # encoding — strict S3-compatible endpoints reject '+' for values
        # with spaces with SignatureDoesNotMatch.
        full = url + (f"?{urllib.parse.urlencode(query, quote_via=urllib.parse.quote)}"
                      if query else "")

        # Zero-byte uploads must still send a body (Content-Length: 0) —
        # `payload or None` would elide it and real endpoints answer 411.
        body_arg = payload if (payload or method == "PUT") else None

        def attempt():
            import time as _time

            from daft_tpu_torch.io.iostats import IO_STATS

            req = urllib.request.Request(full, data=body_arg,
                                         headers=hdrs, method=method)
            t0 = _time.perf_counter()
            try:
                with urllib.request.urlopen(req, timeout=60) as resp:
                    body = resp.read()
                    dt = _time.perf_counter() - t0
                    if method in ("PUT", "POST"):
                        IO_STATS.count_put(len(payload), dt,
                                           endpoint=self.endpoint,
                                           verb=method)
                    else:  # GET/HEAD/DELETE each get their own verb series
                        IO_STATS.count_get(len(body), dt,
                                           endpoint=self.endpoint,
                                           verb=method)
                    return resp.status, body, dict(resp.headers)
            except urllib.error.HTTPError as e:
                body = e.read()
                if e.code in self.policy.retryable_statuses:
                    err = DaftTransientError(
                        f"S3 {method} {full}: HTTP {e.code}")
                    err.retry_after = e.headers.get("Retry-After")
                    err.status = e.code
                    raise err from e
                err = DaftIOError(
                    f"S3 {method} {full}: HTTP {e.code}: "
                    f"{body[:300]!r}")
                err.status = e.code
                raise err from e
            except (urllib.error.URLError, TimeoutError, ConnectionError, OSError) as e:
                raise DaftTransientError(f"S3 {method} {full}: {e}") from e

        from daft_tpu_torch.io.iostats import IO_STATS

        return with_retries(
            attempt, self.policy, describe=f"S3 {method} {bucket}/{key}",
            is_retryable=lambda e: isinstance(e, DaftTransientError),
            on_retry=lambda: IO_STATS.count_retry(endpoint=self.endpoint),
            breaker=self.breaker)

    # ------------------------------------------------------------------ #
    def get_object(self, bucket: str, key: str, start: Optional[int] = None,
                   length: Optional[int] = None) -> bytes:
        """Whole-object or ranged GET (reference: object_io.rs:287-330).
        A zero-length request short-circuits to b'' — ``bytes=N-(N-1)`` is
        an invalid Range (HTTP 416)."""
        if length is not None and length <= 0:
            return b""
        headers = {}
        if start is not None:
            end = "" if length is None else str(start + length - 1)
            headers["Range"] = f"bytes={start}-{end}"
        _, body, _ = self._request("GET", bucket, key, headers=headers)
        return body

    def head_object(self, bucket: str, key: str) -> int:
        _, _, headers = self._request("HEAD", bucket, key)
        return int(headers.get("Content-Length", 0))

    def put_object(self, bucket: str, key: str, data: bytes) -> None:
        self._request("PUT", bucket, key, payload=data)

    def delete_object(self, bucket: str, key: str) -> None:
        self._request("DELETE", bucket, key)

    def list_objects(self, bucket: str, prefix: str = "",
                     delimiter: str = "",
                     page_size: Optional[int] = None) -> Iterator[S3Object]:
        """ListObjectsV2 with continuation (reference: s3_like.rs listing)."""
        token: Optional[str] = None
        while True:
            query = {"list-type": "2", "prefix": prefix}
            if delimiter:
                query["delimiter"] = delimiter
            if page_size:
                query["max-keys"] = str(page_size)
            if token:
                query["continuation-token"] = token
            _, body, _ = self._request("GET", bucket, query=query)
            root = ET.fromstring(body)
            ns = ""
            if root.tag.startswith("{"):
                ns = root.tag[: root.tag.index("}") + 1]
            for cp in root.findall(f"{ns}CommonPrefixes"):
                pfx = cp.find(f"{ns}Prefix")
                if pfx is not None and pfx.text:
                    yield S3Object(pfx.text, 0, is_prefix=True)
            for item in root.findall(f"{ns}Contents"):
                key = item.find(f"{ns}Key").text or ""
                size = int(item.find(f"{ns}Size").text or 0)
                yield S3Object(key, size)
            if (root.find(f"{ns}IsTruncated") is not None
                    and (root.find(f"{ns}IsTruncated").text or "") == "true"):
                token = root.find(f"{ns}NextContinuationToken").text
            else:
                return


class _S3ReadableFile(io.RawIOBase):
    """Seekable ranged-read file over the native client."""

    def __init__(self, client: S3Client, bucket: str, key: str):
        self._c = client
        self._bucket = bucket
        self._key = key
        self._size = client.head_object(bucket, key)
        self._pos = 0

    def readable(self):
        return True

    def seekable(self):
        return True

    def size(self) -> int:
        return self._size

    def seek(self, offset: int, whence: int = 0) -> int:
        if whence == 0:
            self._pos = offset
        elif whence == 1:
            self._pos += offset
        else:
            self._pos = self._size + offset
        return self._pos

    def tell(self) -> int:
        return self._pos

    def read(self, n: int = -1) -> bytes:
        if self._pos >= self._size:
            return b""
        length = self._size - self._pos if n is None or n < 0 else \
            min(n, self._size - self._pos)
        data = self._c.get_object(self._bucket, self._key, self._pos, length)
        self._pos += len(data)
        return data

    def readinto(self, b) -> int:
        data = self.read(len(b))
        b[: len(data)] = data
        return len(data)


class S3FileSystemHandler(pafs.FileSystemHandler):
    """pyarrow seam: scans/readers open s3:// paths through the native
    client when S3Config.use_native_client is set."""

    def __init__(self, client: S3Client):
        self.client = client

    @staticmethod
    def _split(path: str) -> Tuple[str, str]:
        path = path.lstrip("/")
        bucket, _, key = path.partition("/")
        return bucket, key

    def get_type_name(self):
        return "daft-s3"

    def _classify_prefix(self, p: str, bucket: str, key: str) -> pafs.FileInfo:
        for _ in self.client.list_objects(
                bucket, prefix=key.rstrip("/") + "/" if key else "",
                page_size=1):
            return pafs.FileInfo(p, pafs.FileType.Directory)
        return pafs.FileInfo(p, pafs.FileType.NotFound)

    def get_file_info(self, paths):
        out = []
        for p in paths if isinstance(paths, list) else [paths]:
            bucket, key = self._split(p)
            if not key:
                # Bucket root is never an object.
                out.append(self._classify_prefix(p, bucket, key))
                continue
            try:
                size = self.client.head_object(bucket, key)
                out.append(pafs.FileInfo(p, pafs.FileType.File, size=size))
            except DaftIOError as e:
                if getattr(e, "status", None) not in (None, 404):
                    raise  # 403 etc. must surface, not read as NotFound
                out.append(self._classify_prefix(p, bucket, key))
        return out if isinstance(paths, list) else out[0]

    def get_file_info_selector(self, selector):
        """Honors ``selector.recursive`` (delimiter '/' + Directory entries
        from CommonPrefixes) and ``selector.allow_not_found``."""
        bucket, key = self._split(selector.base_dir)
        prefix = key.rstrip("/") + "/" if key else ""
        delimiter = "" if selector.recursive else "/"
        out = []
        listed_any = False
        for obj in self.client.list_objects(bucket, prefix=prefix,
                                            delimiter=delimiter):
            listed_any = True
            if obj.is_prefix:
                out.append(pafs.FileInfo(f"{bucket}/{obj.key.rstrip('/')}",
                                         pafs.FileType.Directory))
            elif not obj.key.endswith("/"):  # skip zero-byte dir markers
                out.append(pafs.FileInfo(f"{bucket}/{obj.key}",
                                         pafs.FileType.File, size=obj.size))
        if not listed_any and prefix:
            # Object stores have implicit directories: a fully empty
            # listing (not even a marker) means the base_dir does not
            # exist. A marker-only listing is an existing empty dir -> [],
            # and the bucket root always "exists" (a nonexistent bucket
            # fails the list call itself).
            if getattr(selector, "allow_not_found", False):
                return []
            raise FileNotFoundError(selector.base_dir)
        return out

    def open_input_file(self, path):
        import pyarrow as pa

        bucket, key = self._split(path)
        return pa.PythonFile(_S3ReadableFile(self.client, bucket, key), mode="r")

    def open_input_stream(self, path):
        return self.open_input_file(path)

    def open_output_stream(self, path, metadata=None):
        import pyarrow as pa

        bucket, key = self._split(path)
        client = self.client

        class _Out(io.BytesIO):
            # Upload exactly once, and NEVER from a close() running during
            # exception unwind (a failed serializer GC-closing its stream
            # must not publish a truncated object as a live key). The abort
            # RAISES rather than silently skipping, so a deliberate write
            # inside an unrelated `except` block surfaces as an error
            # instead of undetectable data loss; a GC-driven close during
            # unwind has the raise swallowed by __del__, which is fine —
            # the original error is already propagating.
            _uploaded = False

            def close(self):
                import sys

                if self._uploaded or self.closed:
                    return
                if sys.exc_info()[0] is not None:
                    super().close()
                    raise DaftIOError(
                        f"aborted s3 upload of {bucket}/{key}: stream closed "
                        f"during exception unwind; object not written")
                self._uploaded = True
                client.put_object(bucket, key, self.getvalue())
                super().close()

        return pa.PythonFile(_Out(), mode="w")

    def open_append_stream(self, path, metadata=None):
        raise NotImplementedError("S3 objects are immutable; no append")

    def create_dir(self, path, recursive):
        pass  # prefixes are implicit

    def delete_dir(self, path):
        bucket, key = self._split(path)
        for obj in list(self.client.list_objects(bucket, prefix=key.rstrip("/") + "/")):
            self.client.delete_object(bucket, obj.key)

    def delete_dir_contents(self, path, missing_dir_ok=False):
        self.delete_dir(path)

    def delete_root_dir_contents(self):
        raise NotImplementedError

    def delete_file(self, path):
        bucket, key = self._split(path)
        self.client.delete_object(bucket, key)

    def move(self, src, dest):
        sb, sk = self._split(src)
        db, dk = self._split(dest)
        self.client.put_object(db, dk, self.client.get_object(sb, sk))
        self.client.delete_object(sb, sk)

    def copy_file(self, src, dest):
        sb, sk = self._split(src)
        db, dk = self._split(dest)
        self.client.put_object(db, dk, self.client.get_object(sb, sk))

    def normalize_path(self, path):
        return path

    def __eq__(self, other):
        # Config identity matters: same endpoint under different
        # credentials is NOT the same filesystem (pyarrow merges datasets
        # across handlers that compare equal).
        return isinstance(other, S3FileSystemHandler) and \
            other.client.endpoint == self.client.endpoint and \
            other.client.cfg == self.client.cfg

    def __ne__(self, other):
        return not self.__eq__(other)
